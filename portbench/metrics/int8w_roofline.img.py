"""int8w_roofline.img: the int8-weight GEMM's share of its roofline, %.
The work of a batch is that of the pointwise convs it serves, from the
shapes (yardstick.int8w_calls); the batches are its launches in the
window over the calls a batch makes; the time is its kernels' device
time. Nothing where the capture lost launches or the kernel never ran."""


def read(ctx):
    cap = ctx.get("capture")
    if cap is None or not cap.complete:
        return None
    n, t = cap.count("si:matmul"), cap.seconds("si:matmul")
    if not n or t <= 0:
        return None
    batches = n / ctx["int8w_calls_per_batch"]
    return 100.0 * batches * ctx["int8w_min_s_per_batch"] / t
