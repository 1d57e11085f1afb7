"""int4w_roofline.tok: the int4-weight GEMM's share of its roofline, %.
The work of a wave is that of its prefill's projections at the bucket
width and of the decode step that follows it (yardstick.int4w_calls_*);
the waves are its launches in the window over the calls a wave makes;
the time is its kernels' device time. Nothing where the capture lost
launches or the kernel never ran."""


def read(ctx):
    cap = ctx.get("capture")
    if cap is None or not cap.complete:
        return None
    n, t = cap.count("si:matmul_int4w"), cap.seconds("si:matmul_int4w")
    if not n or t <= 0:
        return None
    waves = n / ctx["int4w_calls_per_wave"]
    return 100.0 * waves * ctx["int4w_min_s_per_wave"] / t
