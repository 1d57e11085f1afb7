"""flash_roofline.tok: causal flash attention's share of its roofline,
%: each launch in the window does one layer's attention of a wave at
the bucket width (yardstick.flash_calls_wave); the time is its
kernels' device time. Nothing where the capture lost launches or the
kernel never ran."""


def read(ctx):
    cap = ctx.get("capture")
    if cap is None or not cap.complete:
        return None
    n = cap.count("si:flash_attention")
    t = cap.seconds("si:flash_attention")
    if not n or t <= 0:
        return None
    return 100.0 * n * ctx["flash_min_s_per_call"] / t
