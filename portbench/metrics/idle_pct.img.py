"""idle_pct.img: share of the traced window with nothing running on the
device, %."""


def read(ctx):
    cap = ctx.get("capture")
    if cap is None or not cap.kernels:
        return None
    return 100.0 * (1.0 - cap.busy_s / cap.window_s)
