"""mfu.img: the whole step's share of the card's bf16 peak, %: the
FLOPs of the images whose rows reached the host in the traced window
(every conv, the Detect head's too; yardstick.yolo_flops_per_image)
over the window's seconds."""

from portbench import yardstick


def read(ctx):
    cap = ctx.get("capture")
    if cap is None or not cap.kernels or not ctx.get("images"):
        return None
    flops = ctx["images"] * ctx["flops_per_image"]
    return 100.0 * flops / cap.window_s / yardstick.PEAK_BF16_FLOPS
