"""mfu.tok: the whole step's share of the card's bf16 peak, %: the
model FLOPs of the real (unpadded) prompt tokens of the requests whose
reply arrived in the traced window (yardstick.gpt2_flops) over the
window's seconds."""

from portbench import yardstick


def read(ctx):
    cap = ctx.get("capture")
    if cap is None or not cap.kernels or not ctx.get("model_flops"):
        return None
    return 100.0 * ctx["model_flops"] / cap.window_s \
        / yardstick.PEAK_BF16_FLOPS
