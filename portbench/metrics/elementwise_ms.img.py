"""elementwise_ms.img: device ms a batch of the elementwise category
(norms, activations, binary ops, copies by kernel, the decode's
elementwise work), over the forwards that began in the traced window."""


def read(ctx):
    cap, batches = ctx.get("capture"), ctx.get("batches")
    if cap is None or not cap.kernels or not batches:
        return None
    return cap.seconds("elementwise") * 1e3 / batches
