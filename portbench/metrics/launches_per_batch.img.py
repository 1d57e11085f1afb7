"""launches_per_batch.img: device kernels a batch launches (copies and
sets left out), over the forwards that began in the traced window."""


def read(ctx):
    cap, batches = ctx.get("capture"), ctx.get("batches")
    if cap is None or not cap.kernels or not batches:
        return None
    return cap.count() / batches
