"""elementwise_ms.tok: device ms an admission wave of the elementwise
category, the waves counted by the service's decode steps (one a wave
when every request asks for one token)."""


def read(ctx):
    cap, waves = ctx.get("capture"), ctx.get("waves")
    if cap is None or not cap.kernels or not waves:
        return None
    return cap.seconds("elementwise") * 1e3 / waves
