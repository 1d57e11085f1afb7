"""wave_ms.ttft: window ms over the admission waves in it (the
service's decode `steps`, one a wave when every request asks for one
token)."""


def read(ctx):
    if not ctx.get("waves"):
        return None
    return ctx["window_ms"] / ctx["waves"]
