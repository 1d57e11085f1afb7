"""host_enqueue_ms.img: host ms a batch spends in `Engine.forward`, the
plan walk that queues its work, from the harness span around the call
(in the traced run, so the profiler's cost on the host is in it)."""


def read(ctx):
    return ctx.get("enqueue_ms")
