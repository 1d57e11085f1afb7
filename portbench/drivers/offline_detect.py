"""Offline detection: batches of seeded uint8 frames through the port's
Engine and its device decode, back to back, for a fixed window.

Traffic parameters: `batch` (frames a batch), `pool_batches` (distinct
batches of frames made at set-up and cycled), `warmup_batches`,
`conf_thresh` / `iou_thresh` / `max_det` (the decode's), `check_batches`
(batches of the window compared with the reference, drawn from the
seed among its first `check_within`, and the window's last batch).

A batch: `Engine.input` of a pinned uint8 NHWC batch (copied without the
host waiting, scaled on the card), `Engine.forward`, `decode_device` of
the head's rows, and the rows' copy into pinned host memory behind an
event, which the host waits for after it has queued the next batch.
The window opens before the first batch is staged and closes when the
last batch's rows are on the host; its images are those of every batch
whose rows arrived in it.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import harness, models, trace, weights, yardstick


def _build(run):
    from simpleinfer_tpu_torch import Engine, EngineConfig, zoo

    cfg, tr = run.config, run.traffic
    graph, in_name, out_name = zoo.build_yolov5(
        (cfg["depth_multiple"], cfg["width_multiple"]), batch=tr["batch"],
        image_size=cfg["image_size"], num_classes=cfg["nc"])
    made = weights.fill_graph(graph, run.seed, run.device)
    eng = Engine(EngineConfig(compute_dtype=cfg["compute_dtype"],
                              quant=cfg["quant"], device=run.device))
    eng.load_model(None, graph=graph)
    return eng, in_name, out_name, made


def _frames(run):
    """pool_batches x batch seeded uint8 frames [B, H, W, 3], in pinned
    host memory on a card."""
    tr, size = run.traffic, run.config["image_size"]
    gen = torch.Generator(device=run.device)
    gen.manual_seed(int(run.seed) + 1)
    n = tr["pool_batches"] * tr["batch"]
    dev = torch.randint(0, 256, (n, size, size, 3), generator=gen,
                        device=run.device, dtype=torch.uint8)
    host = torch.empty(dev.shape, dtype=torch.uint8,
                       pin_memory=run.device.startswith("cuda"))
    host.copy_(dev)
    return host.reshape(tr["pool_batches"], tr["batch"], size, size, 3)


class _Loop:
    def __init__(self, run, eng, in_name, out_name, frames):
        from simpleinfer_tpu_torch.serving.batcher import fetch_async
        from simpleinfer_tpu_torch.zoo.detect import decode_device

        self.run, self.eng, self.frames = run, eng, frames
        self.in_name, self.out_name = in_name, out_name
        self.decode, self.fetch = decode_device, fetch_async
        self.enqueue_s: list = []      # host seconds of each forward call

    def batch(self, i: int):
        """Queue batch i; returns (head, host rows, event)."""
        tr, on = self.run.traffic, self.run.trace
        with trace.span("input", on):
            self.eng.input(self.in_name,
                           self.frames[i % self.frames.shape[0]])
        with trace.span("forward", on):
            t = time.perf_counter()
            self.eng.forward()
            self.enqueue_s.append(time.perf_counter() - t)
        with trace.span("decode", on):
            head = self.eng.extract(self.out_name, as_numpy=False)
            rows = self.decode(head, conf_thresh=tr["conf_thresh"],
                               iou_thresh=tr["iou_thresh"],
                               max_det=tr["max_det"])
        with trace.span("fetch", on):
            host, done = self.fetch(rows)
        return head, host, done

    def wait(self, done) -> float:
        with trace.span("fetch", self.run.trace):
            if done is not None:
                done.synchronize()
        return time.perf_counter()

    def window(self, seconds: float, keep: set):
        """Batches back to back for `seconds`; returns (t0, completion
        times, {batch: (head, rows)} for `keep` and the last batch)."""
        kept, done_at, pending = {}, [], None
        self.enqueue_s = []
        t0 = time.perf_counter()
        i = 0
        with trace.span("window", self.run.trace):
            while time.perf_counter() - t0 < seconds:
                head, host, done = self.batch(i)
                if pending is not None:
                    done_at.append(self.wait(pending[2]))
                if i in keep:
                    kept[i] = (head, host)
                pending = (i, host, done, head)
                i += 1
            done_at.append(self.wait(pending[2]))
            kept[pending[0]] = (pending[3], pending[1])
        return t0, done_at, kept


def run(run):
    tr, cfg = run.traffic, run.config
    eng, in_name, out_name, made = _build(run)
    harness.log(run, "engine loaded")
    frames = _frames(run)
    loop = _Loop(run, eng, in_name, out_name, frames)
    rng = np.random.default_rng(run.seed)
    keep = set(int(k) for k in rng.choice(
        tr["check_within"], size=tr["check_batches"], replace=False))
    # warm-up: the cell's one batch size, holding as many heads as the
    # window keeps, so that the allocator has its blocks before it opens
    held = [loop.batch(i) for i in range(tr["warmup_batches"]
                                         + len(keep))]
    for _, _, done in held:
        loop.wait(done)
    del held
    run.window_opens()
    harness.log(run, "window opens")
    cap = None
    for _ in range(trace.CAPTURES if run.trace else 1):
        with trace.profiled(run.trace) as prof:
            launched = trace.hand_launches()
            t0, done_at, kept = loop.window(run.seconds, keep)
            launched = trace.hand_launches() - launched
        if prof is None:
            break
        cap = trace.Capture(prof, launched)
        harness.log(run, f"capture read: {cap.recorded} of {cap.launched} "
                    f"launches of the port's kernels recorded")
        if cap.complete:
            break
    if len(done_at) <= max(keep):
        raise RuntimeError(f"the window ran {len(done_at)} batches; the "
                           f"check needs batch {max(keep)}")
    window_s = done_at[-1] - t0
    images = len(done_at) * tr["batch"]
    run.attempted, run.failed = images, 0
    run.end_to_end["img_per_s"] = images / window_s
    run.end_to_end["setup_s"] = run.setup_s
    if run.trace:
        _trace_ctx(run, cap, loop, t0, done_at)
    run.window_closed()
    harness.log(run, "window closed; the reference runs")

    # correctness: the rows against a plain decode of the program's own
    # head, and the head against the reference, for the kept batches
    del eng, loop
    if run.device.startswith("cuda"):
        torch.cuda.empty_cache()
    convs, head_w = models.yolo_weights(
        made, run.device, cfg["quant"] in ("int8w", "int8"))
    rows_gap, head_gap = 0.0, 0.0
    for i, (head, host) in sorted(kept.items()):
        plain = models.yolo_decode(head, tr["conf_thresh"], tr["iou_thresh"],
                                   tr["max_det"])
        rows_gap = max(rows_gap, float((plain - host.float().cpu())
                                       .abs().max()))
        imgs = frames[i % frames.shape[0]].to(run.device)
        ref = models.yolo_reference(convs, head_w, imgs, cfg)
        p = head.float()
        head_gap = max(head_gap, float(((p - ref).abs()
                                        / ref.abs().clamp(min=1.0)).max()))
        del ref, p
    lim = cfg["limits"]
    run.checks["head_gap"] = (head_gap, lim["head_gap"])
    run.checks["rows_gap"] = (rows_gap, lim["rows_gap"])


def _trace_ctx(run, cap, loop, t0, done_at):
    cfg, tr = run.config, run.traffic
    forwards = sum(1 for n, s, _ in cap.spans
                   if n == "forward" and cap.t0 <= s < cap.t1)
    # images whose rows reached the host inside the traced window
    win = cap.window_s
    images = sum(1 for t in done_at if t - t0 <= win) * tr["batch"]
    calls = yardstick.int8w_calls(cfg, cfg["image_size"], tr["batch"])
    run.busy_s, run.window_s = cap.busy_s, win
    run.breakdown = {"device_ops": cap.device_ops(10),
                     "idle_gaps": cap.idle_gaps(10, "forward")}
    run.ctx.update(
        capture=cap, batches=forwards, images=images,
        enqueue_ms=1e3 * float(np.mean(loop.enqueue_s)),
        flops_per_image=yardstick.yolo_flops_per_image(cfg,
                                                       cfg["image_size"]),
        int8w_calls_per_batch=len(calls),
        int8w_min_s_per_batch=yardstick.min_seconds(calls))
