"""The traced window: torch.profiler over it, reduced to what the
per-layer metrics read.

A capture records the card's kernels, copies and sets (CUPTI) and the
host's operations, among them the harness's own spans (record_function
around the calls into each layer). `Capture` keeps, of all that, the
device intervals inside the window, the host spans, and the busy time.

CUPTI has been seen to drop records of the port's own kernels (ctypes
libraries with their own CUDA runtime). `complete` holds the kernels
of the port that the capture recorded against the launches that their
wrappers counted in the window; the caller takes the window again when
the capture lost some.
"""
from __future__ import annotations

import contextlib
import os

from . import yardstick

#: captures a traced run takes at most, while CUPTI loses records
CAPTURES = 3

#: the harness's own host spans, by which idle gaps are named
SPANS = ("input", "forward", "decode", "fetch")


def span(name: str, on: bool):
    """A host span the capture records (a no-op outside a traced run)."""
    if not on:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profiled(on: bool):
    """torch.profiler over the block when `on` (CPU and CUDA activity);
    yields the profile or None."""
    if not on:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    # Kineto tears CUPTI down after each session unless told not to; a
    # ctypes kernel library loaded after such a teardown loses launches
    # in the next session
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()


def hand_launches() -> int:
    """Launches of the port's own kernels so far, by their wrappers'
    counters."""
    from simpleinfer_tpu_torch.kernels import (attention, c3block, conv3x3,
                                               decode_attn, matmul, stem)

    return (matmul.launches + matmul.launches_int4w + matmul.launches_s8s8
            + attention.launches + decode_attn.launches + c3block.launches
            + conv3x3.launches + stem.launches)


class Capture:
    """A profile reduced to the window [t0_ns, t1_ns] of the trace clock.

    kernels: [(name, category, start_ns, end_ns)] of the device's
    operations (kernels, copies, sets) that overlap the window, clipped
    to it; spans: [(name, start_ns, end_ns)] of the harness's spans.
    `complete` is False where the capture lost launches of the port's
    kernels (fewer recorded than `launched`, the wrappers' count); a
    reader of those kernels then reads nothing."""

    def __init__(self, prof, launched: int, window_span: str = "window"):
        events = prof.profiler.kineto_results.events()
        self.kernels, self.spans = [], []
        t0 = t1 = None
        for e in events:
            dev = str(e.device_type())
            name = e.name()
            s, d = e.start_ns(), e.duration_ns()
            if dev.endswith("CUDA"):
                if name in SPANS or name == window_span or getattr(
                        e, "is_user_annotation", lambda: False)():
                    continue      # a host span's shadow on the device
                self.kernels.append((name, yardstick.kernel_category(name),
                                     s, s + d))
            elif name == window_span:
                t0, t1 = s, s + d
            elif name in SPANS:
                self.spans.append((name, s, s + d))
        if t0 is None:
            raise RuntimeError(f"the capture holds no {window_span!r} span")
        self.t0, self.t1 = t0, t1
        # the port's kernels recorded anywhere in the capture, against the
        # launches their wrappers counted while it was open
        self.launched = launched
        self.recorded = sum(1 for k in self.kernels
                            if k[1].startswith("si:"))
        self.complete = self.recorded >= launched
        self.kernels = [(n, c, max(s, t0), min(e, t1))
                        for n, c, s, e in self.kernels if e > t0 and s < t1]
        self.kernels.sort(key=lambda k: k[2])
        self.spans.sort(key=lambda s: s[1])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self) -> list:
        """The union of the device's operations as sorted intervals."""
        out = []
        for _, _, s, e in self.kernels:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def seconds(self, category: str) -> float:
        """Device seconds of the operations of a category."""
        return sum(e - s for _, c, s, e in self.kernels
                   if c == category) / 1e9

    def count(self, category: str | None = None) -> int:
        """Operations of a category; with None, every kernel (copies and
        sets left out)."""
        return sum(1 for _, c, _, _ in self.kernels
                   if c == category or (category is None and c != "copy"))

    def device_ops(self, top: int) -> list:
        """The operations that took most device time, [name, seconds]."""
        tot: dict = {}
        for n, _, s, e in self.kernels:
            tot[n] = tot.get(n, 0.0) + (e - s) / 1e9
        return [[n, t] for n, t in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int, default: str) -> list:
        """The longest stretches with nothing on the device, [name,
        seconds], each named by the harness span the host was in when it
        began (`default` where none was open)."""
        gaps, prev = [], self.t0
        for s, e in self.busy_intervals():
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:top]:
            name = default
            for n, ss, se in self.spans:
                if ss <= s < se:
                    name = n          # the innermost one opened last
            out.append([name, (e - s) / 1e9])
        return out
