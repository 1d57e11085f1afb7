"""Hand-scheduled tensor-parallel matmuls and convs over a mesh axis.

The counterpart of simpleinfer_tpu/parallel/tp.py. There, shard_map
takes global arrays with their shardings; here every rank runs the
function on its OWN shards (SPMD) and gets its own shard of the result,
the collectives written out over the axis' process group:

- **column** (`tp_linear_column`, `tp_conv_column`): w sharded on its
  output dim, x whole on the axis. Pure local compute, output sharded
  on N — zero communication. The first half of a Megatron pair.
- **row** (`tp_linear_row`, `tp_conv_row`): x and w sharded on K (the
  input channels). Each rank holds a PARTIAL product; the reduction
  runs as a ring of neighbour hops (send to j + 1, receive from j - 1,
  posted together by `batch_isend_irecv`) interleaved with the local
  product's column chunks, the collective-matmul schedule: device j
  sums p_j + p_{j-1} + ... in that order, as the JAX package's ppermute
  loop does. Never one all_reduce.
- `sp_conv3x3_halo`: the height-sharded 3x3 "same" conv with an explicit
  halo exchange (the `spatial` axis' schedule written out).

`RowParallel` carries the same reduction for the engine's attention ops
(the row-parallel output projection of ops/attention.py): an all_reduce
in tp_mode "gspmd", the ring in tp_mode "ring".
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .mesh import (AXIS_MODEL, all_reduce, axis_index, axis_size,
                   exchange, shard_of)
from ..quant.tensor import QuantizedTensor, proj_nlo


def _mm(x, w):
    """f32 [..., K] x [K, N] (a dense or per-channel int8 [K, N])."""
    if isinstance(w, QuantizedTensor):
        w = w.dequantize(torch.float32)
    return torch.matmul(x.float(), w.float())


def _cols(w, a: int, b: int):
    """Columns [a, b) of a [K, N] weight; an int8 weight keeps the
    matching slice of its per-column scales."""
    if isinstance(w, QuantizedTensor):
        return QuantizedTensor(data=w.data[:, a:b], scale=w.scale[a:b],
                               axis=w.axis)
    return w[:, a:b]


def ring_hop(t: torch.Tensor, mesh, axis: str = AXIS_MODEL) -> torch.Tensor:
    """One hop of the ring: send `t` to the next rank on the axis and
    return what the previous one sent."""
    p, j = axis_size(mesh, axis), axis_index(mesh, axis)
    return exchange(mesh, axis, [(t, (j + 1) % p)], [(t, (j - 1) % p)])[0]


def ring_reduce(parts, mesh, axis: str = AXIS_MODEL):
    """Sum each chunk's partial over the axis by p - 1 ring hops (chunk
    c's hops go out before chunk c + 1 is computed: `parts` may be a
    generator of the local chunk products); returns the chunks' sums
    concatenated on the last dim."""
    p = axis_size(mesh, axis)
    outs = []
    for part in parts:
        acc = part
        for _ in range(p - 1):
            part = ring_hop(part, mesh, axis)
            acc = acc + part
        outs.append(acc)
    return torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]


def _chunks(n: int, p: int, chunks):
    nc = max(1, min(chunks or p, n))
    step = n // nc
    return [(i * step, n if i == nc - 1 else (i + 1) * step)
            for i in range(nc)]


def tp_linear_column(x, w, bias=None, *, mesh, axis: str = AXIS_MODEL,
                     batch_axis: str | None = None):
    """Column-parallel linear: w [K, N/p] is this rank's shard on N, x
    whole over `axis` (this rank's batch rows when `batch_axis` shards
    them too); returns y [..., N/p], this rank's output columns. No
    communication — the fan-out half of a Megatron pair."""
    y = _mm(x, w)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def tp_linear_row(x, w, bias=None, *, mesh, axis: str = AXIS_MODEL,
                  chunks: int | None = None,
                  batch_axis: str | None = None):
    """Row-parallel linear with an explicit ring all-reduce overlapped
    against the local matmul (collective-matmul): x [..., K/p] and w
    [K/p, N] are this rank's shards on K; returns the whole y [..., N]
    (+ bias) on every rank of the axis. The local partial is computed
    in `chunks` column chunks (default: the axis size); chunk c's ring
    hops are posted before chunk c + 1 is computed."""
    p = axis_size(mesh, axis)
    parts = (_mm(x, _cols(w, a, b))
             for a, b in _chunks(w.shape[1], p, chunks))
    y = ring_reduce(parts, mesh, axis)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


# jax.nn.gelu's default, the tanh approximation
_gelu = functools.partial(F.gelu, approximate="tanh")


def tp_mlp(x, w1, b1, w2, b2, *, mesh, axis: str = AXIS_MODEL,
           act=_gelu, batch_axis: str | None = None):
    """A whole Megatron MLP pair on this rank's shards: column-parallel
    fan-out (no comm) -> activation on the shard -> row-parallel fan-in
    (one ring round for the block)."""
    h = tp_linear_column(x, w1, b1, mesh=mesh, axis=axis,
                         batch_axis=batch_axis)
    h = act(h.float()).to(h.dtype)
    return tp_linear_row(h, w2, b2, mesh=mesh, axis=axis,
                         batch_axis=batch_axis)


def shard_tp_weights(mesh, w1, b1, w2, b2, axis: str = AXIS_MODEL):
    """This rank's shards of Megatron-pair weights for tp_mlp: w1 / b1 on
    their output columns, w2 on its rows, b2 whole."""
    return (shard_of(w1, (None, axis), mesh),
            shard_of(b1, (axis,), mesh) if b1 is not None else None,
            shard_of(w2, (axis, None), mesh),
            b2)


# ---- convs (the conv + epilogue analog of the collective matmul) --------
def _same_pads(size: int, k: int, s: int) -> tuple:
    """XLA's "SAME" padding of one dim: out = ceil(size / s)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv_nhwc(x, w, *, stride=(1, 1), padding="SAME"):
    """f32 NHWC conv of x by an HWIO w; padding "SAME" or ((top, bottom),
    (left, right))."""
    kh, kw = w.shape[0], w.shape[1]
    if padding == "SAME":
        padding = (_same_pads(x.shape[1], kh, stride[0]),
                   _same_pads(x.shape[2], kw, stride[1]))
    (t, b), (l, r) = padding
    xc = F.pad(x.float().permute(0, 3, 1, 2), (l, r, t, b))
    y = F.conv2d(xc, w.float().permute(3, 2, 0, 1), stride=tuple(stride))
    return y.permute(0, 2, 3, 1)


def tp_conv_column(x, w, bias=None, *, mesh, axis: str = AXIS_MODEL,
                   stride=(1, 1), padding="SAME"):
    """Output-channel-parallel conv: w [KH, KW, CI, CO/p] is this rank's
    shard on CO, x whole; returns this rank's NHWC output channels. No
    communication — the fan-out half of a conv pair."""
    y = _conv_nhwc(x, w, stride=stride, padding=padding)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def tp_conv_row(x, w, bias=None, *, mesh, axis: str = AXIS_MODEL,
                stride=(1, 1), padding="SAME", chunks: int | None = None):
    """Input-channel-parallel conv with the ring all-reduce overlapped
    against the local partial: x NHWC and w [KH, KW, CI/p, CO] are this
    rank's shards on C; returns the whole output on every rank. The
    local partial is computed in output-channel chunks, each chunk's
    hops posted before the next chunk's conv."""
    p = axis_size(mesh, axis)
    parts = (_conv_nhwc(x, w[..., a:b], stride=stride, padding=padding)
             for a, b in _chunks(w.shape[3], p, chunks))
    y = ring_reduce(parts, mesh, axis)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def tp_conv_pair(x, w1, b1, w2, b2, *, mesh, axis: str = AXIS_MODEL,
                 act=F.silu, stride1=(1, 1), stride2=(1, 1)):
    """Megatron-style conv pair (a C3 bottleneck's 1x1 -> 3x3) on this
    rank's shards: column-parallel fan-out (no comm) -> activation on
    the shard -> row-parallel fan-in (one ring round)."""
    h = tp_conv_column(x, w1, b1, mesh=mesh, axis=axis, stride=stride1)
    h = act(h.float()).to(h.dtype)
    return tp_conv_row(h, w2, b2, mesh=mesh, axis=axis, stride=stride2)


def sp_conv3x3_halo(x, w, bias=None, *, mesh, axis: str, act=None):
    """Height-sharded 3x3 stride-1 "same" conv with an EXPLICIT halo
    exchange: x [N, H/p, W, C] is this rank's rows (local H >= 2), w
    [3, 3, CI, CO] whole. Each rank sends its boundary rows to both
    neighbours, computes the interior output rows (which need no halo),
    then the two border rows from the halos; the edge ranks take zero
    rows, the conv's zero padding. Returns this rank's output rows."""
    p, j = axis_size(mesh, axis), axis_index(mesh, axis)
    sends, recvs = [], []
    if j + 1 < p:                   # my last row down, its first row up
        sends.append((x[:, -1:], j + 1))
        recvs.append((x[:, :1], j + 1))
    if j > 0:
        sends.append((x[:, :1], j - 1))
        recvs.append((x[:, -1:], j - 1))
    got = exchange(mesh, axis, sends, recvs)
    bot = got.pop(0) if j + 1 < p else torch.zeros_like(x[:, :1])
    top = got.pop(0) if j > 0 else torch.zeros_like(x[:, :1])
    wpad = ((0, 0), (1, 1))         # W padded, H valid
    interior = _conv_nhwc(x, w, padding=wpad)
    y = torch.cat([_conv_nhwc(torch.cat([top, x[:, :2]], 1), w,
                              padding=wpad),
                   interior,
                   _conv_nhwc(torch.cat([x[:, -2:], bot], 1), w,
                              padding=wpad)], dim=1)
    if bias is not None:
        y = y + bias.float()
    if act is not None:
        y = act(y)
    return y.to(x.dtype)


class RowParallel:
    """The row-parallel output projection of a head-sharded attention op
    (OpImpl.tp_apply's `reduce`): `project(ctx, wo, dt)` is this rank's
    partial ctx @ wo summed over the model group in f32 — one all_reduce
    ("gspmd"), or the ring of tp_linear_row ("ring") — and `sum(t)` an
    all_reduce of any other per-head sum."""

    def __init__(self, mesh, tp_mode: str, use_kernels: bool,
                 axis: str = AXIS_MODEL):
        self.mesh, self.mode, self.axis = mesh, tp_mode, axis
        self.use_kernels = use_kernels

    def project(self, ctx, wo, dt):
        def mm(x, w):
            return proj_nlo(x, w, dt, self.use_kernels)

        if self.mode == "ring":
            p = axis_size(self.mesh, self.axis)
            parts = (mm(ctx, _cols(wo, a, b))
                     for a, b in _chunks(wo.shape[1], p, None))
            return ring_reduce(parts, self.mesh, self.axis)
        return all_reduce(mm(ctx, wo), self.mesh, self.axis)

    def sum(self, t):
        return all_reduce(t, self.mesh, self.axis)
