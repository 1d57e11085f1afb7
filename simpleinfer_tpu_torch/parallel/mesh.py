"""Mesh construction, sharding rules and the collectives of the walk.

The counterpart of simpleinfer_tpu/parallel/mesh.py. The JAX package
declares shardings and XLA GSPMD compiles the collectives into one
program over all devices. Here every device is a torch.distributed rank
running the same program on its shard (SPMD, as under torchrun), so the
rules below say which slice of a global tensor a rank holds, and the
walk (executor.py) calls the collectives itself.

Axes:
- ``data``    — shards the batch dim of activations (DP).
- ``spatial`` — shards the activation HEIGHT dim (the CNN analog of
  sequence parallelism): convs and pools exchange halo rows with their
  neighbours, for when batch alone cannot fill the mesh.
- ``model``   — shards conv / linear output channels and attention heads
  (TP), per the `shard_hints` each OpImpl declares (ops/registry.py).

A spec is a tuple of axis names or None per tensor dim (the JAX
package's PartitionSpec); () is replicated.

Under gloo a CUDA tensor goes through all_reduce, all_gather and
broadcast as it is; point-to-point send / recv take host memory only,
so `exchange` stages those hops through host tensors there.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..config import MeshConfig

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_SPATIAL = "spatial"
AXES = (AXIS_DATA, AXIS_SPATIAL, AXIS_MODEL)

LAUNCH_HINT = ("launch one rank per device with parallel.multiproc.launch "
               "or `torchrun --nproc-per-node N`, and call "
               "parallel.multihost.initialize() in each")


def build_mesh(cfg: Optional[MeshConfig]):
    """A (data, spatial, model) torch DeviceMesh over the world's ranks;
    None = single device. The world size must equal cfg.num_devices.
    The mesh's device type is "cuda" under NCCL (one card a rank) and
    "cpu" under gloo, where ranks may share one card: it sets no device
    and only names the process groups; each Engine keeps its own
    device."""
    if cfg is None or cfg.num_devices == 1:
        return None
    n = cfg.num_devices
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(
            f"mesh needs {n} devices, the torch.distributed world has "
            f"{world} rank(s): {LAUNCH_HINT}")
    from torch.distributed.device_mesh import init_device_mesh

    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, (cfg.data, cfg.spatial, cfg.model),
                            mesh_dim_names=AXES)


def make_multihost_mesh(data: int, model: int = 1, spatial: int = 1):
    """Mesh over all ranks of the world (after multihost.initialize());
    ranks are host-major, so the `model` / `spatial` axes stay within a
    host and `data` crosses hosts, the cheap direction for inference."""
    return build_mesh(MeshConfig(data=data, model=model, spatial=spatial))


def replicated(mesh=None) -> tuple:
    """The replicated spec: every rank holds the whole tensor."""
    return ()


def input_sharding(mesh, rank: int) -> tuple:
    """Activation spec: batch over `data`; for rank-4 NHWC, height over
    `spatial` too (a no-op when the axis has size 1)."""
    if rank == 4 and axis_size(mesh, AXIS_SPATIAL) > 1:
        return (AXIS_DATA, AXIS_SPATIAL, None, None)
    return (AXIS_DATA,) + (None,) * (rank - 1)


def weight_shardings(mesh, weights: dict, shard_hints: dict) -> dict:
    """Per-op weight specs from OpImpl.shard_hints.

    hints map weight key -> tuple of axis names (None = replicated dim);
    the `model` axis is honored only when the mesh has model > 1. A
    weight is replicated when its hinted dim does not divide the axis
    (a 4-class head on a 4-way model axis) or the hint's rank differs.
    Quantized weights shard their int8 payload and scales alike on the
    output-channel axis (the spec names the payload's dims)."""
    model_size = axis_size(mesh, AXIS_MODEL)
    out = {}
    for key, w in weights.items():
        hint = shard_hints.get(key)
        if hint is None or model_size <= 1:
            out[key] = replicated(mesh)
            continue
        shape = getattr(getattr(w, "data", w), "shape", None)
        ok = (shape is not None and len(hint) == len(shape)
              and all(a != AXIS_MODEL or shape[i] % model_size == 0
                      for i, a in enumerate(hint)))
        if not ok:
            out[key] = replicated(mesh)
            continue
        out[key] = tuple(a if a == AXIS_MODEL else None for a in hint)
    return out


# ---- this rank's coordinates -------------------------------------------
def axis_size(mesh, axis: str) -> int:
    if mesh is None:
        return 1
    return int(mesh.size(AXES.index(axis)))


def axis_index(mesh, axis: str) -> int:
    if mesh is None:
        return 0
    return int(mesh.get_local_rank(axis))


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


def shard_of(x, spec: tuple, mesh):
    """This rank's slice of a global tensor (or numpy array) under
    `spec`: each dim named by an axis of size p is cut into p equal
    chunks and the rank keeps the one at its coordinate. Raises when a
    dim does not divide."""
    for dim, axis in enumerate(spec):
        p = axis_size(mesh, axis) if axis else 1
        if p <= 1:
            continue
        n = x.shape[dim]
        if n % p:
            raise ValueError(
                f"dim {dim} of size {n} does not divide the {axis!r} "
                f"axis of size {p}")
        i, step = axis_index(mesh, axis), n // p
        idx = [slice(None)] * x.ndim
        idx[dim] = slice(i * step, (i + 1) * step)
        x = x[tuple(idx)]
    return x


# ---- collectives ---------------------------------------------------------
def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Concatenate every rank's `x` along `dim` over the `axis` group, in
    the axis' order (equal shapes on every rank)."""
    p = axis_size(mesh, axis)
    if p <= 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(p)]
    dist.all_gather(parts, x, group=axis_group(mesh, axis))
    return torch.cat(parts, dim=dim)


def all_reduce(x: torch.Tensor, mesh, axis: str,
               op: str = "sum") -> torch.Tensor:
    """The sum (or max) of every rank's `x` over the `axis` group; `x`
    itself is left as it was."""
    if axis_size(mesh, axis) <= 1:
        return x
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=axis_group(mesh, axis))
    return y


def exchange(mesh, axis: str, sends: list, recvs: list) -> list:
    """Point-to-point hops inside the `axis` group, posted together
    (batch_isend_irecv) and waited for. sends: [(tensor, peer)]; recvs:
    [(template tensor, peer)] with peer the rank's coordinate on the
    axis; returns the received tensors (shaped, typed and placed as
    their templates). gloo moves host memory only, so under gloo a CUDA
    hop is staged through host tensors."""
    group = axis_group(mesh, axis)
    staged = dist.get_backend(group) != "nccl"
    ops, bufs = [], []
    for t, peer in sends:
        t = t.contiguous()
        if staged and t.device.type != "cpu":
            t = t.cpu()
        ops.append(dist.P2POp(dist.isend, t,
                              dist.get_global_rank(group, peer), group))
    for like, peer in recvs:
        b = torch.empty(like.shape, dtype=like.dtype,
                        device="cpu" if staged else like.device)
        bufs.append((b, like.device))
        ops.append(dist.P2POp(dist.irecv, b,
                              dist.get_global_rank(group, peer), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [b.to(dev) for b, dev in bufs]


def broadcast_object(obj, mesh, axis: str, src_index: int = 0):
    """`obj` of the rank at coordinate `src_index` on the `axis` group,
    returned on every rank of the group (pickled host objects)."""
    group = axis_group(mesh, axis)
    box = [obj]
    dist.broadcast_object_list(
        box, src=dist.get_global_rank(group, src_index), group=group)
    return box[0]
