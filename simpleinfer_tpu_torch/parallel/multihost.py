"""Multi-host orchestration (BASELINE.json config 5): the counterpart of
simpleinfer_tpu/parallel/multihost.py.

PyTorch's runtime model: every device is a torch.distributed rank
running the SAME program (as under torchrun); ranks are host-major and
a host is a group of `local_world_size` consecutive ranks. For
inference the batch shards over `data` (no cross-host traffic in the
forward at all); `model` and `spatial` stay within a host.

Usage (same script on every rank):

    from simpleinfer_tpu_torch.parallel import multihost
    multihost.initialize()                      # reads torchrun's env
    mesh = multihost.make_mesh(model=1)         # data = all ranks
    eng = Engine(EngineConfig(mesh=MeshConfig(data=...)))
    ...
    eng.input(name, multihost.host_local_batch(local_rows, mesh))

The backend: NCCL when every rank of a host has a card of its own,
gloo when ranks share a card or run on the CPU (NCCL refuses two ranks
on one GPU). `initialize` returns its choice; nothing switches backend
or device after a failure.

This layer runs for real in the tests: `parallel.multiproc.launch`
executes it as separate OS processes on a localhost rendezvous.
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import (AXIS_DATA, AXIS_MODEL, AXIS_SPATIAL, axis_index,
                   axis_size, build_mesh)
from ..config import MeshConfig

logger = logging.getLogger("simpleinfer_tpu_torch")

__all__ = ["AXIS_DATA", "AXIS_MODEL", "AXIS_SPATIAL", "HostLocalBatch",
           "choose_backend", "host_local_batch", "initialize",
           "is_primary", "local_device", "local_world_size", "make_mesh",
           "process_allgather", "process_count", "process_index",
           "rank_allgather"]


def choose_backend(local_world_size: int) -> str:
    """NCCL when each of a host's ranks has a card of its own, else gloo
    (ranks sharing a card, or no card)."""
    if torch.cuda.is_available() and \
            local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> Optional[str]:
    """torch.distributed.init_process_group with torchrun's env-var
    defaults (MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK,
    LOCAL_WORLD_SIZE: the ranks of a host, the whole world when unset);
    a no-op, returning None, for a single process with no rendezvous
    configured. coordinator_address is "host:port"; num_processes is
    the world size (ranks), process_id this rank. Returns the backend
    ("nccl" or "gloo", `choose_backend` when None). Under NCCL the
    rank's card becomes the current device."""
    if dist.is_initialized():
        return dist.get_backend()
    env = os.environ
    if (coordinator_address is None and "MASTER_ADDR" not in env
            and num_processes is None):
        return None                         # single process
    world = int(num_processes if num_processes is not None
                else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None
               else env.get("RANK", 0))
    lws = int(env.get("LOCAL_WORLD_SIZE", world))
    env["LOCAL_WORLD_SIZE"] = str(lws)
    env.setdefault("LOCAL_RANK", str(rank % lws))
    if coordinator_address is None:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', 29500)}")
    backend = backend or choose_backend(lws)
    if backend == "nccl":
        torch.cuda.set_device(local_device())
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)
    logger.info("torch.distributed: rank %d of %d, backend %s", rank,
                world, backend)
    return backend


def local_world_size() -> int:
    """Ranks per host (1 without a distributed world)."""
    if not dist.is_initialized():
        return 1
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))


def local_device() -> torch.device:
    """This rank's device: card LOCAL_RANK (modulo the host's cards, so
    ranks share a card where there are fewer cards than ranks), or the
    CPU where there is no card."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    rank = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_mesh(model: int = 1, spatial: int = 1):
    """(data, spatial, model) mesh over ALL ranks; `model` and `spatial`
    stay within a host by the host-major rank order, `data` spans
    hosts."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % (model * spatial) != 0:
        raise ValueError(f"{n} devices not divisible by "
                         f"model*spatial={model * spatial}")
    return build_mesh(MeshConfig(data=n // (model * spatial),
                                 spatial=spatial, model=model))


@dataclass
class HostLocalBatch:
    """This host's rows of a global batch (its data shards, in order).
    Engine.input slices its rank's rows out of it instead of out of the
    global batch."""

    array: object
    mesh: object

    @property
    def shape(self):
        return self.array.shape

    @property
    def ndim(self):
        return len(self.array.shape)

    def rank_rows(self):
        """This rank's rows: the host's data shards are consecutive, so
        the rank's coordinate within the host picks its chunk."""
        d = axis_size(self.mesh, AXIS_DATA)
        per_host = max(1, d // process_count())
        i = axis_index(self.mesh, AXIS_DATA) % per_host
        n = self.array.shape[0]
        if n % per_host:
            raise ValueError(f"host-local batch of {n} rows does not "
                             f"divide into {per_host} data shards")
        step = n // per_host
        return self.array[i * step:(i + 1) * step]


def host_local_batch(local_batch, mesh) -> HostLocalBatch:
    """Mark this host's rows (global batch / process_count) of a batch
    sharded over `data`; Engine.input takes it in place of the global
    batch."""
    return HostLocalBatch(array=local_batch, mesh=mesh)


def process_count() -> int:
    """Hosts in the world."""
    if not dist.is_initialized():
        return 1
    return max(1, dist.get_world_size() // local_world_size())


def process_index() -> int:
    """This rank's host."""
    if not dist.is_initialized():
        return 0
    return dist.get_rank() // local_world_size()


def is_primary() -> bool:
    """True on the rank that should do logging / saving (rank 0)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def rank_allgather(array) -> np.ndarray:
    """Every rank's numpy array concatenated along axis 0 in rank order
    (all ranks call it)."""
    if not dist.is_initialized():
        return np.asarray(array)
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, np.asarray(array))
    return np.concatenate(parts, axis=0)


def process_allgather(array) -> np.ndarray:
    """Every HOST's array (the one its ranks hold alike) concatenated
    along axis 0 in host order: the JAX package's
    multihost_utils.process_allgather(tiled=True)."""
    if not dist.is_initialized():
        return np.asarray(array)
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, np.asarray(array))
    return np.concatenate(parts[::local_world_size()], axis=0)
