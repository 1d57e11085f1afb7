"""Device-mesh parallelism on torch.distributed: the counterpart of
simpleinfer_tpu/parallel/.

The JAX package expresses parallelism as a `jax.sharding.Mesh` with
`data`, `spatial` and `model` axes, `NamedSharding` annotations on
activations and weights, and XLA GSPMD inserting the collectives. The
port runs one torch.distributed rank per device (SPMD, as under
torchrun): `mesh` holds the same axes and sharding rules as a torch
DeviceMesh plus the collectives the engine's walk calls (executor.
ShardedWalk), `tp` the hand-scheduled tensor-parallel matmuls and
convs, `multihost` the process wiring, and `multiproc` runs it all as
real OS processes on one machine.
"""
from .mesh import (
    build_mesh,
    input_sharding,
    make_multihost_mesh,
    replicated,
    weight_shardings,
)

__all__ = [
    "build_mesh",
    "input_sharding",
    "make_multihost_mesh",
    "replicated",
    "weight_shardings",
]
