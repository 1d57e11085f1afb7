"""The port's parallel/mesh.py, multihost.py and tp.py against the JAX
package's parallel/ (the cases of tests/test_parallel.py).

The port runs in 4 gloo ranks on the CPU (2 hosts of 2, spawned once
for the module by parallel.multiproc.spawn; the ranks never import
jax); the JAX functions run in this process on the simulated mesh of
tests/conftest.py at the same mesh shapes (build_mesh takes the first
4 devices). Each rank's result is its own shard, held against the
matching shard of the JAX result at the tests' tolerance (1e-4)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from simpleinfer_tpu.config import MeshConfig as JMeshConfig
from simpleinfer_tpu.parallel import mesh as jmesh
from simpleinfer_tpu.parallel import tp as jtp
from simpleinfer_tpu_torch import MeshConfig
from simpleinfer_tpu_torch.parallel import mesh as pmesh
from simpleinfer_tpu_torch.parallel import multihost, multiproc

import torch_rank_tasks as T

TASKS = os.path.join(os.path.dirname(__file__), "torch_rank_tasks.py")
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def ranks():
    return multiproc.spawn(f"{TASKS}:parallel_cases", n_processes=2,
                           devices_per_process=2, timeout_s=120,
                           device="cpu")


def jax_mesh(**kw):
    return jmesh.build_mesh(JMeshConfig(**kw), jax.devices()[:4])


def _spec(ps) -> tuple:
    return tuple(ps)


def test_build_mesh_shapes(ranks):
    jm = jax_mesh(data=2, model=2)
    for r in ranks:
        assert tuple(r["names"]) == ("data", "spatial", "model")
        assert tuple(r["shape_22"]) == tuple(
            jm.shape[a] for a in r["names"])
        assert tuple(r["shape_sp"]) == (2, 2, 1)
        assert r["none"].all()
        assert "launch" in str(r["too_big"]) and "torchrun" in str(
            r["too_big"])
    # one process: no mesh for one device, and a mesh asks for its ranks
    assert pmesh.build_mesh(MeshConfig()) is None
    assert pmesh.build_mesh(None) is None
    with pytest.raises(ValueError, match="multiproc.launch"):
        pmesh.build_mesh(MeshConfig(data=2))


def test_input_sharding_splits_batch(ranks):
    jm = jax_mesh(data=4)
    x = np.arange(16 * 4 * 4 * 3, dtype=np.float32).reshape(16, 4, 4, 3)
    arr = jax.device_put(x, jmesh.input_sharding(jm, x.ndim))
    shards = {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}
    for rank, r in enumerate(ranks):
        assert r["input_shard"].shape == (4, 4, 4, 3)
        np.testing.assert_array_equal(r["input_shard"],
                                      shards[jm.devices.flat[rank].id])


def test_weight_shardings_honor_hints(ranks):
    weights = {"weight": np.zeros((3, 3, 8, 16), np.float32),
               "bias": np.zeros((16,), np.float32),
               "other": np.zeros((5,), np.float32)}
    hints = {"weight": (None, None, None, "model"), "bias": ("model",)}
    for kw, key in ((dict(data=2, model=2), "wsh_22"),
                    (dict(data=4), "wsh_4")):
        want = {k: _spec(v.spec) for k, v in jmesh.weight_shardings(
            jax_mesh(**kw), weights, hints).items()}
        got = eval(str(ranks[0][key]))  # noqa: S307 (a repr we wrote)
        assert got == want, (kw, got, want)


def test_multihost_helpers(ranks):
    rows = np.arange(8 * 2, dtype=np.float32).reshape(8, 2)
    for rank, r in enumerate(ranks):
        count, index, primary, init = r["mh"]
        assert count == 2 and index == rank // 2
        assert bool(primary) == (rank == 0) and init
        assert tuple(r["mh_shape"]) == (2, 1, 2)
        # rank r keeps rows of data shard r of the global batch
        np.testing.assert_array_equal(r["mh_local"], rows[2 * rank:
                                                          2 * rank + 2])
        np.testing.assert_array_equal(r["mh_gather"], rows)
        assert r["mh_bad"]
    # one process: every helper is a no-op, as the JAX package's
    assert multihost.initialize() is None
    assert multihost.process_count() == 1 and multihost.is_primary()
    assert multihost.process_index() == 0


def test_tp_linear_column_local_only(ranks):
    x, w, b = T.tp_linear_inputs()
    jm = jax_mesh(model=4)
    wd = jax.device_put(w, NamedSharding(jm, P(None, "model")))
    bd = jax.device_put(b, NamedSharding(jm, P("model")))
    want = np.asarray(jax.jit(lambda a, c, d: jtp.tp_linear_column(
        a, c, d, mesh=jm))(x, wd, bd))
    np.testing.assert_allclose(want, x @ w + b, rtol=1e-5, atol=1e-5)
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["col"], want[:, 16 * rank:
                                                  16 * (rank + 1)], **TOL)
        assert not any(r["col_calls"].values()), r["col_calls"]


def test_tp_linear_row_explicit_ring(ranks):
    x, w, b = T.tp_row_inputs()
    jm = jax_mesh(model=4)
    xd = jax.device_put(x, NamedSharding(jm, P(None, "model")))
    wd = jax.device_put(w, NamedSharding(jm, P("model", None)))
    want = np.asarray(jax.jit(lambda a, c, d: jtp.tp_linear_row(
        a, c, d, mesh=jm))(xd, wd, b))
    for r in ranks:
        np.testing.assert_allclose(r["row"], want, **TOL)
        np.testing.assert_allclose(r["row"], x @ w + b, **TOL)
        # the ring: 4 chunks x 3 hops, never an all_reduce
        assert r["row_calls"]["batch_isend_irecv"] == 12, r["row_calls"]
        assert r["row_calls"]["all_reduce"] == 0


def test_tp_mlp_megatron_pair(ranks):
    x, w1, b1, w2, b2 = T.tp_mlp_inputs()
    jm = jax_mesh(model=4)
    want = np.asarray(jtp.tp_mlp(x, *jtp.shard_tp_weights(
        jm, w1, b1, w2, b2), mesh=jm))
    for r in ranks:
        np.testing.assert_allclose(r["mlp"], want, **TOL)
        assert r["mlp_calls"]["all_reduce"] == 0
        assert r["mlp_calls"]["batch_isend_irecv"] > 0


def test_tp_conv_column_and_row_pair(ranks):
    x, w1, b1, w2, b2 = T.tp_conv_inputs()
    jm = jax_mesh(model=4)
    col = np.asarray(jtp.tp_conv_column(x, w1, b1, mesh=jm))
    h = np.asarray(jtp._conv_nhwc(x, w1) + b1, np.float32)
    hs = jax.device_put(h, NamedSharding(jm, P(None, None, None, "model")))
    row = np.asarray(jtp.tp_conv_row(hs, w2, b2, mesh=jm))
    pair = np.asarray(jax.jit(lambda a: jtp.tp_conv_pair(
        a, w1, b1, w2, b2, mesh=jm))(x))
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["conv_col"],
                                   col[..., 8 * rank:8 * (rank + 1)], **TOL)
        np.testing.assert_allclose(r["conv_row"], row, **TOL)
        np.testing.assert_allclose(r["conv_pair"], pair, **TOL)
        assert r["conv_calls"]["all_reduce"] == 0
        assert r["conv_calls"]["batch_isend_irecv"] > 0


def test_sp_conv3x3_halo_matches_same_conv(ranks):
    x, w, b = T.sp_conv_inputs()
    jm = jax_mesh(spatial=4)
    want = np.asarray(jax.jit(lambda a: jtp.sp_conv3x3_halo(
        a, w, b, mesh=jm, axis="spatial"))(x))
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["sp"], want[:, 8 * rank:8 * (rank + 1)],
                                   **TOL)
        assert r["sp_calls"]["all_reduce"] == 0
        assert r["sp_calls"]["batch_isend_irecv"] == 1


def test_tp_mlp_composes_with_data_parallel(ranks):
    x, w1, b1, w2, b2 = T.dp_mlp_inputs()
    jm = jax_mesh(data=2, model=2)
    xs = jax.device_put(x, NamedSharding(jm, P("data", None)))
    want = np.asarray(jax.jit(lambda a: jtp.tp_mlp(
        a, w1, b1, w2, b2, mesh=jm, batch_axis="data"))(xs))
    np.testing.assert_allclose(
        want, np.asarray(jax.nn.gelu(jnp.asarray(x @ w1 + b1))) @ w2 + b2,
        **TOL)
    for rank, r in enumerate(ranks):
        d = rank // 2
        np.testing.assert_allclose(r["dp_mlp"], want[4 * d:4 * (d + 1)],
                                   **TOL)
        assert r["dp_mlp_calls"]["all_reduce"] == 0
