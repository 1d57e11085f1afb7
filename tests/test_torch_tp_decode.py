"""Tensor-parallel decode of the port against the JAX package's (the
cases of tests/test_llama.py's TP and ring-TP tests and
test_int4w_rejects_mesh).

The port's TP engines run in 2 gloo ranks on the CPU (one spawn for
the module, tests/torch_rank_tasks.tp_decode_cases); the JAX engines
of the same MeshConfig run here on the first 2 devices of the
simulated mesh, and the single-device engines of both packages in this
process. Greedy decode is token-equal to one device in both tp_modes,
and so are the GenerationService's replies on the TP engine."""
import os

import numpy as np
import pytest

import simpleinfer_tpu.zoo as jzoo
import simpleinfer_tpu_torch.zoo as tzoo
from simpleinfer_tpu import Engine as JEngine
from simpleinfer_tpu import EngineConfig as JConfig
from simpleinfer_tpu import MeshConfig as JMesh
from simpleinfer_tpu.zoo.generate import CachedDecoder as JDecoder
from simpleinfer_tpu_torch import Engine, EngineConfig, MeshConfig
from simpleinfer_tpu_torch.parallel import multiproc
from simpleinfer_tpu_torch.zoo.generate import CachedDecoder

import torch_rank_tasks as T

TASKS = os.path.join(os.path.dirname(__file__), "torch_rank_tasks.py")
MODES = ("gspmd", "ring")


@pytest.fixture(scope="module")
def ranks():
    return multiproc.spawn(f"{TASKS}:tp_decode_cases", n_processes=T.TP,
                           devices_per_process=1, timeout_s=120,
                           device="cpu")


@pytest.fixture(scope="module")
def solo():
    """The single-device port engine and its greedy tokens (llama micro),
    and the JAX package's."""
    graph, i, o = T.tp_graph(tzoo, "micro")
    eng = Engine(EngineConfig(device="cpu")).load_model(None, graph=graph)
    tokens = CachedDecoder(eng).generate(np.asarray(T.PROMPT), steps=8,
                                         block=4)
    jgraph, _, _ = T.tp_graph(jzoo, "micro")
    jeng = JEngine(JConfig()).load_model(None, graph=jgraph)
    jtokens = JDecoder(jeng).generate(np.asarray(T.PROMPT), steps=8,
                                      block=4)
    return eng, i, o, tokens, jtokens


@pytest.mark.parametrize("mode", MODES)
def test_tp_decode_token_equal_to_one_device(ranks, solo, mode):
    _eng, _i, _o, tokens, jtokens = solo
    np.testing.assert_array_equal(tokens, jtokens)
    for r in ranks:
        np.testing.assert_array_equal(r[f"tokens_{mode}"], tokens)
    calls = ranks[0][f"calls_{mode}"]
    if mode == "ring":
        # the output projections' reduce is the ring's hops
        assert calls["batch_isend_irecv"] > 0 and calls["all_reduce"] == 0
    else:
        assert calls["all_reduce"] > 0 and calls["batch_isend_irecv"] == 0


@pytest.mark.parametrize("mode", MODES)
def test_tp_forward_matches_jax_tp_engine(ranks, solo, mode):
    """The micro forward on the TP engine: equal to the JAX TP engine of
    the same mode, the port's one device, and the other tp_mode (the
    JAX ring-vs-gspmd parity test's 2e-5 / 2e-6)."""
    eng, i, o, _tokens, _j = solo
    ids = T.forward_ids(32, [3, 7, 11, 2])
    jgraph, ji, jo = T.tp_graph(jzoo, "micro")
    jeng = JEngine(JConfig(mesh=JMesh(model=T.TP),
                           tp_mode=mode)).load_model(None, graph=jgraph)
    want = jeng.run({ji: ids})[jo]
    got = ranks[0][f"fwd_{mode}"]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, eng.run({i: ids})[o], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(ranks[0]["fwd_ring"], ranks[0]["fwd_gspmd"],
                               rtol=2e-5, atol=2e-6)
    for r in ranks:
        np.testing.assert_array_equal(r[f"fwd_{mode}"], got)


def test_gpt_ring_tp_forward_parity(ranks):
    """The nn.MultiheadAttention lineage under ring TP: the forward equals
    the gspmd TP engine's and the JAX ring TP engine's."""
    jgraph, ji, jo = T.tp_graph(jzoo, "gpt")
    jeng = JEngine(JConfig(mesh=JMesh(model=T.TP),
                           tp_mode="ring")).load_model(None, graph=jgraph)
    want = jeng.run({ji: T.forward_ids(16, [3, 7, 11, 2, 9])})[jo]
    np.testing.assert_allclose(ranks[0]["gpt_ring"], ranks[0]["gpt_gspmd"],
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(ranks[0]["gpt_ring"], want, rtol=1e-4,
                               atol=1e-5)


def test_ring_tp_indivisible_heads_falls_back(ranks):
    """3 heads on a 2-way model axis: the attention ops run whole on every
    rank (no ring, no partial reduce) and the forward and greedy tokens
    equal one device's and the JAX ring engine's."""
    graph, i, o = T.tp_graph(tzoo, "odd")
    eng = Engine(EngineConfig(device="cpu")).load_model(None, graph=graph)
    ids = T.forward_ids(16, [5, 1, 8])
    want = eng.run({i: ids})[o]
    jgraph, ji, jo = T.tp_graph(jzoo, "odd")
    jeng = JEngine(JConfig(mesh=JMesh(model=T.TP),
                           tp_mode="ring")).load_model(None, graph=jgraph)
    for r in ranks:
        np.testing.assert_allclose(r["odd"], want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r["odd"], jeng.run({ji: ids})[jo],
                                   rtol=1e-4, atol=1e-5)
        attn = {k: v for k, v in r["odd_modes"].items() if "attn" in k}
        assert attn and set(attn.values()) == {"replicated"}
    np.testing.assert_array_equal(
        ranks[0]["odd_tokens"],
        CachedDecoder(eng).generate(np.asarray(T.PROMPT), steps=6))


def test_tp_cache_holds_the_rank_heads(ranks):
    """llama micro: 4 kv heads on a 2-way axis, two a rank (the JAX
    cache's kv-head sharding on the model axis)."""
    graph, _, _ = T.tp_graph(tzoo, "micro")
    eng = Engine(EngineConfig(device="cpu")).load_model(None, graph=graph)
    full = next(iter(CachedDecoder(eng).init_cache(2).values()))[0].shape
    for r in ranks:
        assert tuple(r["cache_shape"]) == (2, full[1] // T.TP) + tuple(
            full[2:])


def test_tp_decode_rejects_data_axis_and_int4w(ranks):
    for r in ranks:
        assert "DP engine pool" in str(r["data_refused"])
    with pytest.raises(ValueError, match="int4w"):
        EngineConfig(quant="int4w", mesh=MeshConfig(model=2))


@pytest.mark.parametrize("mode", MODES)
def test_sampled_tp_decode_agrees_across_ranks(ranks, mode):
    """A sampled draw is the primary's, broadcast: every rank streams the
    same tokens."""
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"sampled_{mode}"],
                                      ranks[0][f"sampled_{mode}"])


@pytest.mark.parametrize("mode", MODES)
def test_llama_tp_generation_service(ranks, solo, mode):
    """GenerationService on the TP engine: the primary's replies equal
    the single-device decode of each prompt; the followers replay its
    plan and refuse clients."""
    eng = solo[0]
    dec = CachedDecoder(eng)
    got = ranks[0][f"served_{mode}"]
    assert len(got) == len(T.SERVE_PROMPTS)
    for p, out in zip(T.SERVE_PROMPTS, got):
        np.testing.assert_array_equal(
            out, dec.generate(np.asarray([p]), steps=6)[0])
    for r in ranks[1:]:
        assert r[f"served_{mode}"] == [] and r["follower_submit"]


@pytest.mark.parametrize("mode", MODES)
def test_llama_tp_tiered_generation_service(ranks, solo, mode):
    """TieredGenerationService on the TP engine: both tiers serve, each
    reply equals the single-device decode of its prompt; the followers
    replay every call of each tier's plan from the one stream and
    refuse clients."""
    eng = solo[0]
    dec = CachedDecoder(eng)
    got = ranks[0][f"tiered_{mode}"]
    assert len(got) == len(T.SERVE_PROMPTS)
    for p, out in zip(T.SERVE_PROMPTS, got):
        np.testing.assert_array_equal(
            out, dec.generate(np.asarray([p]), steps=6)[0])
    calls = ranks[0][f"tier_calls_{mode}"]
    assert (calls > 0).all()          # both tiers ran decoder calls
    for r in ranks[1:]:
        assert r[f"tiered_{mode}"] == [] and r["tier_follower_submit"]
        np.testing.assert_array_equal(r[f"tier_calls_{mode}"], calls)
