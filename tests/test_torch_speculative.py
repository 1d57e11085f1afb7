"""The port's verify chunks and speculative decoding
(simpleinfer_tpu_torch/zoo/generate.CachedDecoder.decode_chunk_verify,
zoo/speculative.SpeculativeDecoder) against the JAX package on the CPU,
on the same graphs and numpy-seeded inputs; the scenarios of
tests/test_speculative.py and tests/test_llama.py's sliding / ring ones.

decode_chunk_verify is held to the port's own stepwise path and to the
JAX decode_chunk_verify: greedy tokens equal; the occupied caches within
1e-5 x scale in f32 (int8: within one quantization step, the codes may
round the other way where the f32 k/v differ at an ulp).
SpeculativeDecoder's output equals target-only greedy decode (lossless)
and the JAX SpeculativeDecoder's. The port's engines run on the CPU
with the kernels' plain versions.
"""
import os
import sys

import jax  # noqa: F401  (both frameworks in one process, JAX on CPU)
import numpy as np
import pytest
import torch

from simpleinfer_tpu import Engine as JEngine
from simpleinfer_tpu import EngineConfig as JConfig
from simpleinfer_tpu.zoo import builders as jbuilders
from simpleinfer_tpu.zoo.generate import CachedDecoder as JDecoder
from simpleinfer_tpu.zoo.speculative import SpeculativeDecoder as JSpec
from simpleinfer_tpu_torch import Engine, EngineConfig
from simpleinfer_tpu_torch.zoo import builders as tbuilders
from simpleinfer_tpu_torch.zoo.generate import CachedDecoder
from simpleinfer_tpu_torch.zoo.speculative import SpeculativeDecoder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OP_TOL = 1e-5


def _llama_kw(seq_len=32, vocab=50, depth=2, seed=0, **kw):
    return ("build_llama", dict(variant="nano", batch=1, seq_len=seq_len,
                                vocab_size=vocab, depth=depth, seed=seed,
                                **kw))


def _gpt_kw(seq_len=32, vocab=50):
    return ("build_gpt", dict(variant="nano", batch=1, seq_len=seq_len,
                              vocab_size=vocab, depth=2, width=32,
                              num_heads=4))


_ENGINES: dict = {}


def engines(model):
    """(JAX engine, port engine with kernels on: their plain versions) of
    a (builder, kwargs) pair, cached for the module."""
    fn, kw = model
    key = (fn, tuple(sorted(kw.items())))
    if key not in _ENGINES:
        jg = getattr(jbuilders, fn)(**kw)[0]
        tg = getattr(tbuilders, fn)(**kw)[0]
        _ENGINES[key] = (
            JEngine(JConfig()).load_model(None, graph=jg),
            Engine(EngineConfig(device="cpu", use_kernels=True)).load_model(
                None, graph=tg))
    return _ENGINES[key]


def _prefilled(dec, prompt, jax_dec=None):
    n, p = prompt.shape
    window = np.zeros((n, dec._window), np.float32)
    window[:, :p] = prompt
    z, o = np.zeros(n, np.float32), np.ones(n, np.float32)
    if jax_dec is not None:
        return jax_dec.prefill_sample(window, np.full(n, p),
                                      jax.random.PRNGKey(0), 0, z,
                                      np.zeros(n, np.int32), o)[1]
    return dec.prefill_sample(window, np.full(n, p), 0, 0, z,
                              np.zeros(n, np.int64), o)[1]


def _cache_close(got, want, upto, kv_dtype):
    """Cache leaves on positions < upto: f32 within OP_TOL x scale; int8
    codes within one step, their scales within OP_TOL x scale."""
    for g, w in zip(got, want):
        g = np.asarray(g)[:, :, :upto].astype(np.float32)
        w = np.asarray(w)[:, :, :upto].astype(np.float32)
        if kv_dtype == "int8" and g.shape[-1] != 1:
            assert np.abs(g - w).max() <= 1
        else:
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(g, w, rtol=0, atol=OP_TOL * scale)


@pytest.mark.parametrize("model", ["llama", "gpt"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_decode_chunk_verify_matches_stepwise_and_jax(model, kv_dtype):
    """K tokens through the cache in one pass: each position's greedy
    token equal to the stepwise path's and to JAX's decode_chunk_verify;
    the occupied caches close to both."""
    je, pe = engines(_llama_kw() if model == "llama" else _gpt_kw())
    dec = CachedDecoder(pe, kv_dtype=kv_dtype)
    jdec = JDecoder(je, kv_dtype=kv_dtype)
    n, p = 2, 4
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, 50, size=(n, p))
    feed = rng.integers(1, 50, size=(n, 4))

    caches = _prefilled(dec, prompt)
    g, caches = dec.decode_chunk_verify(feed, np.full(n, p), caches)
    c2 = _prefilled(dec, prompt)
    want = []
    for j in range(4):
        logits, c2 = dec.step(feed[:, j:j + 1], np.full(n, p + j), c2)
        want.append(logits[:, 0].argmax(-1).numpy())
    np.testing.assert_array_equal(g.numpy(), np.stack(want, axis=1))
    jg, jc = jdec.decode_chunk_verify(feed, np.full(n, p, np.int32),
                                      _prefilled(dec, prompt, jdec))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    for name in caches:
        _cache_close(caches[name], c2[name], p + 4, kv_dtype)
        _cache_close(caches[name], jax.tree_util.tree_leaves(jc[name]),
                     p + 4, kv_dtype)


def test_decode_chunk_verify_at_the_window_edge():
    """A chunk running past the window (positions clamp onto its last
    slot) keeps the last real key: the greedy tokens inside the window
    equal the stepwise path's."""
    _, pe = engines(_llama_kw())
    dec = CachedDecoder(pe)
    prompt = np.random.default_rng(4).integers(1, 50, size=(2, 28))
    feed = np.random.default_rng(5).integers(1, 50, size=(2, 4))
    caches = _prefilled(dec, prompt)
    # positions 29 .. 32 of a 32-token window: 32 clamps onto 31
    g, caches = dec.decode_chunk_verify(feed, np.full(2, 29), caches)
    c2 = _prefilled(dec, prompt)
    for j in range(3):                       # 29, 30, 31
        logits, c2 = dec.step(feed[:, j:j + 1], np.full(2, 29 + j), c2)
        np.testing.assert_array_equal(g[:, j].numpy(),
                                      logits[:, 0].argmax(-1).numpy())
    for name in caches:
        for a, b in zip(caches[name], c2[name]):
            scale = max(1.0, float(b.abs().max()))
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=OP_TOL * scale)


def test_speculative_equals_target_greedy_same_draft():
    """Draft == target: every proposal is accepted and the output equals
    target-only greedy decode and the JAX SpeculativeDecoder's."""
    je, pe = engines(_llama_kw())
    prompt = np.asarray([[5, 1, 8], [2, 9, 3]])
    want = CachedDecoder(pe).generate(prompt, steps=10)
    spec = SpeculativeDecoder(pe, pe, k=4)
    got = spec.generate(prompt, steps=10)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, JSpec(je, je, k=4).generate(
        prompt, steps=10))
    assert spec.acceptance == 1.0
    assert spec.stats["rounds"] <= int(np.ceil(10 / (spec.k - 1))) + 1


@pytest.mark.parametrize("k", [2, 3, 4])
def test_speculative_lossless_with_weak_draft(k):
    """A draft of other weights (one layer): the output still equals
    target-only greedy decode, and the JAX decoder's with the same pair;
    the acceptance statistics equal the JAX decoder's."""
    je, pe = engines(_llama_kw(seed=0))
    jd, pd = engines(_llama_kw(depth=1, seed=7))
    prompt = np.asarray([[5, 1, 8], [2, 9, 3], [4, 4, 4]])
    want = CachedDecoder(pe).generate(prompt, steps=12)
    spec = SpeculativeDecoder(pe, pd, k=k)
    got = spec.generate(prompt, steps=12)
    np.testing.assert_array_equal(got, want)
    jspec = JSpec(je, jd, k=k)
    np.testing.assert_array_equal(got, jspec.generate(prompt, steps=12))
    assert spec.stats == jspec.stats
    assert 0.0 <= spec.acceptance <= 1.0


def test_speculative_kernel_draft():
    """The draft decodes through scratch blocks and the decode kernel (its
    plain version here) where kernel_ok allows it; the output is still
    target-only greedy, and a sliding draft attends on torch."""
    _, pe = engines(_llama_kw())
    prompt = np.asarray([[5, 1, 8], [2, 9, 3]])
    want = CachedDecoder(pe).generate(prompt, steps=10)
    spec = SpeculativeDecoder(pe, pe, k=3)
    assert spec.draft.kernel_ok and spec._draft_attn == "kernel"
    np.testing.assert_array_equal(spec.generate(prompt, steps=10), want)
    _, swa = engines(_llama_kw(sliding_window=5, seed=6))
    assert SpeculativeDecoder(swa, swa)._draft_attn == "torch"


def test_speculative_eos_stops_rows():
    _, pe = engines(_llama_kw())
    ref = CachedDecoder(pe).generate(np.asarray([[4, 8]]), steps=10)[0]
    eos = int(ref[5])
    first = 2 + int(np.argmax(ref[2:] == eos))
    out = SpeculativeDecoder(pe, pe, k=3).generate(np.asarray([[4, 8]]),
                                                   steps=10, eos_id=eos)
    np.testing.assert_array_equal(out[0, :first + 1], ref[:first + 1])
    assert out.shape[1] <= len(ref)


def test_speculative_validates():
    _, pe = engines(_llama_kw())
    with pytest.raises(ValueError, match="k must be"):
        SpeculativeDecoder(pe, pe, k=1)
    _, small = engines(_llama_kw(seq_len=16))
    with pytest.raises(ValueError, match="window"):
        SpeculativeDecoder(pe, small, k=4)
    with pytest.raises(ValueError, match="exceeds"):
        SpeculativeDecoder(pe, pe, k=4).generate(np.asarray([[1, 2]]),
                                                 steps=100)
    with pytest.raises(ValueError, match="chunk width"):
        CachedDecoder(pe).decode_chunk_verify(
            np.ones((1, 33)), np.zeros(1), CachedDecoder(pe).init_cache(1))


def test_sliding_window_chunk_and_speculative():
    """decode_chunk_verify and SpeculativeDecoder respect the band (a
    window-stored sliding op: 32 positions, band 5)."""
    je, pe = engines(_llama_kw(sliding_window=5, seed=6))
    prompt = np.asarray([[5, 1, 8]])
    want = CachedDecoder(pe).generate(prompt, steps=10)
    np.testing.assert_array_equal(
        want, JDecoder(je).generate(prompt, steps=10))
    spec = SpeculativeDecoder(pe, pe, k=3)
    np.testing.assert_array_equal(spec.generate(prompt, steps=10), want)
    assert spec.acceptance == 1.0


def test_ring_cache_speculative_lossless():
    """Window 256, band 32: the caches are 96-slot rings; speculative
    decode over 120 steps (several ring turns) equals target-only greedy
    and the JAX decoder's."""
    je, pe = engines(_llama_kw(seq_len=256, vocab=60, sliding_window=32,
                               seed=8))
    dec = CachedDecoder(pe)
    assert next(iter(dec.init_cache(1).values()))[0].shape[2] == 96
    prompt = np.asarray([[5, 1, 8]])
    want = dec.generate(prompt, steps=120)
    np.testing.assert_array_equal(want, JDecoder(je).generate(prompt,
                                                               steps=120))
    got = SpeculativeDecoder(pe, pe, k=4).generate(prompt, steps=120)
    np.testing.assert_array_equal(got, want)


def test_ring_cache_block_width_guard():
    _, pe = engines(_llama_kw(seq_len=256, vocab=60, sliding_window=32,
                              seed=8))
    dec = CachedDecoder(pe)
    caches = dec.init_cache(1)
    z, o = np.zeros(1, np.float32), np.ones(1, np.float32)
    with pytest.raises(ValueError, match="ring"):
        dec.decode_block(np.ones(1), np.zeros(1), caches, 0, 0, z,
                         np.zeros(1, np.int64), o, 128)
    with pytest.raises(ValueError, match="ring"):
        dec.decode_chunk_verify(np.ones((1, 80)), np.zeros(1), caches)


def test_chip_smoke_speculative_rehearses_on_cpu():
    """chip_smoke.py's speculative phase (both drafts, the fp32
    lossless check, bf16 agreement, the verify chunk's matmul_int4w
    calls and fuse_qkv on vs off) on the CPU at a tiny size."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    res = chip_smoke.speculative_rehearsal(torch.device("cpu"))
    assert res["fp32"]["same"]["equal"] and res["fp32"]["small"]["equal"]
    assert res["verify_int4w_calls"] > 0
