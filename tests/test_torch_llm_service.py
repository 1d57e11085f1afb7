"""The port's LLM serving policies (simpleinfer_tpu_torch/serving/llm.py:
GenerationService's cancel / deadlines / priorities, sample caps, the
kv_prefix ladder, adaptive_horizon and window overrides, and
TieredGenerationService; zoo/generate.CachedDecoder's kv_prefix,
sample_cap, fuse_qkv and window) against the JAX package on the CPU, on
the same graphs and numpy-seeded inputs.

The scenarios mirror tests/test_serving.py and tests/test_llama.py.
Greedy tokens equal the JAX service's / decoder's; fuse_qkv's logits
within 1e-5 x scale of the unfused decoder's (fp32: the same products,
summed per column as before). The port's engines run on the CPU with
the kernels' plain versions (use_kernels=True); the JAX decoder's
decode_attn="pallas" runs its Pallas kernel in interpret mode.
"""
import concurrent.futures as cf
import logging
import os
import sys
import time

import jax  # noqa: F401  (both frameworks in one process, JAX on CPU)
import numpy as np
import pytest
import torch

from simpleinfer_tpu import Engine as JEngine
from simpleinfer_tpu import EngineConfig as JConfig
from simpleinfer_tpu.serving.llm import GenerationService as JService
from simpleinfer_tpu.serving.llm import TieredGenerationService as JTiered
from simpleinfer_tpu.zoo import builders as jbuilders
from simpleinfer_tpu.zoo.generate import CachedDecoder as JDecoder
from simpleinfer_tpu_torch import Engine, EngineConfig
from simpleinfer_tpu_torch.serving import (GenerationService,
                                           TieredGenerationService)
from simpleinfer_tpu_torch.zoo import builders as tbuilders
from simpleinfer_tpu_torch.zoo.generate import CachedDecoder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OP_TOL = 1e-5

# tests/test_serving.py's _gpt_engine and tests/test_llama.py's
# _llama_engine (window 24, vocab 40)
MODELS = {
    "gpt": ("build_gpt", dict(variant="nano", batch=1, seq_len=24,
                              vocab_size=40, depth=2, width=32,
                              num_heads=4)),
    "llama": ("build_llama", dict(variant="nano", batch=1, seq_len=24,
                                  vocab_size=40)),
    # vocab above the sampler's default cap (64)
    "gpt100": ("build_gpt", dict(variant="nano", batch=1, seq_len=24,
                                 vocab_size=100, depth=2, width=32,
                                 num_heads=4)),
    "llama100": ("build_llama", dict(variant="nano", batch=1, seq_len=24,
                                     vocab_size=100)),
}
_ENGINES: dict = {}


def engines(name, quant=None):
    """(JAX engine, port engine with kernels on: their plain versions)
    of MODELS[name], cached for the module."""
    key = (name, quant)
    if key not in _ENGINES:
        fn, kw = MODELS[name]
        jg = getattr(jbuilders, fn)(**kw)[0]
        tg = getattr(tbuilders, fn)(**kw)[0]
        _ENGINES[key] = (
            JEngine(JConfig(quant=quant)).load_model(None, graph=jg),
            Engine(EngineConfig(device="cpu", quant=quant,
                                use_kernels=True)).load_model(None, graph=tg))
    return _ENGINES[key]


def wait_admitted(svc, n=1):
    for _ in range(500):
        if svc.stats.prefills >= n:
            return
        time.sleep(0.01)


def spy_blocks(svc):
    """Record (k_steps, kv_prefix, sample_cap, attn_impl) of every
    decode_block the service dispatches."""
    seen = []
    orig = svc._dec.decode_block

    def spy(*a, **kw):
        seen.append((int(a[8]), a[9] if len(a) > 9 else kw.get("kv_prefix"),
                     kw.get("sample_cap", "default"),
                     kw.get("attn_impl", "default")))
        return orig(*a, **kw)
    svc._dec.decode_block = spy
    return seen


# ---- the policies, token-equal to the JAX service ---------------------------
@pytest.mark.parametrize("name", ["llama100", "gpt100"])
def test_service_policies_token_equal_to_jax(name):
    """A kv-prefix ladder, sample_cap "auto", adaptive_horizon and a
    window override together, 2 slots (rows admitted mid-flight), horizon
    4: the greedy tokens equal the JAX service's with the same settings,
    the capped sampler runs every block, and sub-window rungs are
    dispatched (to the decode kernel as its max_len under "auto")."""
    je, pe = engines(name)
    kw = dict(slots=2, decode_horizon=4, kv_prefix_ladder=(8, 12),
              sample_cap="auto", adaptive_horizon=True, window=20)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 100, int(p)) for p in (3, 5, 2, 7, 4)]
    jsvc = JService(je, **kw).start()
    want = [f.result(timeout=300) for f in
            [jsvc.submit(p, max_new=8) for p in prompts]]
    jsvc.stop()
    svc = GenerationService(pe, **kw)
    seen = spy_blocks(svc)
    svc.start()
    got = [f.result(timeout=300) for f in
           [svc.submit(p, max_new=8) for p in prompts]]
    svc.stop()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert svc._window == 20 and svc._prefix_ladder == [8, 12]
    assert svc.stats.capped_steps == svc.stats.steps > 0
    assert any(p in (8, 12) for _, p, _, _ in seen), seen
    assert all(a == "kernel" for *_, a in seen), seen   # both kernel_ok


def test_window_override_token_equal():
    """A window-capped service gives the full-window service's tokens
    (and the JAX window-capped service's) for rows that fit, and rejects
    rows that could outgrow the cap."""
    je, pe = engines("gpt")
    full = GenerationService(pe, slots=2, decode_horizon=2).start()
    a = full.submit([5, 2, 7], max_new=6).result(timeout=120)
    full.stop()
    short = GenerationService(pe, slots=2, decode_horizon=2,
                              window=12).start()
    b = short.submit([5, 2, 7], max_new=6).result(timeout=120)
    with pytest.raises(ValueError, match="window"):
        short.submit([5, 2, 7], max_new=11)
    short.stop()
    jshort = JService(je, slots=2, decode_horizon=2, window=12).start()
    c = jshort.submit([5, 2, 7], max_new=6).result(timeout=120)
    jshort.stop()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(b, c)
    with pytest.raises(ValueError, match="window override"):
        CachedDecoder(pe, window=25)


def test_tiered_service_routes_and_matches_jax():
    """TieredGenerationService: short requests in the short tier, long
    ones in the full tier, tokens equal to the JAX tiered service's and
    to the uniform service's; cache bytes equal to the JAX tiers', 0.75x
    of a uniform pool of the same slots (the windows-weighted sum)."""
    je, pe = engines("gpt")     # model window 24
    short_p, long_p = [5, 2, 7], [3, 1, 4, 1, 5, 9, 2, 6]
    uniform = GenerationService(pe, slots=2, decode_horizon=2).start()
    want_short = uniform.submit(short_p, max_new=5).result(120)
    want_long = uniform.submit(long_p, max_new=14).result(120)
    uniform.stop()

    svc = TieredGenerationService(pe, tiers=((2, 12), (2, None)),
                                  decode_horizon=2)
    assert svc.windows == [12, 24]
    assert svc._route(short_p, 5) is svc.services[0]
    assert svc._route(long_p, 14) is svc.services[1]
    with pytest.raises(ValueError, match="largest tier"):
        svc._route(long_p, 20)
    with pytest.raises(ValueError, match="ascending"):
        TieredGenerationService(pe, tiers=((2, None), (2, 12)))
    svc.start()
    got_short = svc.submit(short_p, max_new=5).result(timeout=120)
    got_long = svc.submit_stream(long_p, max_new=14).result(timeout=120)
    svc.stop()
    jsvc = JTiered(je, tiers=((2, 12), (2, None)), decode_horizon=2).start()
    j_short = jsvc.submit(short_p, max_new=5).result(timeout=120)
    j_long = jsvc.submit(long_p, max_new=14).result(timeout=120)
    jsvc.stop()
    for got, want, jwant in ((got_short, want_short, j_short),
                             (got_long, want_long, j_long)):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jwant)
    assert [s.stats.completed for s in svc.services] == [1, 1]
    assert svc.stats.completed == 2
    assert svc.cache_bytes() == jsvc.cache_bytes()
    uni = sum(t.numel() * t.element_size() for leaves in
              uniform._dec.init_cache(4).values() for t in leaves)
    assert svc.cache_bytes() == pytest.approx(0.75 * uni, rel=0.01)


def test_adaptive_horizon_caps_blocks():
    """With requests waiting, blocks are capped (pow2) at the nearest
    live deadline so freed rows admit promptly; the completions equal a
    solo decode's and the JAX service's."""
    je, pe = engines("llama")
    prompts = [[4, 8, 2], [7, 1], [3, 3], [9]]
    want = [CachedDecoder(pe).generate(np.asarray([p]), steps=4)[0]
            for p in prompts]
    svc = GenerationService(pe, slots=1, decode_horizon=8,
                            adaptive_horizon=True)
    assert svc._block_ladder == [8, 4, 2, 1]
    seen = spy_blocks(svc)
    svc.start()
    got = [f.result(timeout=120) for f in
           [svc.submit(p, max_new=4) for p in prompts]]
    svc.stop()
    jsvc = JService(je, slots=1, decode_horizon=8,
                    adaptive_horizon=True).start()
    jwant = [f.result(timeout=300) for f in
             [jsvc.submit(p, max_new=4) for p in prompts]]
    jsvc.stop()
    for g, w, jw in zip(got, want, jwant):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, jw)
    assert seen and seen[0][0] < 8, seen
    assert all(p is None for k, p, _, _ in seen if k < 8)


def test_kv_prefix_ladder_token_equal():
    """The laddered service's completions equal the JAX decoder's, with
    at least one sub-window rung dispatched; a rung outside [1, window]
    is refused."""
    je, pe = engines("llama")
    prompts = [[4, 8, 2], [7, 1]]
    jdec = JDecoder(je)
    want = [jdec.generate(np.asarray([q]), steps=6)[0] for q in prompts]
    for attn in ("torch", "kernel", "auto"):
        svc = GenerationService(pe, slots=2, decode_horizon=3,
                                kv_prefix_ladder=(12, 16),
                                decode_attn=attn).warmup()
        seen = spy_blocks(svc)
        svc.start()
        outs = [f.result(timeout=120) for f in
                [svc.submit(q, max_new=6) for q in prompts]]
        svc.stop()
        for out, w in zip(outs, want):
            np.testing.assert_array_equal(out, w)
        assert any(p in (12, 16) for _, p, _, _ in seen), seen
    with pytest.raises(ValueError):
        GenerationService(pe, kv_prefix_ladder=(0,))
    auto = GenerationService(engines("gpt")[1], slots=2)
    assert auto._prefix_ladder == []       # window 24: no rung >= 64


@pytest.mark.parametrize("kv_dtype,scratch,attn", [
    (None, False, "torch"), ("bfloat16", False, "torch"),
    (None, True, "torch"), ("int8", True, "torch"), (None, True, "kernel"),
    ("int8", True, "kernel")])
def test_decode_block_kv_prefix_token_exact(kv_dtype, scratch, attn):
    """A rung covering pos + K gives the full-window block's tokens
    (greedy and sampled), across a chain of blocks at two rungs, on the
    torch route (sliced reads) and the kernel route (max_len)."""
    _, pe = engines("llama")
    prompt = np.array([[5, 1, 8], [2, 9, 3]])
    n, p = prompt.shape
    t = np.full(n, 0.9, np.float32)
    k = np.full(n, 7, np.int64)
    pp = np.ones(n, np.float32)
    dec = CachedDecoder(pe, kv_dtype=kv_dtype, scratch_blocks=scratch)
    window = np.zeros((n, dec._window), np.float32)
    window[:, :p] = prompt
    tok_a, ca = dec.prefill_sample(window, np.full(n, p), 0, 0, t, k, pp)
    tok_b, cb = dec.prefill_sample(window, np.full(n, p), 0, 0, t, k, pp)
    pos = np.full(n, p)
    kw = dict(attn_impl=attn) if scratch else {}
    wa, _, ca = dec.decode_block(tok_a, pos, ca, 0, 1, t, k, pp, 4, **kw)
    wb, _, cb = dec.decode_block(tok_b, pos, cb, 0, 1, t, k, pp, 4,
                                 kv_prefix=8, **kw)
    np.testing.assert_array_equal(wa.numpy(), wb.numpy())
    wa, _, ca = dec.decode_block(wa[:, -1], pos + 4, ca, 0, 5, t, k, pp, 4,
                                 **kw)
    wb, _, cb = dec.decode_block(wb[:, -1], pos + 4, cb, 0, 5, t, k, pp, 4,
                                 kv_prefix=16, **kw)
    np.testing.assert_array_equal(wa.numpy(), wb.numpy())
    for bad in (0, dec._window + 1):
        with pytest.raises(ValueError, match="kv_prefix"):
            dec.decode_block(np.ones(n), np.zeros(n), dec.init_cache(n), 0,
                             1, t, k, pp, 4, kv_prefix=bad)
    # step() takes a rung too: logits within the op tolerance of the
    # full read's (the softmax and P.V sum over fewer zeros)
    la, _ = dec.step(np.ones((n, 1)), pos + 8, ca)
    lb, _ = dec.step(np.ones((n, 1)), pos + 8, cb, kv_prefix=16)
    scale = max(1.0, float(la.abs().max()))
    np.testing.assert_allclose(lb.numpy(), la.numpy(), rtol=0,
                               atol=OP_TOL * scale)


def test_rungs_leave_ring_caches_whole():
    """On the gemma2-ish llama (alternate sliding layers: rings beside
    window caches) a rung cuts the full-attention layers only: decode
    blocks at a rung give the full read's tokens and the JAX decoder's,
    deep past the ring's first turn."""
    kw = dict(variant="nano", batch=1, seq_len=160, vocab_size=50,
              sliding_window=8, sliding_pattern="alternate", seed=4)
    jg = jbuilders.build_llama(**kw)[0]
    tg = tbuilders.build_llama(**kw)[0]
    je = JEngine(JConfig()).load_model(None, graph=jg)
    pe = Engine(EngineConfig(device="cpu", use_kernels=True)).load_model(
        None, graph=tg)
    dec = CachedDecoder(pe, scratch_blocks=True)
    assert {c[0].shape[2] for c in dec.init_cache(1).values()} == {72, 160}
    prompt = np.random.default_rng(2).integers(0, 50, (2, 90))
    want = JDecoder(je, scratch_blocks=True).generate(prompt, steps=20,
                                                      block=4)
    n, p = prompt.shape
    z, iz, o = np.zeros(n, np.float32), np.zeros(n, np.int64), np.ones(n)
    window = np.zeros((n, dec._window), np.float32)
    window[:, :p] = prompt
    tok, caches = dec.prefill_sample(window, np.full(n, p), 0, 0, z, iz, o)
    out = [tok.numpy()]
    last, fed = tok, p
    for _ in range(5):                 # rung 96 covers fed + 4 <= 96 ...
        rung = 96 if fed + 4 <= 96 else 128
        toks, last, caches = dec.decode_block(last, np.full(n, fed), caches,
                                              0, 1, z, iz, o, 4,
                                              kv_prefix=rung)
        out.append(toks.numpy())
        fed += 4
    got = np.concatenate([prompt, out[0][:, None]] + out[1:], axis=1)
    np.testing.assert_array_equal(got[:, :p + 20], want)


def test_decode_block_per_call_cap_override():
    """decode_block(sample_cap=...) flips the sampler per call on one
    decoder: greedy rows are token-identical either way (and equal to
    the JAX decoder's)."""
    je, pe = engines("gpt100")
    dec = CachedDecoder(pe)
    n = 2
    t = np.zeros(n, np.float32)
    k = np.zeros(n, np.int64)
    p = np.ones(n, np.float32)
    window = np.zeros((n, dec._window), np.float32)
    window[:, :3] = [[4, 8, 2]] * n

    def run(cap):
        caches = dec.init_cache(n)
        tok, caches = dec.prefill_install(window, np.full(n, 3), 0, 0, t, k,
                                          p, caches, np.arange(n),
                                          sample_cap=cap)
        toks, _last, caches = dec.decode_block(tok, np.full(n, 3), caches,
                                               0, 1, t, k, p, 4,
                                               sample_cap=cap)
        return np.concatenate([tok.numpy()[:, None], toks.numpy()], axis=1)

    a, b = run(None), run(8)
    np.testing.assert_array_equal(a, b)
    want = JDecoder(je).generate(np.asarray([[4, 8, 2]]), steps=5)[0]
    np.testing.assert_array_equal(a[0], want[3:])
    with pytest.raises(ValueError, match="sample_cap"):
        CachedDecoder(pe, sample_cap=0)


def test_sample_cap_service_modes():
    """Auto cap: an all-greedy pool rides the capped sampler on every
    block with the uncapped service's tokens; a live nucleus-only row
    takes its blocks to the exact sampler, with no warning. A fixed cap
    truncates out-of-regime rows and warns once."""
    _, pe = engines("gpt100")
    prompts = [[4, 8, 2], [7, 1], [3, 3, 9, 5]]

    def run(cap):
        svc = GenerationService(pe, slots=2, seed=3, sample_cap=cap).start()
        outs = [svc.submit(q, max_new=5).result(timeout=120)
                for q in prompts]
        svc.stop()
        return outs, svc.stats

    got, stats_auto = run("auto")
    want, stats_off = run(None)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert stats_auto.capped_steps == stats_auto.steps > 0
    assert stats_off.capped_steps == 0

    logger = logging.getLogger("simpleinfer_tpu_torch.serving.llm")
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger.addHandler(handler)
    try:
        svc = GenerationService(pe, slots=2, seed=3).start()
        outs = [f.result(timeout=120) for f in
                [svc.submit([4, 8], max_new=6, temperature=1.0, top_p=0.9),
                 svc.submit([5, 1, 2], max_new=6)]]
        svc.stop()
        assert svc.stats.capped_steps < svc.stats.steps
        assert not records
        fixed = GenerationService(pe, slots=2, seed=3, sample_cap=8).start()
        for _ in range(2):
            out = fixed.submit([4, 8], max_new=4, temperature=1.0,
                               top_p=0.9).result(timeout=120)
            assert out.shape == (6,) and ((out >= 0) & (out < 100)).all()
        fixed.stop()
    finally:
        logger.removeHandler(handler)
    assert len(records) == 1
    for out in outs:
        assert ((out >= 0) & (out < 100)).all()
    with pytest.raises(ValueError, match="sample_cap"):
        GenerationService(pe, sample_cap="AUTO")


# ---- cancel, deadlines, priorities ------------------------------------------
def test_cancel_queued_and_active():
    """cancel(): a queued request's future raises CancelledError and
    never runs; an active one's row frees at the next drain and its
    future resolves with the tokens accepted so far; the freed row
    serves new requests."""
    _, pe = engines("gpt")
    svc = GenerationService(pe, slots=1, decode_horizon=2).start()
    f_active = svc.submit([4, 8, 2], max_new=16)
    wait_admitted(svc)
    f_queued = svc.submit([5, 5], max_new=16)
    assert svc.cancel(f_queued) is True
    with pytest.raises(cf.CancelledError):
        f_queued.result(timeout=60)
    was_live = svc.cancel(f_active)
    out = f_active.result(timeout=60)
    if was_live:
        assert 3 <= len(out) < 3 + 16
        assert svc.stats.cancelled == 1
    else:
        assert len(out) == 3 + 16
    np.testing.assert_array_equal(out[:3], [4, 8, 2])
    assert svc.cancel(f_active) is False
    out2 = svc.submit([7, 1], max_new=4).result(timeout=60)
    assert len(out2) == 2 + 4
    svc.stop()


def test_cancel_stream_ends():
    _, pe = engines("gpt")
    svc = GenerationService(pe, slots=1, decode_horizon=2).start()
    h = svc.submit_stream([4, 8], max_new=18)
    got = []
    for tok in h:
        got.append(tok)
        if len(got) == 2:
            svc.cancel(h.future)
    assert len(got) < 18
    out = h.result(timeout=60)
    np.testing.assert_array_equal(out[:2], [4, 8])
    np.testing.assert_array_equal(out[2:], got[:len(out) - 2])
    svc.stop()


def test_cancelled_row_does_not_leak_into_the_next_occupant():
    """One slot, pipelined, horizon 2: a streamed request is cancelled
    while its successor block is in flight; the next request admitted
    into the row streams exactly its own solo-decode tokens."""
    _, pe = engines("gpt")
    want = CachedDecoder(pe).generate(np.asarray([[9, 3, 5]]), steps=8)[0]
    svc = GenerationService(pe, slots=1, decode_horizon=2).start()
    h = svc.submit_stream([4, 8], max_new=18)
    nxt = svc.submit_stream([9, 3, 5], max_new=8)
    for i, _tok in enumerate(h):
        if i == 2:
            svc.cancel(h.future)
    streamed = list(nxt)
    svc.stop()
    assert len(h.result(timeout=60)) < 2 + 18
    np.testing.assert_array_equal(nxt.result(timeout=60), want)
    assert streamed == list(want[3:])


def test_request_deadlines():
    """submit(timeout_s=...): a queued request past its deadline fails
    with TimeoutError at admission; an active one resolves with the
    tokens accepted so far."""
    _, pe = engines("gpt")
    svc = GenerationService(pe, slots=1, decode_horizon=1)
    orig = svc._dec.decode_block

    def slow_block(*a, **kw):       # a block takes 20 ms, as on a slow card
        time.sleep(0.02)
        return orig(*a, **kw)
    svc._dec.decode_block = slow_block
    svc.start()
    with pytest.raises(ValueError):
        svc.submit([1], max_new=2, timeout_s=0)
    f = svc.submit([4, 8, 2], max_new=18, timeout_s=0.05)
    out = f.result(timeout=60)
    assert 3 <= len(out) < 3 + 18
    assert svc.stats.timed_out >= 1
    f_long = svc.submit([5, 5], max_new=18)
    f_q = svc.submit_stream([7, 1], max_new=4, timeout_s=0.001)
    with pytest.raises(TimeoutError):       # the stream ends, raising
        list(f_q)
    with pytest.raises(TimeoutError):
        f_q.result(timeout=60)
    f_long.result(timeout=60)
    svc.stop()


def test_priority_admission_order():
    """Higher priorities jump the admission queue (FIFO within a
    class); the active row is never preempted."""
    _, pe = engines("gpt")
    svc = GenerationService(pe, slots=1, decode_horizon=1).start()
    blocker = svc.submit([4, 8], max_new=12)
    wait_admitted(svc)
    lo1 = svc.submit([1, 1], max_new=2)
    lo2 = svc.submit([2, 2], max_new=2)
    hi = svc.submit([3, 3], max_new=2, priority=5)
    with svc._cv:
        order = [tuple(r.prompt) for r in svc._queue]
    assert order == [(3, 3), (1, 1), (2, 2)]
    for f in (blocker, hi, lo1, lo2):
        f.result(timeout=120)
    svc.stop()


def test_priority_zero_beats_negative():
    """A default-priority (0) request submitted after a negative one
    admits first."""
    _, pe = engines("gpt")
    svc = GenerationService(pe, slots=1, decode_horizon=1).start()
    blocker = svc.submit([4, 8], max_new=12)
    wait_admitted(svc)
    neg = svc.submit([1, 1], max_new=2, priority=-3)
    zero = svc.submit([2, 2], max_new=2)
    with svc._cv:
        order = [tuple(r.prompt) for r in svc._queue]
    assert order == [(2, 2), (1, 1)]
    for f in (blocker, neg, zero):
        f.result(timeout=120)
    svc.stop()


def test_survives_direct_future_cancel():
    """future.cancel() on the handed-back Future (not through
    svc.cancel) does not end the scheduler; other requests complete."""
    _, pe = engines("gpt")
    svc = GenerationService(pe, slots=2, decode_horizon=1).start()
    doomed = svc.submit([4, 8], max_new=4)
    doomed.cancel()
    assert len(svc.submit([1, 2, 3], max_new=4).result(timeout=120)) >= 3
    assert len(svc.submit([5, 6], max_new=2).result(timeout=120)) >= 2
    svc.stop()


def test_host_lock_released_for_a_wait():
    """The tiers' host lock: a holder's released() section (a scheduler
    waiting for the card) lets a waiting thread in, and the holder takes
    the lock back only after it."""
    import threading

    from simpleinfer_tpu_torch.serving.llm import _FairLock

    lock, order = _FairLock(), []
    inside = threading.Event()

    def other():
        inside.wait(timeout=30)
        with lock:
            order.append("other")
            time.sleep(0.05)

    t = threading.Thread(target=other)
    t.start()
    with lock:
        inside.set()
        time.sleep(0.05)             # the other thread queues for the lock
        with lock.released():
            for _ in range(500):
                if order:
                    break
                time.sleep(0.01)
            order.append("wait done")
        order.append("holder again")
    t.join(timeout=30)
    assert order == ["other", "wait done", "holder again"]


# ---- fuse_qkv ---------------------------------------------------------------
@pytest.mark.parametrize("quant", [None, "int8w", "int4w"])
def test_fuse_qkv_vs_unfused(quant):
    """fuse_qkv: one [E, (H + 2 KV) D] weight per attention op (int4
    nibbles and group scales, or int8 data and channel scales, side by
    side along N); a decode step's logits within 1e-5 x scale of the
    unfused decoder's (fp32), greedy tokens equal to the unfused and the
    JAX fused decoder's."""
    je, pe = engines("llama", quant)
    plain = CachedDecoder(pe)
    fused = CachedDecoder(pe, fuse_qkv=True)
    (name, info), = plain._mha_ops[:1]
    heads, kvh, d = plain._geometry(info)
    wqkv = fused._weights[name]["wqkv"]
    assert tuple(wqkv.shape)[1] == (heads + 2 * kvh) * d
    assert "wqkv" not in plain._weights[name]
    prompt = np.array([[5, 1, 8], [2, 9, 3]])
    tokens = np.zeros((2, 24), np.float32)
    tokens[:, :3] = prompt
    la, ca = plain.prefill(tokens, np.full(2, 3))
    lb, cb = fused.prefill(tokens, np.full(2, 3))
    nxt = la.argmax(-1).numpy()[:, None]
    sa, _ = plain.step(nxt, np.full(2, 3), ca)
    sb, _ = fused.step(nxt, np.full(2, 3), cb)
    scale = max(1.0, float(sa.abs().max()))
    np.testing.assert_allclose(sb.numpy(), sa.numpy(), rtol=0,
                               atol=OP_TOL * scale)
    want = plain.generate(prompt, steps=8, block=4)
    np.testing.assert_array_equal(fused.generate(prompt, steps=8, block=4),
                                  want)
    np.testing.assert_array_equal(
        JDecoder(je, fuse_qkv=True).generate(prompt, steps=8, block=4),
        want)


# ---- chip_smoke's gen_http phase, rehearsed ---------------------------------
def test_chip_smoke_gen_http_rehearses_on_cpu():
    """chip_smoke.py's gen_http phase (the tiered service behind the HTTP
    server, SSE streams, hang-ups, deadlines, priorities, the solo
    check, the rung routes and adaptive_horizon) on the CPU at a tiny
    size with the plain versions."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    res = chip_smoke.gen_http_rehearsal(torch.device("cpu"))
    assert res["http"]["requests"] == res["in_process"]["requests"]
    assert res["http"]["hung_up_freed"] == res["http"]["hung_up"] > 0
    assert res["http"]["expired_as_specified"] == res["http"]["expired"]
