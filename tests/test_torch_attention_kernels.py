"""The port's attention kernels' wrappers (simpleinfer_tpu_torch.kernels.
attention.flash_attention and kernels.decode_attn.decode_attention)
against the JAX package's oracles and its Pallas kernels in interpret
mode, on the same numpy-seeded inputs.

On the CPU a wrapper runs its plain PyTorch version (the CUDA kernels
need a card; tests/test_torch_cuda.py and chip_smoke.py hold them
against the plain versions there). Tolerances: 1e-5 x max(1, max|ref|)
for f32 (the same math, sums in another order); the decode running max
m within one f32 rounding of a score (rtol 1e-6: the two frameworks sum
q.k in another order) and exactly the -1e30 sentinel for an empty row;
a query row with no live key is 0 in the port where the JAX oracle's
softmax gives NaN (the Pallas kernel, like the port's kernel, gives 0).
"""
import os
import sys

import jax  # noqa: F401  (both frameworks in one process, JAX on CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleinfer_tpu.kernels import attention as jattn
from simpleinfer_tpu.kernels import decode_attn as jdec
from simpleinfer_tpu_torch.kernels import attention as tattn
from simpleinfer_tpu_torch.kernels import decode_attn as tdec

TOL = 1e-5


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol)


def _close_m(got, want):
    want = np.asarray(want)
    np.testing.assert_array_equal(got == np.float32(-1e30),
                                  want == np.float32(-1e30))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _qkv(b, h, lq, lk, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, l_, d)).astype(np.float32)
            for l_ in (lq, lk, lk)]


# (B, H, Lq, Lk, D, causal, sliding_window)
FLASH_CASES = [
    (2, 3, 40, 40, 24, True, None),      # the qwen3-like head_dim
    (1, 2, 17, 45, 16, False, None),     # non-causal, Lq != Lk
    (1, 2, 70, 70, 16, True, 9),         # banded
    (2, 1, 33, 33, 8, True, 33),         # band as wide as L = causal
    (1, 4, 64, 64, 64, True, None),      # the llama head_dim
]


@pytest.mark.parametrize("b,h,lq,lk,d,causal,sw", FLASH_CASES)
def test_flash_ref_vs_jax_oracle(b, h, lq, lk, d, causal, sw):
    q, k, v = _qkv(b, h, lq, lk, d, seed=lq + d)
    got = tattn.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                causal=causal, sliding_window=sw)
    want = jattn.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                     causal=causal, sliding_window=sw)
    _close(got.numpy(), want)


@pytest.mark.parametrize("b,h,lq,lk,d,causal,sw", FLASH_CASES)
def test_flash_ref_vs_pallas_interpret(b, h, lq, lk, d, causal, sw):
    q, k, v = _qkv(b, h, lq, lk, d, seed=lq + d + 1)
    got = tattn.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                    causal=causal, sliding_window=sw
                                    if sw is None or sw < lk else None)
    want = jattn.flash_attention(*map(jnp.asarray, (q, k, v)),
                                 causal=causal, sliding_window=sw,
                                 interpret=True)
    _close(got.numpy(), want)


def test_flash_rank3_and_scale():
    q, k, v = _qkv(1, 6, 20, 20, 8, seed=3)
    q3, k3, v3 = (t[0] for t in (q, k, v))            # [BH, L, D]
    got = tattn.flash_attention(*map(torch.from_numpy, (q3, k3, v3)),
                                causal=True, scale=0.3)
    want = jattn.flash_attention(*map(jnp.asarray, (q3, k3, v3)),
                                 causal=True, scale=0.3, interpret=True)
    assert got.shape == (6, 20, 8)
    _close(got.numpy(), want)


def test_flash_fully_masked_rows_are_zero():
    """Bottom-right causal alignment with Lq > Lk leaves the first
    Lq - Lk query rows with no live key: 0 in the port (the kernel's
    contract), NaN in the JAX oracle; the other rows agree."""
    q, k, v = _qkv(1, 2, 10, 6, 8, seed=4)
    got = tattn.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                    causal=True).numpy()
    want = np.asarray(jattn.flash_attention_ref(
        *map(jnp.asarray, (q, k, v)), causal=True))
    dead = np.isnan(want).all(axis=-1)
    assert dead[..., :4].all() and not dead[..., 4:].any()
    assert np.all(got[dead] == 0.0)
    _close(got[~dead], want[~dead])


def test_flash_bf16_vs_jax_oracle():
    """bf16 inputs: the same f32 scores and softmax, P rounded to bf16
    before P.V in both; outputs within one bf16 ulp."""
    q, k, v = _qkv(1, 2, 32, 32, 16, seed=5)
    got = tattn.flash_attention(
        *(torch.from_numpy(t).bfloat16() for t in (q, k, v)), causal=True)
    want = jattn.flash_attention_ref(
        *(jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v)),
        causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2.0 ** -7, rtol=2.0 ** -7)


def test_flash_argument_rules():
    q = torch.zeros(1, 1, 4, 8)
    k = torch.zeros(1, 1, 5, 8)
    with pytest.raises(ValueError, match="Lq == Lk"):
        tattn.flash_attention(q, k, k, causal=True)
    with pytest.raises(ValueError, match="causal"):
        tattn.flash_attention(q, q, q, sliding_window=2)
    with pytest.raises(ValueError, match=">= 1"):
        tattn.flash_attention(q, q, q, causal=True, sliding_window=0)


@pytest.mark.parametrize("lq,lk,causal,sw", [
    (2048, 2048, True, None), (1024, 1024, True, None),
    (4096, 4096, False, None), (2048, 2048, False, None),
    (1, 2048, True, None), (2048, 2048, True, 256), (1024, 1024, True, 256),
    (2048, 2048, True, 1024), (8192, 8192, True, 256)])
def test_flash_gates_match_jax(lq, lk, causal, sw, monkeypatch):
    """The port's gates are the JAX package's, but for the thresholds
    measured on the H100 (FLASH_MIN_LK, FLASH_BAND_MIN_LK) and the JAX
    band gate's limit of a band to Lk / 4, which the port drops: with
    the JAX package's thresholds set, they agree everywhere, the JAX
    band gate read at a band within its limit."""
    def jax_band(lq, lk, sw):
        return jattn.flash_band_profitable(
            lq, lk, None if sw is None else min(sw, lk // 4))

    monkeypatch.setattr(tattn, "FLASH_MIN_LK", 2048)
    monkeypatch.setattr(tattn, "FLASH_BAND_MIN_LK", 1536)
    assert tattn.flash_profitable(lq, lk, causal) == \
        jattn.flash_profitable(lq, lk, causal)
    assert tattn.flash_band_profitable(lq, lk, sw) == jax_band(lq, lk, sw)
    monkeypatch.setenv("SI_FLASH_MIN_LK", "64")
    monkeypatch.setenv("SI_FLASH_BAND_MIN_LK", "64")
    assert tattn.flash_profitable(lq, lk, causal) == \
        jattn.flash_profitable(lq, lk, causal)
    assert tattn.flash_band_profitable(lq, lk, sw) == jax_band(lq, lk, sw)


@pytest.mark.parametrize("lq,lk,causal,want", [
    (256, 256, True, True), (255, 255, True, False), (2048, 2048, True, True),
    (512, 512, False, False), (1, 2048, True, False)])
def test_flash_gate_measured_default(lq, lk, causal, want, monkeypatch):
    """Causal prefill takes the flash kernel from Lk 256 (the H100
    crossover lies at or below the shortest length measured); the
    non-causal and Lq gates stay the JAX package's."""
    monkeypatch.delenv("SI_FLASH_MIN_LK", raising=False)
    assert tattn.FLASH_MIN_LK == 256
    assert tattn.flash_profitable(lq, lk, causal) == want


@pytest.mark.parametrize("lq,lk,sw,want", [
    (512, 512, 256, True), (511, 511, 256, False), (2048, 2048, 512, True),
    (2048, 2048, 2048, True), (1024, 1024, 1536, True),
    (4096, 4096, 1024, True), (128, 512, 64, False), (2048, 2048, None,
                                                      False)])
def test_flash_band_gate_measured_default(lq, lk, sw, want, monkeypatch):
    """Sliding prefill takes the banded kernel from Lk 512 at any band
    (the H100 sweep: faster than the banded torch path at every L and
    band measured; ops.attention.causal_context runs a band of Lk or
    more as plain causal); Lq stays the JAX package's 256."""
    monkeypatch.delenv("SI_FLASH_BAND_MIN_LK", raising=False)
    monkeypatch.delenv("SI_FLASH_BAND_MIN_LQ", raising=False)
    assert tattn.FLASH_BAND_MIN_LK == 512
    assert tattn.flash_band_profitable(lq, lk, sw) == want


# ---- decode attention -----------------------------------------------------
def _decode_inputs(n, kvh, g, length, d, int8, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, kvh, g, d)).astype(np.float32)
    if int8:
        leaves = []
        for _ in range(2):
            vals = rng.integers(-127, 128, (n, kvh, length, d)).astype(
                np.int8)
            scales = rng.uniform(0.005, 0.02, (n, kvh, length, 1)).astype(
                np.float32)
            leaves.append((vals, scales))
        return q, leaves[0], leaves[1]
    k, v = (rng.standard_normal((n, kvh, length, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _to(leaf, fn):
    return tuple(map(fn, leaf)) if isinstance(leaf, tuple) else fn(leaf)


# (N, KV, G, L, D, int8, lengths): GQA groups, lengths 0 / partial / full
DECODE_CASES = [
    (3, 2, 3, 40, 16, False, [0, 17, 40]),
    (3, 2, 3, 40, 16, True, [0, 17, 40]),
    (2, 4, 1, 24, 8, False, [24, 1]),
    (4, 2, 4, 64, 64, True, [64, 63, 0, 9]),
]


@pytest.mark.parametrize("n,kvh,g,length,d,int8,lens", DECODE_CASES)
def test_decode_ref_vs_jax_oracle(n, kvh, g, length, d, int8, lens):
    q, k, v = _decode_inputs(n, kvh, g, length, d, int8, seed=n + length)
    scale = 1.0 / np.sqrt(d)
    got = tdec.decode_attention(
        torch.from_numpy(q), _to(k, torch.from_numpy),
        _to(v, torch.from_numpy), torch.tensor(lens), scale=scale)
    want = jdec.decode_attention_ref(jnp.asarray(q), _to(k, jnp.asarray),
                                     _to(v, jnp.asarray),
                                     jnp.asarray(lens), scale=scale)
    o, m, l = (t.numpy() for t in got)
    _close_m(m, want[1])
    _close(o, want[0])
    _close(l, want[2])
    dead = np.asarray(lens) == 0
    assert np.all(o[dead] == 0) and np.all(l[dead] == 0)
    assert np.all(m[dead] == np.float32(-1e30))


@pytest.mark.parametrize("n,kvh,g,length,d,int8,lens", DECODE_CASES)
def test_decode_ref_vs_pallas_interpret(n, kvh, g, length, d, int8, lens):
    q, k, v = _decode_inputs(n, kvh, g, length, d, int8, seed=n + d)
    scale = 1.0 / np.sqrt(d)
    got = tdec.decode_attention_ref(
        torch.from_numpy(q), _to(k, torch.from_numpy),
        _to(v, torch.from_numpy), torch.tensor(lens), scale=scale)
    want = jdec.decode_attention(jnp.asarray(q), _to(k, jnp.asarray),
                                 _to(v, jnp.asarray), jnp.asarray(lens),
                                 scale=scale, block_k=8, interpret=True)
    o, m, l = (t.numpy() for t in got)
    _close_m(m, want[1])
    _close(o, want[0])
    _close(l, want[2])


def _close_scores(got, want):
    """m against the JAX side where a row's m may be one raw score near
    0 (a row of length 1): f32 rounding of the dot product (~1e-8) held
    to TOL x max(1, |m|), as o and l are; the -1e30 sentinel exactly."""
    want = np.asarray(want)
    np.testing.assert_array_equal(got == np.float32(-1e30),
                                  want == np.float32(-1e30))
    live = want > np.float32(-1e29)
    _close(got[live], want[live])


@pytest.mark.parametrize("int8", [False, True])
def test_decode_split_edges_vs_jax(int8):
    """The lengths a split over positions makes hard (the card's kernel
    shares each row's live positions among its blocks, 32 positions a
    block here at L 96): 0, 1, one share minus and plus one, and L;
    against the JAX oracle and the Pallas kernel in interpret mode."""
    n, kvh, g, length, d = 5, 2, 4, 96, 16
    lens = [0, 1, 31, 33, 96]
    q, k, v = _decode_inputs(n, kvh, g, length, d, int8, seed=11)
    scale = 1.0 / np.sqrt(d)
    assert tdec.decode_splits(length, 32) == 3
    got = tdec.decode_attention(
        torch.from_numpy(q), _to(k, torch.from_numpy),
        _to(v, torch.from_numpy), torch.tensor(lens), scale=scale,
        block_k=32)
    o, m, l = (t.numpy() for t in got)
    oracle = jdec.decode_attention_ref(jnp.asarray(q), _to(k, jnp.asarray),
                                       _to(v, jnp.asarray), jnp.asarray(lens),
                                       scale=scale)
    pallas = jdec.decode_attention(jnp.asarray(q), _to(k, jnp.asarray),
                                   _to(v, jnp.asarray), jnp.asarray(lens),
                                   scale=scale, block_k=8, interpret=True)
    for want in (oracle, pallas):
        _close_scores(m, want[1])
        _close(o, want[0])
        _close(l, want[2])
    assert np.all(o[0] == 0) and np.all(l[0] == 0)


@pytest.mark.parametrize("int8", [False, True])
def test_decode_max_len_under_l_vs_jax(int8):
    """max_len under L (each live row's length fits, as the caller
    guarantees): the port's read bound against the JAX oracle on the
    same lengths and the Pallas kernel in interpret mode with the same
    max_len."""
    n, kvh, g, length, d, max_len = 4, 2, 4, 96, 16, 48
    lens = [0, 1, 47, 48]
    q, k, v = _decode_inputs(n, kvh, g, length, d, int8, seed=7)
    scale = 1.0 / np.sqrt(d)
    got = tdec.decode_attention(
        torch.from_numpy(q), _to(k, torch.from_numpy),
        _to(v, torch.from_numpy), torch.tensor(lens), scale=scale,
        max_len=max_len)
    o, m, l = (t.numpy() for t in got)
    oracle = jdec.decode_attention_ref(jnp.asarray(q), _to(k, jnp.asarray),
                                       _to(v, jnp.asarray), jnp.asarray(lens),
                                       scale=scale)
    pallas = jdec.decode_attention(jnp.asarray(q), _to(k, jnp.asarray),
                                   _to(v, jnp.asarray), jnp.asarray(lens),
                                   scale=scale, block_k=8, max_len=max_len,
                                   interpret=True)
    for want in (oracle, pallas):
        _close_scores(m, want[1])
        _close(o, want[0])
        _close(l, want[2])
    assert np.all(o[0] == 0) and np.all(l[0] == 0)
    assert np.all(m[0] == np.float32(-1e30))


def test_decode_splits_from_the_bound():
    """The blocks sharing a (row, kv head) on the card: one per
    SPLIT_POSITIONS of the bound (L or max_len), at least 1, at most
    MAX_SPLITS; 4 at the llama service's window of 2048."""
    assert tdec.decode_splits(2048) == 4
    assert tdec.decode_splits(0) == tdec.decode_splits(1) == 1
    assert tdec.decode_splits(513) == 2
    assert tdec.decode_splits(10 ** 6) == tdec.MAX_SPLITS
    assert tdec.decode_splits(2048, 32) == tdec.MAX_SPLITS
    assert tdec.decode_splits(96, 32) == 3


def test_decode_bf16_cache_and_max_len():
    """A bf16 cache reads as its f32 values; max_len truncates each
    row's read to the prefix (the JAX kernel's occupied-prefix bound)."""
    q, k, v = _decode_inputs(2, 2, 2, 32, 8, False, seed=9)
    kb, vb = (torch.from_numpy(t).bfloat16() for t in (k, v))
    lens = torch.tensor([32, 10])
    got = tdec.decode_attention(torch.from_numpy(q), kb, vb, lens,
                                scale=0.3, max_len=16)
    want = tdec.decode_attention_ref(torch.from_numpy(q), kb.float(),
                                     vb.float(), torch.tensor([16, 10]),
                                     scale=0.3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_attention_wrappers_without_card():
    """CPU tensors take the plain versions and launch nothing; another
    device goes to the kernel path, which raises (no fallback)."""
    before = (tattn.launches, tdec.launches)
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 1, 8, 8, 4, seed=0))
    tattn.flash_attention(q, k, v, causal=True)
    qd, kd, vd = (torch.from_numpy(t) for t in
                  _decode_inputs(1, 1, 2, 8, 4, False, seed=0))
    tdec.decode_attention(qd, kd, vd, torch.tensor([5]), scale=0.5)
    assert (tattn.launches, tdec.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        tdec.decode_attention(qd.to("meta"), kd.to("meta"), vd.to("meta"),
                              torch.tensor([5]), scale=0.5)


# ---- the tensor-core flash route's arithmetic, emulated -------------------
def _chip_smoke():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


def _flash_mma_order(q, k, v, causal, scale, sw, tk=64):
    """The bf16 route of csrc/flash_attention.cu in its arithmetic order:
    f32 logits of the bf16 q, k, an online softmax over 64-key tiles
    (running max of the raw logits and running sum in f32; exponents
    s * scale * log2(e) - m * scale * log2(e) in base 2; a row with no
    live key so far is shifted by 0), the unnormalized P rounded to bf16
    before P.V with f32 sums, divided by the running sum at the end."""
    lq, lk = q.shape[-2], k.shape[-2]
    sl2 = scale * 1.4426950408889634
    qf, kf, vf = q.float(), k.float(), v.float()
    i = torch.arange(lq)[:, None]
    m = torch.full(q.shape[:-1] + (1,), float("-inf"))
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape[:-1] + (v.shape[-1],))
    for k0 in range(0, lk, tk):
        j = torch.arange(k0, min(k0 + tk, lk))[None, :]
        s = qf @ kf[..., k0:k0 + tk, :].transpose(-1, -2)
        if causal:
            live = j <= i
            if sw is not None:
                live &= j > i - sw
            s = s.masked_fill(~live, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        safe = torch.where(torch.isinf(m_new), 0.0, m_new * sl2)
        alpha = torch.where(torch.isinf(m), 0.0, torch.exp2(m * sl2 - safe))
        p = torch.exp2(s * sl2 - safe)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.bfloat16().float() @ vf[..., k0:k0 + tk, :]
        m = m_new
    return torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0).to(q.dtype)


# chip_smoke's flash cases (bf16) and the llama width cut to L <= 512
FLASH_MMA_CASES = [(2, 3, 100, 100, 24, True, None),
                   (1, 4, 77, 130, 64, False, None),
                   (2, 2, 300, 300, 64, True, 50),
                   (1, 2, 200, 200, 128, True, 64),
                   (1, 2, 129, 129, 256, True, None),
                   (1, 8, 512, 512, 64, True, None),
                   (2, 4, 384, 384, 64, True, None)]


@pytest.mark.parametrize("b,h,lq,lk,d,causal,sw", FLASH_MMA_CASES)
def test_flash_mma_order_within_card_tolerance(b, h, lq, lk, d, causal, sw):
    """The tensor-core route's order against the plain version (one f32
    softmax, normalized P rounded to bf16), bf16 inputs, within
    chip_smoke's flash limit: 1e-4 x max(1, |ref|) + one bf16 ulp +
    2 x 2^-8 sum_j p_j |v_j| (both sides round P to bf16)."""
    cs = _chip_smoke()
    q, k, v = (torch.from_numpy(t).bfloat16()
               for t in _qkv(b, h, lq, lk, d, seed=lq + d + 2))
    scale = 1.0 / np.sqrt(d)
    got = _flash_mma_order(q, k, v, causal, scale, sw)
    ref = tattn.flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                    sliding_window=sw)
    lim = cs.KERNEL_ATOL * max(1.0, float(ref.float().abs().max()))
    lim = lim + cs.FLASH_BF16_P_ROUNDOFF * tattn.flash_attention_ref(
        q.float(), k.float(), v.float().abs(), causal=causal, scale=scale,
        sliding_window=sw)
    _, ok, share = cs._close_tol(got, ref, lim, cs.KERNEL_BF16_RTOL)
    assert ok, share
