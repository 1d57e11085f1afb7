"""The port's CUDA kernels and Engine on the card (marker `cuda`).

These tests need a CUDA card and skip without one. They import neither
jax nor the JAX package, so they run where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py configures JAX for the other tests.)
Tolerances as in chip_smoke.py: 1e-4 x max(1, max|ref|) for the kernel
against its plain version (f32 sums in another order), plus one bf16
ulp (2^-7 relative) for a bf16 output; fp32 Engine on the card against
the CPU within 1e-4 x scale + 1e-4 x |ref|. c3_block: 1e-5 x max(1,
|ref|) elementwise in f32 with fp taps; with bf16 or s8 taps max 0.05 x
scale and mean 5e-4 x scale (an intermediate within rounding of a bf16
or int8 step takes the next step on one side: chip_smoke.C3_MAX_TOL).
conv3x3_s1_same and stem_s2d as the matmul kernels. The kernels-off
routes: static int8's torch._int_mm product bit-equal to the float64
one; the bf16 C3 chain (ops/c3.c3_chain) within c3_block's bf16 limit
of c3_block_reference. decode_attention's split route and matmul_s8s8's
weight layouts are held to the same limits, with bit-equal reruns and
exact s32 sums.
"""
import numpy as np
import pytest
import torch

from simpleinfer_tpu_torch import Engine, EngineConfig
from simpleinfer_tpu_torch.engine import fp32_parity
from simpleinfer_tpu_torch.kernels import attention as kattn
from simpleinfer_tpu_torch.kernels import c3block as kc3
from simpleinfer_tpu_torch.kernels import conv3x3 as kconv
from simpleinfer_tpu_torch.kernels import decode_attn as kdec
from simpleinfer_tpu_torch.kernels import matmul as tmm
from simpleinfer_tpu_torch.kernels import stem as kstem
from simpleinfer_tpu_torch.ops import c3 as oc3
from simpleinfer_tpu_torch.ops import conv as oconv
from simpleinfer_tpu_torch.quant.tensor import (quantize_int4_grouped,
                                                quantize_per_channel)
from simpleinfer_tpu_torch.zoo import build_llama, build_yolov5
from simpleinfer_tpu_torch.zoo.generate import CachedDecoder

SHAPES = [(128, 128, 128), (256, 512, 256), (100, 60, 50), (1, 256, 255),
          (37, 129, 131), (8, 16, 8)]
ACTIVATIONS = [None, "relu", "silu", "sigmoid", "hardsigmoid", "hardswish",
               "relu6", "tanh", "mish", "gelu", "gelu_tanh",
               "leaky_relu@0.1", "elu@1.0"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs the CUDA kernel)")
    return torch.device("cuda")


def _assert_close(got, ref):
    assert got.dtype == ref.dtype
    bf16 = got.dtype == torch.bfloat16
    got, ref = got.float().cpu(), ref.float().cpu()
    lim = 1e-4 * max(1.0, float(ref.abs().max()))
    if bf16:
        lim = lim + 2.0 ** -7 * ref.abs()
    d = (got - ref).abs()
    assert bool((d <= lim).all()), float(d.max())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_kernel_matches_plain_on_card(cuda, m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k), dtype=np.float32)
    w = rng.standard_normal((k, n), dtype=np.float32) / np.sqrt(k)
    b = torch.from_numpy(0.1 * rng.standard_normal(n).astype(np.float32))
    q = quantize_per_channel(w, axis=1)
    wq, scale = q.data.to(cuda), q.scale.to(cuda)
    before = tmm.launches
    for dtype in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(cuda, dtype)
        wt = torch.from_numpy(w).to(cuda, dtype)
        bt = b.to(cuda, dtype)
        for act in ACTIVATIONS:
            with fp32_parity(True):
                got = tmm.matmul_int8w(xt, wq, scale, bt, act)
                torch.cuda.synchronize()
                _assert_close(got, tmm.matmul_int8w_ref(xt, wq, scale, bt,
                                                        act))
                got = tmm.matmul(xt, wt, bt, act)
                torch.cuda.synchronize()
                _assert_close(got, tmm.matmul_ref(xt, wt, bt, act))
    assert tmm.launches - before == 2 * 2 * len(ACTIVATIONS)


# the tensor-core route at the main paths' widths: ResNet-50-b128's
# pointwise convs (M 401,408 .. 6,272, K / N 64 .. 2,048), YOLOv5s-b8's
# narrow ones (N 32, 64) and its Detect head (N 255: w and out by
# element), and ragged K (element-staged x) / N
MMA_SHAPES = [(401408, 64, 256), (100352, 512, 128), (25088, 1024, 256),
              (6272, 2048, 512), (6272, 512, 2048), (204800, 32, 32),
              (51200, 128, 64), (51200, 128, 255), (777, 130, 70),
              (300, 200, 40), (129, 72, 136)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", MMA_SHAPES)
@pytest.mark.parametrize("w_kind", ["int8", "bfloat16"])
def test_mma_route_matches_plain_on_card(cuda, m, k, n, w_kind):
    """bf16 x with int8 or bf16 w (the tensor cores): f32 and bf16 out,
    with and without bias, against the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=gen, device=cuda).bfloat16()
    w = torch.randn(k, n, generator=gen, device=cuda) / k ** 0.5
    b = 0.1 * torch.randn(n, generator=gen, device=cuda)
    q = quantize_per_channel(w.cpu().numpy(), axis=1)
    wq, scale = q.data.to(cuda), q.scale.to(cuda)
    wb = w.bfloat16()
    before = tmm.launches
    for out in (torch.float32, torch.bfloat16):
        for bias, act in ((b, "silu"), (None, None)):
            if w_kind == "int8":
                got = tmm.matmul_int8w(x, wq, scale, bias, act,
                                       out_dtype=out)
                torch.cuda.synchronize()
                ref = tmm.matmul_int8w_ref(x, wq, scale, bias, act,
                                           out_dtype=out)
            else:
                got = tmm.matmul(x, wb, bias, act, out_dtype=out)
                torch.cuda.synchronize()
                ref = tmm.matmul_ref(x, wb, bias, act, out_dtype=out)
            _assert_close(got, ref)
            del got, ref
    assert tmm.launches - before == 4


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 4])
def test_mma_route_misaligned_views_on_card(cuda, offset):
    """x, w and out at element offsets off 16 bytes (contiguous views into
    a larger buffer): the element-staged loads and stores."""
    m, k, n = 300, 256, 128
    gen = torch.Generator(device=cuda).manual_seed(offset)
    xs = torch.randn(m * k + offset, generator=gen, device=cuda).bfloat16()
    x = xs[offset:].view(m, k)
    w = torch.randn(k, n, generator=gen, device=cuda) / k ** 0.5
    q = quantize_per_channel(w.cpu().numpy(), axis=1)
    wbuf = torch.empty(k * n + offset, dtype=torch.int8, device=cuda)
    wq = wbuf[offset:].view(k, n)
    wq.copy_(q.data.to(cuda))
    scale = q.scale.to(cuda)
    wb = torch.empty(k * n + offset, dtype=torch.bfloat16, device=cuda)
    wbv = wb[offset:].view(k, n)
    wbv.copy_(w)
    got = tmm.matmul_int8w(x, wq, scale, None, "relu")
    torch.cuda.synchronize()
    _assert_close(got, tmm.matmul_int8w_ref(x, wq, scale, None, "relu"))
    got = tmm.matmul(x, wbv, None, "relu", out_dtype=torch.float32)
    torch.cuda.synchronize()
    _assert_close(got, tmm.matmul_ref(x, wbv, None, "relu",
                                      out_dtype=torch.float32))


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(cuda):
    """fp32 int8w YOLOv5s through the kernel on the card against the
    plain versions on the CPU; 22 launches per forward."""
    x = np.random.default_rng(0).standard_normal(
        (2, 64, 64, 3)).astype(np.float32) / 3
    outs = {}
    for dev in ("cuda", "cpu"):
        graph, in_name, out_name = build_yolov5("s", batch=2, image_size=64)
        eng = Engine(EngineConfig(device=dev, quant="int8w",
                                  use_kernels=True))
        eng.load_model(None, graph=graph)
        before = tmm.launches
        outs[dev] = eng.run({in_name: x})[out_name]
        if dev == "cuda":
            assert tmm.launches - before == 22
    scale = max(1.0, float(np.abs(outs["cpu"]).max()))
    np.testing.assert_allclose(outs["cuda"], outs["cpu"],
                               atol=1e-4 * scale, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,group", [
    (1, 200, 70, 128), (16, 2048, 96, 128), (37, 129, 131, 64),
    (100, 256, 50, 32), (15, 5456, 33, 128), (16, 5456, 512, 128),
    (17, 5456, 5456, 128), (24576, 2048, 512, 128), (1, 2048, 5456, 128),
    (40, 96, 48, 6)])
def test_int4w_kernel_matches_plain_on_card(cuda, m, k, n, group):
    """matmul_int4w, f32 and bf16 x: the split-K decode route (M <= 16)
    and the prefill tiles on the tensor cores for bf16, the CUDA-core
    kernels for f32 (and a group that is no multiple of 32); the llama
    down projection's K = 5456 (a last group of 64 live high and 16 live
    low rows), ragged M and N (narrower staging loads)."""
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k), dtype=np.float32)
    w = rng.standard_normal((k, n), dtype=np.float32) / np.sqrt(k)
    b = torch.from_numpy(0.1 * rng.standard_normal(n).astype(np.float32))
    q = quantize_int4_grouped(w, group=group).to(cuda)
    before = tmm.launches_int4w
    for dtype in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(cuda, dtype)
        for bias, act, out in ((None, None, dtype),
                               (b.to(cuda, dtype), "silu", torch.float32)):
            with fp32_parity(True):
                got = tmm.matmul_int4w(xt, q, bias, act, out_dtype=out)
                torch.cuda.synchronize()
                _assert_close(got, tmm.matmul_int4w_ref(xt, q, bias, act,
                                                        out_dtype=out))
    assert tmm.launches_int4w - before == 4


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(16, 2048, 2048), (16, 5456, 2048),
                                   (15, 2048, 32000), (5, 200, 70)])
def test_int4w_decode_split_k_reruns_bit_equal(cuda, m, k, n):
    """The bf16 decode route sums its K slices in a fixed order: the
    same call gives the same bits every time."""
    rng = np.random.default_rng(m + k + n)
    w = rng.standard_normal((k, n), dtype=np.float32) / np.sqrt(k)
    q = quantize_int4_grouped(w, group=128).to(cuda)
    x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).to(
        cuda, torch.bfloat16)
    first = tmm.matmul_int4w(x, q, out_dtype=torch.float32)
    for _ in range(3):
        assert torch.equal(tmm.matmul_int4w(x, q, out_dtype=torch.float32),
                           first)


def _flash_bf16_lim(q, k, v, ref, causal, sw):
    """chip_smoke's flash bf16 limit: 1e-4 x max(1, |ref|) + one bf16 ulp
    + 2 x 2^-8 sum_j p_j |v_j| (P rounded to bf16 on both sides, each
    moving the output by at most 2^-8 sum_j p_j |v_j|)."""
    return (1e-4 * max(1.0, float(ref.float().abs().max()))
            + 2.0 ** -7 * ref.float().abs()
            + 2.0 ** -7 * kattn.flash_attention_ref(
                q.float(), k.float(), v.float().abs(), causal=causal,
                sliding_window=sw))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,lq,lk,d,causal,sw", [
    (2, 3, 100, 100, 24, True, None), (1, 4, 77, 130, 64, False, None),
    (2, 2, 300, 300, 64, True, 50), (1, 2, 129, 129, 128, True, None),
    (1, 2, 200, 200, 256, False, None), (1, 2, 300, 300, 256, True, 64),
    (2, 2, 260, 260, 128, True, 100), (1, 3, 150, 150, 20, True, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_on_card(cuda, b, h, lq, lk, d, causal,
                                            sw, dtype):
    """f32 (CUDA cores) and bf16 (tensor cores): head dims 20 / 24
    (padded to 32; 20 stages with narrow loads), 64, 128 and 256,
    causal, non-causal with Lq != Lk, banded."""
    gen = torch.Generator(device=cuda).manual_seed(lq + d)
    q, k, v = (torch.randn(b, h, l_, d, generator=gen, device=cuda).to(dtype)
               for l_ in (lq, lk, lk))
    before = kattn.launches
    with fp32_parity(True):
        got = kattn.flash_attention(q, k, v, causal=causal, sliding_window=sw)
        torch.cuda.synchronize()
        ref = kattn.flash_attention_ref(q, k, v, causal=causal,
                                        sliding_window=sw)
    assert kattn.launches - before == 1 and got.dtype == ref.dtype
    if dtype == torch.float32:
        _assert_close(got, ref)
    else:
        d_ = (got.float() - ref.float()).abs()
        lim = _flash_bf16_lim(q, k, v, ref, causal, sw)
        assert bool((d_ <= lim).all()), float((d_ / lim).max())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 24])
def test_flash_bf16_strided_views_on_card(cuda, d):
    """The rotary op's call: q, k, v transposed from [N, L, H, D] (L
    stride H*D), the output laid out [N, L, H, D] under its view."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    n, l_, h = 2, 320, 4
    q, k, v = (torch.randn(n, l_, h, d, generator=gen, device=cuda)
               .bfloat16().transpose(1, 2) for _ in range(3))
    got = kattn.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert got.stride(2) == h * d
    ref = kattn.flash_attention_ref(q, k, v, causal=True)
    d_ = (got.float() - ref.float()).abs()
    assert bool((d_ <= _flash_bf16_lim(q, k, v, ref, True, None)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
def test_decode_kernel_matches_plain_on_card(cuda, cache):
    """Lengths 0, 1, straddling a 64-position tile and full; the empty
    row gives o = 0, l = 0, m = -1e30."""
    from simpleinfer_tpu_torch.zoo.generate import _kv_quantize

    gen = torch.Generator(device=cuda).manual_seed(0)
    n, kvh, g, length, d = 5, 2, 4, 200, 64
    q = torch.randn(n, kvh, g, d, generator=gen, device=cuda)
    k, v = (torch.randn(n, kvh, length, d, generator=gen, device=cuda)
            for _ in range(2))
    if cache == "int8":
        k, v = _kv_quantize(k), _kv_quantize(v)
    else:
        k, v = k.bfloat16(), v.bfloat16()
    lens = torch.tensor([0, 1, 63, 65, 200], dtype=torch.int32, device=cuda)
    before = kdec.launches
    got = kdec.decode_attention(q, k, v, lens, scale=0.125)
    torch.cuda.synchronize()
    ref = kdec.decode_attention_ref(q, k, v, lens, scale=0.125)
    for a, r in zip(got[::2], ref[::2]):        # o and l
        _assert_close(a, r)
    o, m, l = got
    assert bool((o[0] == 0).all()) and bool((l[0] == 0).all())
    assert bool((m[0] == -1e30).all())
    _assert_close(m[1:], ref[1][1:])
    assert kdec.launches - before == 1


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["bfloat16", "int8", "float32"])
@pytest.mark.parametrize("block_k", [32, None])
def test_decode_split_route_matches_plain_on_card(cuda, cache, block_k):
    """The split over positions (block_k 32: 7 blocks a row at L 200, the
    most the bound gives; None: the default) at the lengths its shares
    make hard, and with a max_len under L; the empty row gives o = 0,
    l = 0, m = -1e30; two runs bit-equal (the splits merge in a fixed
    order); one launch counted per call."""
    from simpleinfer_tpu_torch.zoo.generate import _kv_quantize

    gen = torch.Generator(device=cuda).manual_seed(7)
    n, kvh, g, length, d = 8, 2, 4, 200, 64
    q = torch.randn(n, kvh, g, d, generator=gen, device=cuda).bfloat16()
    k, v = (torch.randn(n, kvh, length, d, generator=gen, device=cuda)
            for _ in range(2))
    if cache == "int8":
        k, v = _kv_quantize(k), _kv_quantize(v)
    else:
        k, v = k.to(getattr(torch, cache)), v.to(getattr(torch, cache))
    lens = torch.tensor([0, 1, 29, 31, 33, 64, 199, 200], dtype=torch.int32,
                        device=cuda)
    for max_len in (None, 100):
        want_lens = lens if max_len is None else torch.clamp(lens,
                                                             max=max_len)
        before = kdec.launches
        got = kdec.decode_attention(q, k, v, lens, scale=0.125,
                                    block_k=block_k, max_len=max_len)
        again = kdec.decode_attention(q, k, v, lens, scale=0.125,
                                      block_k=block_k, max_len=max_len)
        torch.cuda.synchronize()
        assert kdec.launches - before == 2
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        ref = kdec.decode_attention_ref(q, k, v, want_lens, scale=0.125)
        for a, r in zip(got[::2], ref[::2]):        # o and l
            _assert_close(a, r)
        o, m, l = got
        assert bool((o[0] == 0).all()) and bool((l[0] == 0).all())
        assert bool((m[0] == -1e30).all())
        _assert_close(m[1:], ref[1][1:])


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(100, 60, 50), (37, 129, 131),
                                   (300, 1152, 200), (129, 4608, 130),
                                   (1, 256, 255)])
def test_s8s8_layouts_and_views_on_card(cuda, m, k, n):
    """matmul_s8s8 with w row-major (copied K-major by the wrapper, and
    counted), K-major (no copy), and both operands at misaligned
    addresses (the element-staged route): the exact s32 sums (unit
    scale, f32 out) and the silu / bf16 epilogue against the plain
    version."""
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    xq = torch.randint(-127, 128, (m, k), generator=gen, device=cuda,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, n), generator=gen, device=cuda,
                       dtype=torch.int8)

    def offset(t, rows, cols):
        buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=cuda)
        view = buf[1:1 + t.numel()].view(rows, cols)
        view.copy_(t)
        return view

    exact = (xq.double() @ wq.double()).float()
    sc = torch.rand(n, generator=gen, device=cuda) * 1e-3
    b = torch.randn(n, generator=gen, device=cuda)
    for x, w, copies in ((xq, wq, 1), (xq, tmm.to_k_major(wq), 0),
                         (offset(xq, m, k), offset(wq.t(), n, k).t(), 0)):
        before = tmm.transposes_s8s8
        got = tmm.matmul_s8s8(x, w, torch.ones(n, device=cuda),
                              out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(got, exact)
        assert tmm.transposes_s8s8 - before == copies
        got = tmm.matmul_s8s8(x, w, sc, b, "silu")
        torch.cuda.synchronize()
        _assert_close(got, tmm.matmul_s8s8_ref(xq, wq, sc, b, "silu"))


@pytest.mark.cuda
def test_llama_int4w_on_card_matches_cpu(cuda):
    """fp32 int4w nano llama: logits on the card (matmul_int4w) against
    the plain versions on the CPU, and the greedy tokens of a scratch-
    block decode through the decode kernel equal."""
    ids = np.random.default_rng(1).integers(0, 64, (2, 32)).astype(
        np.float32)
    outs, toks = {}, {}
    for dev in ("cuda", "cpu"):
        graph, in_name, out_name = build_llama("nano", seq_len=32,
                                               vocab_size=64)
        eng = Engine(EngineConfig(device=dev, quant="int4w",
                                  use_kernels=True))
        eng.load_model(None, graph=graph)
        outs[dev] = eng.run({in_name: ids})[out_name]
        toks[dev] = CachedDecoder(eng, scratch_blocks=True,
                                  decode_attn="kernel").generate(
            ids[:, :8].astype(np.int64), steps=8, block=4)
    scale = max(1.0, float(np.abs(outs["cpu"]).max()))
    np.testing.assert_allclose(outs["cuda"], outs["cpu"], atol=1e-4 * scale,
                               rtol=1e-4)
    np.testing.assert_array_equal(toks["cuda"], toks["cpu"])


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", SHAPES + [(300, 1152, 200)])
def test_s8s8_kernel_matches_plain_on_card(cuda, m, k, n):
    """matmul_s8s8: the s32 sum exact (unit scale, f32 out), then the
    epilogue with vector and scalar scales, bias, SiLU, bf16 out."""
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    xq = torch.randint(-127, 128, (m, k), generator=gen, device=cuda,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, n), generator=gen, device=cuda,
                       dtype=torch.int8)
    before = tmm.launches_s8s8
    got = tmm.matmul_s8s8(xq, wq, torch.ones(n, device=cuda),
                          out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got, (xq.double() @ wq.double()).float())
    b = torch.randn(n, generator=gen, device=cuda)
    for scale, bias, act in ((torch.rand(n, generator=gen, device=cuda)
                              * 1e-3, b, "silu"),
                             (torch.tensor(1e-3), None, None)):
        got = tmm.matmul_s8s8(xq, wq, scale, bias, act)
        torch.cuda.synchronize()
        _assert_close(got, tmm.matmul_s8s8_ref(xq, wq, scale, bias, act))
    assert tmm.launches_s8s8 - before == 3


def _c3_case(cuda, n, h, w, c, hid, oc, t, s8, dtype):
    gen = torch.Generator(device=cuda).manual_seed(n * h + w + c + hid)

    def r(*s):
        return torch.randn(*s, generator=gen, device=cuda) * 0.2

    ws = [r(c, hid), r(hid), r(c, hid), r(hid), r(hid, oc), r(hid, oc),
          r(oc), r(t, hid, hid), r(t, hid), r(t, 9, hid, hid), r(t, hid)]
    scale = None
    if s8:
        wq, wsc = kc3.quantize_taps(ws[9].cpu().numpy())
        ws[9], scale = (torch.from_numpy(wq).to(cuda),
                        torch.from_numpy(wsc).to(cuda))
    return r(n, h, w, c).to(dtype), ws, scale


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,hid,oc,t,shortcut", [
    (2, 9, 7, 16, 8, 16, 2, True), (2, 32, 24, 16, 8, 16, 2, False),
    (3, 20, 20, 64, 72, 48, 1, False), (1, 16, 16, 128, 64, 128, 3, True)])
@pytest.mark.parametrize("s8", [False, True], ids=["fp", "s8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_c3_kernel_matches_plain_on_card(cuda, n, h, w, c, hid, oc, t,
                                         shortcut, s8, dtype):
    x, ws, scale = _c3_case(cuda, n, h, w, c, hid, oc, t, s8, dtype)
    before = kc3.launches
    with fp32_parity(True):
        got = kc3.c3_block(x, *ws, btl_b_scale=scale, shortcut=shortcut)
        torch.cuda.synchronize()
        ref = kc3.c3_block_reference(x, *ws, btl_b_scale=scale,
                                     shortcut=shortcut)
    assert kc3.launches - before == 1 and got.dtype == ref.dtype
    got, ref = got.float().cpu(), ref.float().cpu()
    d = (got - ref).abs()
    scale_ = max(1.0, float(ref.abs().max()))
    assert bool(torch.isfinite(got).all())
    if dtype == torch.float32 and not s8:
        assert bool((d <= 1e-5 * scale_).all()), float(d.max())
    else:
        assert float(d.max()) <= 0.05 * scale_, float(d.max())
        assert float(d.mean()) <= 5e-4 * scale_, float(d.mean())


def _c3_check(got, ref, exact):
    got, ref = got.float().cpu(), ref.float().cpu()
    d = (got - ref).abs()
    scale_ = max(1.0, float(ref.abs().max()))
    assert bool(torch.isfinite(got).all())
    if exact:
        assert bool((d <= 1e-5 * scale_).all()), float(d.max())
    else:
        assert float(d.max()) <= 0.05 * scale_, float(d.max())
        assert float(d.mean()) <= 5e-4 * scale_, float(d.mean())


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,hid,oc,t,shortcut", [
    (3, 7, 9, 32, 24, 16, 1, True), (2, 13, 11, 40, 40, 48, 3, False),
    (2, 12, 12, 64, 64, 64, 3, True), (1, 9, 9, 24, 72, 40, 1, False),
    (4, 5, 6, 16, 16, 24, 3, True), (2, 11, 10, 48, 56, 24, 1, True)])
@pytest.mark.parametrize("s8", [False, True], ids=["fp", "s8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_c3_kernel_edges_on_card(cuda, n, h, w, c, hid, oc, t, shortcut,
                                 s8, dtype):
    """c3_block at the tiles' edges: M off the 128-row tile, tiles
    straddling two or more images (the per-image s8 scale), hid of 16 to
    72 that no tile divides (hid off 16: the s8 taps' element staging),
    T 1 and 3, both shortcut forms; the tensor-core route in bf16 (with
    bf16 biases, as an engine places them) and the f32-FMA tile in
    f32."""
    x, ws, scale = _c3_case(cuda, n, h, w, c, hid, oc, t, s8, dtype)
    if dtype == torch.bfloat16:     # biases as an engine places them
        for i in (1, 3, 6, 8, 10):
            ws[i] = ws[i].to(torch.bfloat16)
    before, tc_before = kc3.launches, kc3.tc_launches
    with fp32_parity(True):
        got = kc3.c3_block(x, *ws, btl_b_scale=scale, shortcut=shortcut)
        torch.cuda.synchronize()
        ref = kc3.c3_block_reference(x, *ws, btl_b_scale=scale,
                                     shortcut=shortcut)
    assert kc3.launches - before == 1 and got.dtype == ref.dtype
    assert kc3.tc_launches - tc_before == int(dtype == torch.bfloat16)
    _c3_check(got, ref, dtype == torch.float32 and not s8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_c3_kernel_zero_activation_image_on_card(cuda, dtype):
    """s8 taps where one image's bottleneck activation is all zero (ReLU
    below a negative bias): its abs-max is 0, the scale the 1e-8 floor,
    its taps sum to 0; the other images keep their own scales."""
    n, h, w, c, hid, oc, t = 3, 10, 9, 32, 64, 32, 2
    x, ws, scale = _c3_case(cuda, n, h, w, c, hid, oc, t, True, dtype)
    x = (x.float() * 5).to(dtype)
    x[0] = 0
    ws[8] = ws[8] - 1.5          # the bottleneck 1x1's bias
    kw = dict(btl_b_scale=scale, activation="relu", shortcut=True)
    with fp32_parity(True):
        got = kc3.c3_block(x, *ws, **kw)
        torch.cuda.synchronize()
        ref = kc3.c3_block_reference(x, *ws, **kw)
    _c3_check(got, ref, False)
    y1 = torch.relu(x[0].float() @ ws[0].to(dtype).float() + ws[1])
    a = torch.relu(y1.to(dtype).float() @ ws[7][0].to(dtype).float()
                   + ws[8][0])
    assert float(a.abs().max()) == 0.0      # the case holds
    _c3_check(got[0], ref[0], False)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,oc", [
    (2, 1, 1, 3, 5), (2, 5, 7, 13, 17), (1, 3, 33, 70, 131),
    (2, 14, 14, 256, 256), (3, 9, 11, 64, 64), (3, 5, 7, 129, 66),
    (16, 56, 56, 64, 64), (16, 28, 28, 128, 128), (32, 7, 7, 512, 512),
    (4, 160, 160, 32, 32), (8, 20, 20, 256, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_kernel_matches_plain_on_card(cuda, n, h, w, c, oc, dtype):
    """conv3x3_s1_same: H x W down to 1 x 1, C and OC off the tiles
    (element-staged x, w and out on the bf16 route), images across a
    tile, the ResNet-50 and YOLOv5s widths, with and without bias,
    three activations."""
    gen = torch.Generator(device=cuda).manual_seed(n * h + w + c + oc)
    x = torch.randn(n, h, w, c, generator=gen, device=cuda).to(dtype)
    wt = torch.randn(3, 3, c, oc, generator=gen, device=cuda) / (3 * c ** 0.5)
    b = 0.1 * torch.randn(oc, generator=gen, device=cuda)
    before = kconv.launches
    for bias in (b, None):
        for act in ("silu", "relu", None):
            with fp32_parity(True):
                got = kconv.conv3x3_s1_same(x, wt, bias, act)
                torch.cuda.synchronize()
                _assert_close(got, kconv.conv3x3_s1_same_ref(x, wt, bias,
                                                             act))
    assert kconv.launches - before == 6


@pytest.mark.cuda
def test_conv3x3_misaligned_view_on_card(cuda):
    """bf16 x at an element offset off 16 bytes: element-staged rows."""
    n, h, w, c, oc = 2, 9, 11, 64, 96
    gen = torch.Generator(device=cuda).manual_seed(5)
    buf = torch.randn(n * h * w * c + 3, generator=gen,
                      device=cuda).bfloat16()
    x = buf[3:].view(n, h, w, c)
    wt = torch.randn(3, 3, c, oc, generator=gen, device=cuda) / (3 * c ** 0.5)
    b = 0.1 * torch.randn(oc, generator=gen, device=cuda)
    got = kconv.conv3x3_s1_same(x, wt, b, "silu")
    torch.cuda.synchronize()
    _assert_close(got, kconv.conv3x3_s1_same_ref(x, wt, b, "silu"))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(300, 1152, 200), (100352, 1152, 128),
                                   (25088, 2304, 256), (128, 2048, 1000),
                                   (17, 64, 8)])
def test_int_mm_route_bit_equal_on_card(cuda, m, k, n):
    """Static int8 with kernels off: torch._int_mm's s32 product with
    matmul_s8s8_ref's epilogue is bit-equal to the float64 one (both are
    the exact sums, rounded once to f32), vector and scalar scales."""
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    xq = torch.randint(-127, 128, (m, k), generator=gen, device=cuda,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, n), generator=gen, device=cuda,
                       dtype=torch.int8)
    assert oconv.int_mm_ok(xq, wq)
    assert torch.equal(oconv.s8_product(xq, wq).double(),
                       xq.double() @ wq.double())
    b = torch.randn(n, generator=gen, device=cuda)
    for scale, bias, act, od in (
            (torch.rand(n, generator=gen, device=cuda) * 1e-3, b, "silu",
             torch.bfloat16),
            (torch.tensor(1e-3, device=cuda), None, None, torch.float32)):
        got = oconv.matmul_s8s8_library(xq, wq, scale, bias, act, od)
        assert torch.equal(got, tmm.matmul_s8s8_ref(xq, wq, scale, bias,
                                                    act, od))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,hid,oc,t,shortcut", [
    (2, 9, 7, 16, 8, 16, 2, True), (3, 20, 20, 64, 72, 48, 1, False),
    (1, 16, 16, 128, 64, 128, 3, True), (16, 80, 80, 256, 128, 256, 3,
                                         False)])
@pytest.mark.parametrize("s8", [False, True], ids=["fp", "s8"])
def test_c3_chain_within_c3_limit_on_card(cuda, n, h, w, c, hid, oc, t,
                                          shortcut, s8):
    """The bf16 C3 chain of the card (bf16 operands on the library, the
    s8 taps through torch._int_mm) against c3_block_reference: within
    c3_block's bf16 limit, max 0.05 x scale, mean 5e-4 x scale."""
    x, ws, scale = _c3_case(cuda, n, h, w, c, hid, oc, t, s8,
                            torch.bfloat16)
    got = oc3.c3_chain(x, *ws, btl_b_scale=scale, shortcut=shortcut)
    ref = kc3.c3_block_reference(x, *ws, btl_b_scale=scale,
                                 shortcut=shortcut)
    assert got.dtype == ref.dtype == torch.bfloat16
    d = (got.float() - ref.float()).abs()
    scale_ = max(1.0, float(ref.float().abs().max()))
    assert bool(torch.isfinite(got.float()).all())
    assert float(d.max()) <= 0.05 * scale_, float(d.max())
    assert float(d.mean()) <= 5e-4 * scale_, float(d.mean())


@pytest.mark.cuda
@pytest.mark.parametrize("n,oc", [(1, 32), (2, 64), (1, 24)])
def test_stem_kernel_matches_plain_on_card(cuda, n, oc):
    """stem_s2d on the packed input of a seeded image: lanes -1 / 320
    and the staged pad rows, OC of 32, 64 and one off the tile."""
    rng = np.random.default_rng(n + oc)
    img = rng.random((n, 640, 640, 3)).astype(np.float32)
    w = (rng.standard_normal((oc, 3, 6, 6)) / 10).astype(np.float32)
    xp = torch.from_numpy(kstem.pack_stem_input(img)).to(cuda, torch.bfloat16)
    wp = torch.from_numpy(kstem.pack_stem_weights(w)).to(cuda)
    bias = torch.from_numpy(0.05 * rng.standard_normal(oc).astype(
        np.float32)).to(cuda)
    before = kstem.launches
    for act in ("silu", None):
        got = kstem.stem_s2d(xp, wp, bias, act)
        torch.cuda.synchronize()
        assert got.shape == (n, 320, 320, oc)
        _assert_close(got, kstem.stem_s2d_ref(xp, wp, bias, act))
    assert kstem.launches - before == 2


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("oc", [16, 32, 48, 64])
@pytest.mark.parametrize("act", [None, "silu", "relu"])
def test_stem_kernel_widths_on_card(cuda, n, oc, act):
    """stem_s2d at every tile width it takes (an n8 tile per 8 channels,
    16 to 64), one and two images, three activations, w_packed in f32 and
    bf16 (read as given: the kernel rounds f32 to bf16 as it stages it)."""
    rng = np.random.default_rng(7 * n + oc)
    img = rng.random((n, 640, 640, 3)).astype(np.float32)
    w = (rng.standard_normal((oc, 3, 6, 6)) / 10).astype(np.float32)
    xp = torch.from_numpy(kstem.pack_stem_input(img)).to(cuda, torch.bfloat16)
    wp = torch.from_numpy(kstem.pack_stem_weights(w)).to(cuda)
    bias = torch.from_numpy(0.05 * rng.standard_normal(oc).astype(
        np.float32)).to(cuda)
    before = kstem.launches
    for wd in (torch.float32, torch.bfloat16):
        got = kstem.stem_s2d(xp, wp.to(wd), bias, act)
        torch.cuda.synchronize()
        assert got.shape == (n, 320, 320, oc)
        _assert_close(got, kstem.stem_s2d_ref(xp, wp.to(wd), bias, act))
    assert kstem.launches - before == 2


# ---- the detection pipeline's device side (zoo/detect.py) --------------
def _planted_head(n, m, nc, seed, head="v5"):
    """chip_smoke's planted head: clusters of partly overlapping boxes
    with exact score ties, over background rows under the 0.25
    threshold."""
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke.planted_head(n, m, nc, seed=seed, head=head)


@pytest.mark.cuda
@pytest.mark.parametrize("head", ["v5", "v8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("class_agnostic", [False, True],
                         ids=["classwise", "agnostic"])
def test_decode_device_on_card_equals_cpu(cuda, head, dtype, class_agnostic):
    """decode_device on the card gives the CPU's rows (the same stable
    sorts and f32 arithmetic): indices and classes equal, boxes within
    1e-6 x max(1, |box|), at least 40 kept rows."""
    from simpleinfer_tpu_torch.zoo.detect import decode_device

    pred = torch.from_numpy(_planted_head(2, 3000, 20, 7, head)).to(dtype)
    want = decode_device(pred, head=head, class_agnostic=class_agnostic)
    got = decode_device(pred.to(cuda), head=head,
                        class_agnostic=class_agnostic).cpu()
    assert got.shape == want.shape == (2, 300, 6)
    assert int((want[..., 4] >= 0).sum()) >= 40
    assert torch.equal(got[..., 4:], want[..., 4:])
    assert ((got[..., :4] - want[..., :4]).abs()
            <= 1e-6 * want[..., :4].abs().clamp(min=1)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("max_keep", [5, 64, 300])
def test_nms_device_on_card_equals_cpu(cuda, max_keep):
    """nms_device on the card: the CPU's indices, -1 padded, for
    distinct and all-tied scores."""
    from simpleinfer_tpu_torch.zoo.detect import nms_device

    rng = np.random.default_rng(max_keep)
    xy = rng.uniform(0, 300, (3, 256, 2)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate(
        [xy, xy + rng.uniform(10, 80, (3, 256, 2)).astype(np.float32)], -1))
    for scores in (torch.from_numpy(rng.uniform(0, 1, (3, 256))
                                    .astype(np.float32)),
                   torch.full((3, 256), 0.5)):
        want = nms_device(boxes, scores, 0.45, max_keep)
        got = nms_device(boxes.to(cuda), scores.to(cuda), 0.45,
                         max_keep).cpu()
        assert torch.equal(got, want)
        assert int((want >= 0).sum()) >= 3


@pytest.mark.cuda
def test_engine_temp_bytes_on_card(cuda):
    """temp_bytes rises with the batch; warmup keeps the staged inputs."""
    g, in_name, out_name = build_yolov5("n", batch=1, image_size=64)
    eng = Engine(EngineConfig(compute_dtype="bfloat16", quant="int8w"))
    eng.load_model(None, graph=g)
    eng.warmup((1, 2, 4))
    t = [eng.temp_bytes(b) for b in (1, 2, 4)]
    assert 0 < t[0] < t[1] < t[2]


# ---- the CNN service's host waits (serving/batcher.py, Engine.input) -----
# a queued kernel of ~0.2 s at H100 clocks: far longer than the host work
# of a small model's input, dispatch or resolve
SPIN_CYCLES = 400_000_000


def _yolo_n(cuda, compute="bfloat16"):
    g, in_name, out_name = build_yolov5("n", batch=1, image_size=64)
    eng = Engine(EngineConfig(compute_dtype=compute, quant="int8w"))
    return eng.load_model(None, graph=g), in_name, out_name


@pytest.mark.cuda
def test_engine_input_of_a_pinned_tensor_does_not_wait(cuda):
    """Engine.input of a pinned tensor is queued behind the work on the
    stream and returns while it runs; a numpy array's copy waits for it.
    Both stage the same values."""
    eng, in_name, out_name = _yolo_n(cuda)
    x = np.random.default_rng(0).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    pinned = torch.empty(x.shape, dtype=torch.float32, pin_memory=True)
    pinned.numpy()[:] = x
    eng.input(in_name, pinned)
    eng.forward()
    torch.cuda.synchronize()
    for arr, waits in ((pinned, False), (x, True)):
        eng.forward()
        torch.cuda._sleep(SPIN_CYCLES)
        mark = torch.cuda.Event()
        mark.record()
        eng.input(in_name, arr)
        assert mark.query() is waits
        torch.cuda.synchronize()
        staged = eng._staged[in_name]
        assert staged.dtype == torch.bfloat16
        assert torch.equal(staged.cpu(), torch.from_numpy(x).bfloat16())


@pytest.mark.cuda
def test_dispatch_and_resolve_do_not_wait_for_later_batches(cuda):
    """BatchingService on the card: _dispatch returns while its forward
    is still queued behind a long kernel, and _resolve(N) waits on batch
    N's event only, not on batch N + 1's forward (still queued when it
    returns); each future gets its own batch's rows (fp32: within
    1e-4 x scale of one forward over all items)."""
    from simpleinfer_tpu_torch.serving import BatchingService, Request

    eng, in_name, out_name = _yolo_n(cuda, "float32")
    rng = np.random.default_rng(1)
    items = [rng.standard_normal((64, 64, 3)).astype(np.float32) / 3
             for _ in range(8)]
    svc = BatchingService(eng, max_batch=4)
    for it in items + items[:4]:
        svc._q.put(Request(it))
    warm, first, second = svc._gather(), svc._gather(), svc._gather()
    svc._resolve(svc._dispatch(warm, 0))
    a = svc._dispatch(first, 0)
    torch.cuda._sleep(SPIN_CYCLES)
    b = svc._dispatch(second, 0)
    assert a[2] is not None and not b[2].query()
    svc._resolve(a)
    assert not b[2].query()
    svc._resolve(b)
    want = eng.run({in_name: np.stack(items)})[out_name]
    for reqs, rows in ((first, want[4:]), (second, want[:4])):
        got = np.stack([r.future.result(timeout=60) for r in reqs])
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, rows, atol=1e-4 * max(
            1.0, float(np.abs(rows).max())), rtol=1e-4)


def _nms_rounds_per_round(boxes, scores, iou_thresh=0.45):
    """nms_rounds as it was with a host check after every round."""
    order = torch.sort(-scores, dim=-1, stable=True).indices
    b = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    x1 = torch.maximum(b[:, :, None, 0], b[:, None, :, 0])
    y1 = torch.maximum(b[:, :, None, 1], b[:, None, :, 1])
    x2 = torch.minimum(b[:, :, None, 2], b[:, None, :, 2])
    y2 = torch.minimum(b[:, :, None, 3], b[:, None, :, 3])
    inter = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    area = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    iou = inter / torch.clamp(area[:, :, None] + area[:, None, :] - inter,
                              min=1e-9)
    k = scores.shape[-1]
    above = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    sup = ((iou > iou_thresh) & above).to(torch.float32)
    valid = torch.gather(scores, 1, order) >= 0
    keep, rounds = valid, 0
    while True:
        rounds += 1
        hit = torch.bmm(keep.to(torch.float32)[:, None, :], sup)[:, 0]
        new = valid & (hit == 0)
        if torch.equal(new, keep):
            return order, keep, rounds
        keep = new


@pytest.mark.cuda
@pytest.mark.parametrize("head", ["v5", "v8"])
def test_nms_rounds_checked_every_few_rounds_equals_per_round_on_card(
        cuda, head):
    """nms_rounds with a host check every NMS_ROUNDS_PER_CHECK rounds
    gives the per-round loop's order, keep flags and round count, bit
    for bit, on the planted head's class-offset boxes."""
    from simpleinfer_tpu_torch.zoo import detect

    pred = torch.from_numpy(_planted_head(2, 4000, 80, 5, head)).to(cuda)
    p = pred.float()
    cls = p[..., 4:] if head == "v8" else p[..., 5:] * p[..., 4:5]
    score, cid = cls.amax(-1), cls.argmax(-1)
    score = torch.where(score >= 0.25, score, torch.full_like(score, -1.0))
    score, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    score, idx = score[:, :1024], idx[:, :1024]
    xywh = torch.gather(p[..., :4], 1, idx[..., None].expand(-1, -1, 4))
    half = xywh[..., 2:] / 2
    boxes = torch.cat([xywh[..., :2] - half, xywh[..., :2] + half], -1)
    boxes = boxes + torch.gather(cid, 1, idx)[..., None].float() * \
        detect.CLASS_OFFSET
    got = detect.nms_rounds(boxes, score)
    want = _nms_rounds_per_round(boxes, score)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2] == want[2] >= 2
    assert int(got[1].sum()) >= 100


# ---- the attention lineages (GPT, sliding windows, softcap, ALiBi) ----------
LINEAGES = {
    "gpt": ("build_gpt", dict(variant="nano", seq_len=64, vocab_size=64)),
    "swa": ("build_llama", dict(variant="nano", seq_len=128, vocab_size=64,
                                sliding_window=8)),
    "gemma2ish": ("build_llama", dict(variant="nano", seq_len=128,
                                      vocab_size=64, attn_scale=0.3,
                                      logit_softcap=25.0, sliding_window=8,
                                      sliding_pattern="alternate")),
    "bloom": ("build_bloom", dict(variant="nano", seq_len=64,
                                  vocab_size=64)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LINEAGES))
def test_lineage_decode_card_vs_cpu(cuda, name, monkeypatch):
    """fp32 int4w decoders of each lineage, the gates lowered so the
    causal / banded flash kernel runs the prefill where the op allows
    it: prefill logits on the card (kernels; the decode kernel for GPT)
    within 1e-4 x scale of the CPU's (plain versions), greedy tokens over
    a ring for the sliding models equal."""
    from simpleinfer_tpu_torch import zoo

    for key in ("SI_FLASH_MIN_LK", "SI_FLASH_MIN_LQ", "SI_FLASH_BAND_MIN_LK",
                "SI_FLASH_BAND_MIN_LQ"):
        monkeypatch.setenv(key, "32")
    fn, kw = LINEAGES[name]
    window = kw["seq_len"]
    rng = np.random.default_rng(2)
    tokens = np.zeros((2, window), np.float32)
    lengths = np.array([window - 20, 9])
    for i, p in enumerate(lengths):
        tokens[i, :p] = rng.integers(0, 64, p)
    prompt = rng.integers(0, 64, (2, window - 30))
    logits, toks = [], []
    for dev, uk in ((cuda, None), (torch.device("cpu"), True)):
        eng = Engine(EngineConfig(device=str(dev), quant="int4w",
                                  use_kernels=uk)).load_model(
            None, graph=getattr(zoo, fn)(**kw)[0])
        dec = CachedDecoder(eng, scratch_blocks=True,
                            decode_attn="kernel" if name == "gpt"
                            else "torch")
        logits.append(dec.prefill(tokens, lengths)[0].cpu())
        toks.append(dec.generate(prompt, steps=12, block=4))
    scale = max(1.0, float(logits[1].abs().max()))
    assert float((logits[0] - logits[1]).abs().max()) <= 1e-4 * scale
    np.testing.assert_array_equal(toks[0], toks[1])


@pytest.mark.cuda
@pytest.mark.parametrize("sw", [16, 64, 200])
def test_banded_flash_on_projection_views(cuda, sw):
    """The banded kernel on what a sliding prefill hands it: [N, H, L, D]
    views of [N, L, H, D] projections, rows padded past each prompt,
    bf16 and f32, against its plain version."""
    rng = np.random.default_rng(sw)
    n, length, h, d = 3, 256, 4, 64
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (n, length, h, d)).astype(np.float32)).to(cuda, dtype)
            .transpose(1, 2) for _ in range(3))
        got = kattn.flash_attention(q, k, v, causal=True, sliding_window=sw)
        ref = kattn.flash_attention_ref(q, k, v, causal=True,
                                        sliding_window=sw)
        torch.cuda.synchronize(cuda)
        lim = 1e-4 * max(1.0, float(ref.float().abs().max()))
        if dtype == torch.bfloat16:     # P's bf16 roundoff, both sides
            lim = lim + 2.0 ** -7 * kattn.flash_attention_ref(
                q.float(), k.float(), v.float().abs(), causal=True,
                sliding_window=sw) + 2.0 ** -7 * ref.float().abs()
        assert bool(((got.float() - ref.float()).abs() <= lim).all())


@pytest.mark.cuda
def test_mha_noncausal_flash_on_card(cuda, monkeypatch):
    """nn.MultiheadAttention past the non-causal gate (lowered here) runs
    the flash kernel non-causally on the card and matches the CPU
    port."""
    from simpleinfer_tpu_torch.zoo import build_vit

    monkeypatch.setenv("SI_FLASH_MIN_LK_NC", "16")
    monkeypatch.setenv("SI_FLASH_MIN_LQ", "16")
    kw = dict(variant="tiny", batch=2, image_size=32, patch_size=8,
              num_classes=6, depth=2, embed_dim=32, num_heads=4)
    x = np.random.default_rng(0).standard_normal(
        (2, 32, 32, 3)).astype(np.float32) / 3
    outs = []
    before = kattn.launches
    for dev in (cuda, torch.device("cpu")):
        eng = Engine(EngineConfig(device=str(dev), use_kernels=True)
                     ).load_model(None, graph=build_vit(**kw)[0])
        with fp32_parity(True):
            outs.append(eng.run({eng.input_names[0]: x})[
                eng.output_names[0]])
    assert kattn.launches - before == 2            # one per layer
    scale = max(1.0, float(np.abs(outs[1]).max()))
    assert float(np.abs(outs[0] - outs[1]).max()) <= 1e-4 * scale
