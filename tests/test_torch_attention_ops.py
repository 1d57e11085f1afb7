"""The port's attention op lowerings (simpleinfer_tpu_torch/ops/attention.py)
against the JAX package's, on the CPU, on the same seeded numpy inputs:
torch.matmul / torch.bmm, torch.select, F.scaled_dot_product_attention
(both mask modes, is_causal with Lq == Lk and Lq != Lk),
nn.MultiheadAttention (packed and separate projections, kdim / vdim,
batch_first false, 2-D and 3-D masks, bool and float, the trailing-
operand mask rule, the head-averaged weights output) and the
si.RotaryAttention options (sliding_window, logit_softcap, alibi,
alibi_scale, an alibi_slopes attr), with the kernels' plain versions
where the port's gates send a call to flash_attention (the JAX package's
Pallas kernels are off on the CPU: its XLA paths).

Tolerances, with scale = max(1, max|ref|): shape ops (select) bit-equal;
attention and products 1e-5 x scale (the same f32 math, sums in another
order).
"""
import jax  # noqa: F401  (both frameworks in one process, JAX on CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleinfer_tpu.config import EngineConfig as JCfg
from simpleinfer_tpu.ir import graph as jgraph
from simpleinfer_tpu.ops import attention as jattn
from simpleinfer_tpu.ops import lower_operator as jlower
from simpleinfer_tpu_torch import kernels
from simpleinfer_tpu_torch.config import EngineConfig as TCfg
from simpleinfer_tpu_torch.ir import graph as tgraph
from simpleinfer_tpu_torch.ops import attention as tattn
from simpleinfer_tpu_torch.ops import lower_operator as tlower

OP_TOL = 1e-5


def make_ops(type_, params=None, attrs=None, n_out=1):
    """The same pnnx Operator in both packages' IR, with n_out outputs."""
    ops = []
    for g in (jgraph, tgraph):
        op = g.Operator(type=type_, name="t0")
        for k, v in (params or {}).items():
            op.params[k] = g.Parameter.from_value(v)
        for k, v in (attrs or {}).items():
            op.attrs[k] = g.Attribute.from_array(np.asarray(v, np.float32))
        op.outputs = [g.Operand(name=f"o{i}") for i in range(n_out)]
        ops.append(op)
    return ops


def run_both(type_, xs, params=None, attrs=None, n_out=1,
             use_kernels=None):
    """Lower the op in both packages and apply it to the numpy inputs
    `xs`; returns (port outputs, JAX outputs) as lists of numpy."""
    jop, top = make_ops(type_, params, attrs, n_out)
    jimpl = jlower(jop, JCfg())
    timpl = tlower(top, TCfg(device="cpu", use_kernels=use_kernels))
    got = timpl.apply(timpl.weights, *[torch.from_numpy(x) for x in xs])
    want = jimpl.apply({k: jnp.asarray(v) for k, v in jimpl.weights.items()},
                       *[jnp.asarray(x) for x in xs])
    as_list = (lambda r: list(r) if isinstance(r, tuple) else [r])
    return ([t.numpy() for t in as_list(got)],
            [np.asarray(a) for a in as_list(want)])


def close(got, want, tol=OP_TOL):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * max(
            1.0, float(np.abs(w).max())))


def rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---- matmul / bmm / select ---------------------------------------------------
@pytest.mark.parametrize("type_,a,b", [
    ("torch.matmul", (2, 5, 7), (2, 7, 3)),
    ("torch.matmul", (5, 7), (7, 4)),
    # rank 4: physical NHWC of logical [2, 3, 5, 6] @ [2, 3, 6, 4]
    ("torch.matmul", (2, 5, 6, 3), (2, 6, 4, 3)),
    ("torch.bmm", (3, 4, 8), (3, 8, 5))],
    ids=["matmul3", "matmul2", "matmul4", "bmm"])
def test_matmul_vs_jax(type_, a, b):
    close(*run_both(type_, [rand(*a, seed=1), rand(*b, seed=2)]))


@pytest.mark.parametrize("shape,dim,index", [
    ((2, 5, 7), 1, 0), ((2, 5, 7), -1, 3), ((2, 5, 7), 0, 1),
    # rank 4: physical NHWC (2, 3, 4, 5) is logical [2, 5, 3, 4]
    ((2, 3, 4, 5), 1, 2), ((2, 3, 4, 5), 3, 3), ((2, 3, 4, 5), -2, 1)],
    ids=["r3_cls", "r3_last", "r3_batch", "r4_ch", "r4_w", "r4_neg"])
def test_select_vs_jax(shape, dim, index):
    got, want = run_both("torch.select", [rand(*shape)],
                         dict(dim=dim, index=index))
    np.testing.assert_array_equal(got[0], want[0])


# ---- F.scaled_dot_product_attention -------------------------------------------
def _qkv(n=2, h=3, lq=6, lk=6, d=8, seed=0):
    # rank-4 [N, h, L, d] logical, physical NHWC [N, L, d, h]
    return [np.ascontiguousarray(rand(n, h, l_, d, seed=seed + i)
                                 .transpose(0, 2, 3, 1))
            for i, l_ in enumerate((lq, lk, lk))]


def _phys(m):
    return np.ascontiguousarray(m.transpose(0, 2, 3, 1))


@pytest.mark.parametrize("case", ["plain", "causal", "causal_lq_ne_lk",
                                  "scale", "bool_mask", "float_mask"])
def test_sdpa_vs_jax(case):
    lq = 4 if case == "causal_lq_ne_lk" else 6
    xs = _qkv(lq=lq)
    params = {}
    if case.startswith("causal"):
        params["is_causal"] = True
    if case == "scale":
        params["scale"] = 0.2
    if case == "bool_mask":   # True = attend; every row keeps a key
        m = np.random.default_rng(3).random((2, 3, 6, 6)) > 0.4
        m[..., 0] = True
        xs.append(_phys(m))
    if case == "float_mask":
        xs.append(_phys(rand(2, 3, 6, 6, seed=4)))
    close(*run_both("F.scaled_dot_product_attention", xs, params))


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_flash_path_vs_jax(monkeypatch, causal):
    """Past the gates (lowered here) a kernels-on SDPA goes through
    flash_attention (its plain version on the CPU), causal and not."""
    monkeypatch.setenv("SI_FLASH_MIN_LK", "8")
    monkeypatch.setenv("SI_FLASH_MIN_LK_NC", "8")
    monkeypatch.setenv("SI_FLASH_MIN_LQ", "8")
    calls = []
    orig = kernels.attention.flash_attention
    monkeypatch.setattr(kernels.attention, "flash_attention",
                        lambda *a, **k: calls.append(k) or orig(*a, **k))
    xs = _qkv(lq=16, lk=16)
    close(*run_both("F.scaled_dot_product_attention", xs,
                    dict(is_causal=causal), use_kernels=True))
    assert [c["causal"] for c in calls] == [causal]


# ---- nn.MultiheadAttention ------------------------------------------------------
E, H = 16, 4


def _mha_attrs(packed=True, kdim=E, vdim=E, seed=0):
    rng = np.random.default_rng(seed)

    def w(o, i):
        return rng.standard_normal((o, i)).astype(np.float32) / np.sqrt(i)

    if packed:
        attrs = {"in_proj_weight": w(3 * E, E)}
    else:
        attrs = {"q_proj_weight": w(E, E), "k_proj_weight": w(E, kdim),
                 "v_proj_weight": w(E, vdim)}
    attrs["in_proj_bias"] = rng.standard_normal(3 * E).astype(np.float32)
    attrs["out_proj.weight"] = w(E, E)
    attrs["out_proj.bias"] = rng.standard_normal(E).astype(np.float32) * 0.1
    return attrs


@pytest.mark.parametrize("case", [
    "self", "two_outputs", "seq_first", "separate_kv_dims",
    "mask2d_bool", "mask3d_float", "trailing_mask", "mask_and_weights",
    "no_bias"])
def test_mha_vs_jax(case):
    params = dict(embed_dim=E, num_heads=H, batch_first=True)
    attrs = _mha_attrs()
    n, lq, lk = 2, 5, 7
    xs = [rand(n, lq, E, seed=1)]
    n_out = 2 if case in ("two_outputs", "mask_and_weights") else 1
    if case == "seq_first":
        params["batch_first"] = False
        xs = [rand(lq, n, E, seed=1)]
    if case == "separate_kv_dims":
        params.update(kdim=6, vdim=10)
        attrs = _mha_attrs(packed=False, kdim=6, vdim=10)
        xs += [rand(n, lk, 6, seed=2), rand(n, lk, 10, seed=3)]
    if case == "mask2d_bool":           # True = mask out
        m = np.random.default_rng(4).random((lq, lq)) > 0.6
        m[:, 0] = False
        xs += [xs[0], xs[0], m]
    if case == "mask3d_float":          # [N*h, Lq, Lk], added
        xs += [rand(n, lk, E, seed=2), rand(n * H, lq, lk, seed=5)]
    if case in ("trailing_mask", "mask_and_weights"):
        # (q, mask): a rank-2 trailing operand is attn_mask
        xs += [np.triu(np.full((lq, lq), -1e9, np.float32), k=1)]
    if case == "no_bias":
        del attrs["in_proj_bias"], attrs["out_proj.bias"]
    close(*run_both("nn.MultiheadAttention", xs, params, attrs, n_out))


def test_mha_noncausal_flash_gate(monkeypatch):
    """Past the non-causal gate (lowered here), a mask-free one-output
    MHA with kernels on calls flash_attention non-causal; with a mask
    or two outputs it stays on torch."""
    monkeypatch.setenv("SI_FLASH_MIN_LK_NC", "8")
    monkeypatch.setenv("SI_FLASH_MIN_LQ", "8")
    calls = []
    orig = kernels.attention.flash_attention
    monkeypatch.setattr(kernels.attention, "flash_attention",
                        lambda *a, **k: calls.append(k) or orig(*a, **k))
    params = dict(embed_dim=E, num_heads=H, batch_first=True)
    x = rand(2, 12, E, seed=6)
    close(*run_both("nn.MultiheadAttention", [x], params, _mha_attrs(),
                    use_kernels=True))
    assert [c.get("causal", False) for c in calls] == [False]
    close(*run_both("nn.MultiheadAttention", [x], params, _mha_attrs(),
                    n_out=2, use_kernels=True))
    assert len(calls) == 1


# ---- si.RotaryAttention options -------------------------------------------------
def _rattn(e=16, heads=4, kv=2, d=None, seed=0, n=2, length=40):
    rng = np.random.default_rng(seed)
    d = d or e // heads
    attrs = {f"{k}_proj.weight": rng.standard_normal(
        (e if k == "o" else (heads if k == "q" else kv) * d,
         heads * d if k == "o" else e)).astype(np.float32) / np.sqrt(e)
        for k in "qkvo"}
    x = rng.standard_normal((n, length, e)).astype(np.float32)
    return x, attrs, dict(embed_dim=e, num_heads=heads, num_kv_heads=kv)


@pytest.mark.parametrize("opts", [
    dict(sliding_window=7), dict(sliding_window=64),
    dict(logit_softcap=2.0), dict(logit_softcap=5.0, attn_scale=0.4,
                                  sliding_window=9),
    dict(alibi=1), dict(alibi=1, alibi_scale=0.5),
    dict(alibi=1, slopes=True), dict(alibi=1, head_dim=5)],
    ids=["sliding", "sliding_wider_than_L", "softcap",
         "gemma2_softcap_scale_sliding", "alibi", "alibi_scale",
         "alibi_slopes_attr", "alibi_odd_head_dim"])
@pytest.mark.parametrize("use_kernels", [None, True])
def test_rotary_attention_options_vs_jax(opts, use_kernels):
    opts = dict(opts)
    x, attrs, params = _rattn(heads=6 if opts.get("slopes") else 4,
                              kv=3 if opts.get("slopes") else 2,
                              d=opts.get("head_dim"), e=18
                              if opts.get("slopes") else 16)
    if opts.pop("slopes", False):
        attrs["alibi_slopes"] = np.linspace(0.05, 0.6, 6)
    params.update(opts)
    close(*run_both("si.RotaryAttention", [x], params, attrs,
                    use_kernels=use_kernels))


def test_rotary_attention_banded_flash_path(monkeypatch):
    """A sliding op with kernels on and the band gate lowered goes through
    flash_attention's banded mode (its plain version on the CPU), and
    matches the JAX lowering; softcapped and ALiBi ops never call it."""
    monkeypatch.setenv("SI_FLASH_BAND_MIN_LK", "32")
    monkeypatch.setenv("SI_FLASH_BAND_MIN_LQ", "32")
    calls = []
    orig = kernels.attention.flash_attention
    monkeypatch.setattr(kernels.attention, "flash_attention",
                        lambda *a, **k: calls.append(k) or orig(*a, **k))
    x, attrs, params = _rattn(length=40)
    close(*run_both("si.RotaryAttention", [x], dict(params, sliding_window=
                                                    7), attrs,
                    use_kernels=True))
    assert [c["sliding_window"] for c in calls] == [7]
    for extra in (dict(sliding_window=7, logit_softcap=3.0), dict(alibi=1)):
        close(*run_both("si.RotaryAttention", [x], dict(params, **extra),
                        attrs, use_kernels=True))
    assert len(calls) == 1


@pytest.mark.parametrize("bad,match", [
    (dict(head_dim=5), "even"), (dict(sliding_window=0), ">= 1"),
    (dict(logit_softcap=-1.0), "> 0")])
def test_rotary_attention_option_errors_as_jax(bad, match):
    x, attrs, params = _rattn(d=bad.get("head_dim"))
    jop, top = make_ops("si.RotaryAttention", dict(params, **bad), attrs)
    for lower, op, cfg in ((jlower, jop, JCfg()),
                           (tlower, top, TCfg(device="cpu"))):
        with pytest.raises(ValueError, match=match):
            lower(op, cfg)


@pytest.mark.parametrize("heads", [1, 2, 3, 5, 8, 12, 16, 24, 32, 40, 64])
def test_alibi_slopes_equal_to_jax(heads):
    np.testing.assert_array_equal(tattn.alibi_slopes(heads),
                                  jattn.alibi_slopes(heads))
    info = {"num_heads": heads, "alibi_scale": 0.25,
            "alibi_slopes": None}
    np.testing.assert_array_equal(tattn.resolve_alibi_slopes(info),
                                  jattn.resolve_alibi_slopes(info))


def test_rotary_attention_decode_info_equal_to_jax():
    x, attrs, params = _rattn()
    attrs["alibi_slopes"] = np.linspace(0.1, 0.4, 4)
    params.update(alibi=1, alibi_scale=0.5, logit_softcap=3.0)
    jop, top = make_ops("si.RotaryAttention", params, attrs)
    ji = jlower(jop, JCfg()).decode_info
    ti = tlower(top, TCfg(device="cpu")).decode_info
    assert ti.keys() == ji.keys()
    for k in ti:
        if k == "alibi_slopes":
            np.testing.assert_array_equal(ti[k], ji[k])
        else:
            assert ti[k] == ji[k], k
