"""The port's llama generation path (simpleinfer_tpu_torch: the llama
builder, nn.Linear / nn.RMSNorm / nn.Embedding / si.RotaryAttention,
int4w, CachedDecoder, sampling and GenerationService) against the JAX
package on the CPU, on the same graphs, weights and numpy-seeded inputs.

Tolerances: fp32 logits within the golden tolerance (atol = rtol =
5e-4 x scale, tests/test_golden.py); op-level fp32 within 1e-5 x scale
(the same math, sums in another order); greedy tokens equal. The port's
engines run on the CPU (device="cpu"); with use_kernels=True its kernel
wrappers run their plain versions, and the JAX decoder's decode_attn=
"pallas" runs the Pallas kernel in interpret mode.
"""
import os
import subprocess
import sys

import jax  # noqa: F401  (both frameworks in one process, JAX on CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleinfer_tpu import Engine as JEngine
from simpleinfer_tpu import EngineConfig as JConfig
from simpleinfer_tpu.config import EngineConfig as JCfg
from simpleinfer_tpu.ir import graph as jgraph
from simpleinfer_tpu.ops import lower_operator as jlower
from simpleinfer_tpu.quant.tensor import Quantized4Tensor as JQ4
from simpleinfer_tpu.quant.tensor import QuantizedTensor as JQ
from simpleinfer_tpu.serving.llm import GenerationService as JService
from simpleinfer_tpu.zoo import build_llama as jbuild_llama
from simpleinfer_tpu.zoo.generate import CachedDecoder as JDecoder
from simpleinfer_tpu.zoo.sampling import sample_logits as jsample
from simpleinfer_tpu_torch import Engine, EngineConfig
from simpleinfer_tpu_torch import kernels
from simpleinfer_tpu_torch.config import EngineConfig as TCfg
from simpleinfer_tpu_torch.convert import program_weights_from_numpy
from simpleinfer_tpu_torch.ir import graph as tgraph
from simpleinfer_tpu_torch.ops import lower_operator as tlower
from simpleinfer_tpu_torch.quant.tensor import Quantized4Tensor
from simpleinfer_tpu_torch.quant.tensor import quantize_per_channel as tquant
from simpleinfer_tpu_torch.serving import GenerationService
from simpleinfer_tpu_torch.zoo import build_llama
from simpleinfer_tpu_torch.zoo.generate import CachedDecoder
from simpleinfer_tpu_torch.zoo.sampling import sample_logits, step_generator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "llama_qwen3ish.npz")
QWEN3ISH = dict(variant="nano", batch=1, seq_len=16, vocab_size=32,
                qk_norm=True, head_dim=24, seed=4)
NANO = dict(variant="nano", seq_len=32, vocab_size=64)
OP_TOL = 1e-5


def golden_close(got, want):
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=5e-4 * scale, rtol=5e-4)


def port_engine(kw=NANO, **cfg):
    graph, _, _ = build_llama(**kw)
    return Engine(EngineConfig(device="cpu", **cfg)).load_model(
        None, graph=graph)


def jax_engine(kw=NANO, **cfg):
    graph, _, _ = jbuild_llama(**kw)
    return JEngine(JConfig(**cfg)).load_model(None, graph=graph)


def ids(n, length, vocab, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, (n, length)).astype(np.float32)


# ---- builder, golden, forward ---------------------------------------------
@pytest.mark.parametrize("kw", [NANO, QWEN3ISH,
                                dict(variant="micro", seq_len=8,
                                     vocab_size=40, rotary_dim=8, seed=2)],
                         ids=["nano", "qwen3ish", "micro_partial_rotary"])
def test_build_llama_graph_identical(kw):
    """The same ops (types, names, wiring), params and attr bytes as the
    JAX builder for the same arguments and seed."""
    tg, ti, to = build_llama(**kw)
    jg, ji, jo = jbuild_llama(**kw)
    assert (ti, to) == (ji, jo)
    assert [(o.type, o.name) for o in tg.ops] == \
        [(o.type, o.name) for o in jg.ops]
    for top, jop in zip(tg.ops, jg.ops):
        assert [r.name for r in top.inputs] == [r.name for r in jop.inputs]
        assert {k: p.value for k, p in top.params.items()} == \
            {k: p.value for k, p in jop.params.items()}
        assert top.attrs.keys() == jop.attrs.keys()
        for k in top.attrs:
            assert top.attrs[k].array().tobytes() == \
                jop.attrs[k].array().tobytes()


def test_golden_llama_qwen3ish():
    """The frozen fp32 golden of the qwen3-like model (qk-norm, head_dim
    24) through the port, at the golden tolerance."""
    graph, in_name, out_name = build_llama(**QWEN3ISH)
    x = ids(1, 16, 32, seed=1234)
    got = Engine(EngineConfig(device="cpu")).load_model(
        None, graph=graph).run({in_name: x})[out_name]
    golden_close(got, np.load(GOLDEN)["out"])


@pytest.mark.parametrize("use_kernels", [None, True])
@pytest.mark.parametrize("quant", [None, "int4w", "int8w"])
def test_nano_fp32_forward_vs_jax(quant, use_kernels):
    """nano logits vs the JAX Engine (fp32; int4w / int8w quantize the
    same bytes in both), kernels off (torch path) and on (the kernels'
    plain versions on the CPU)."""
    kw = dict(NANO, width=128)
    x = ids(2, 32, 64)
    want = jax_engine(kw, quant=quant).run({"0": x})
    eng = port_engine(kw, quant=quant, use_kernels=use_kernels)
    got = eng.run({"0": x})
    out = eng.output_names[0]
    golden_close(got[out], want[out])


def test_chip_smoke_llama_ref64_vs_jax():
    """chip_smoke.llama_ref64, the float64 reference of the card's fp32
    llama phase, against the JAX Engine's int4w logits (the same int4
    bytes) at the golden tolerance."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    kw = dict(NANO, width=128)
    x = ids(2, 32, 64)
    jeng = jax_engine(kw, quant="int4w")
    want = jeng.run({"0": x})[jeng.output_names[0]]
    got = chip_smoke.llama_ref64(build_llama(**kw)[0], x)
    golden_close(got, np.asarray(want, np.float64))


def test_flash_prefill_path_vs_jax(monkeypatch):
    """With the flash gate lowered to the window, the op's prefill goes
    through kernels/attention.flash_attention (its plain version on the
    CPU); the logits still match the JAX Engine."""
    monkeypatch.setenv("SI_FLASH_MIN_LK", "32")
    monkeypatch.setenv("SI_FLASH_MIN_LQ", "32")
    calls = []
    orig = kernels.attention.flash_attention
    monkeypatch.setattr(kernels.attention, "flash_attention",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    x = ids(2, 32, 64, seed=5)
    want = jax_engine().run({"0": x})
    eng = port_engine(use_kernels=True)
    got = eng.run({"0": x})
    assert len(calls) == 2                 # one per layer
    golden_close(got[eng.output_names[0]], want[eng.output_names[0]])


def test_token_ids_stay_exact_in_bf16():
    """Token inputs are staged as float32 (ids above 256 are not exact in
    bf16), whatever the compute dtype."""
    kw = dict(NANO, vocab_size=1000)
    eng = port_engine(kw, compute_dtype="bfloat16")
    assert eng.program.inputs[0].token
    x = np.full((1, 32), 999.0, np.float32)
    eng.input("0", x)
    assert eng._staged["0"].dtype == torch.float32
    assert float(eng._staged["0"].max()) == 999.0


def test_int4w_weights_carried_from_jax():
    """program_weights_from_numpy carries the JAX package's int4w llama
    weights (Quantized4Tensor as (packed, scale, group, k)) byte-equal
    into the port; the port's forward on them is its own forward."""
    kw = dict(NANO, width=128)
    je = jax_engine(kw, quant="int4w")
    pe = port_engine(kw, quant="int4w", use_kernels=True)

    def as_numpy(v):
        if isinstance(v, JQ4):
            return (np.asarray(v.packed), np.asarray(v.scale), v.group,
                    v.k)
        if isinstance(v, JQ):
            return (np.asarray(v.data), np.asarray(v.scale), v.axis)
        return np.asarray(v)

    carried = program_weights_from_numpy(
        {op: {k: as_numpy(v) for k, v in d.items()}
         for op, d in je.program.weights.items()}, device="cpu")
    n4 = 0
    for op, d in pe.program.weights.items():
        assert carried[op].keys() == d.keys()
        for k, w in d.items():
            if isinstance(w, Quantized4Tensor):
                n4 += 1
                c = carried[op][k]
                assert (c.group, c.k) == (w.group, w.k)
                assert c.packed.numpy().tobytes() == w.packed.numpy().tobytes()
                assert c.scale.numpy().tobytes() == w.scale.numpy().tobytes()
    assert n4 == 2 * 7 + 1                 # 7 per layer + the head
    x = ids(1, 32, 64, seed=3)
    own = pe.run({"0": x})[pe.output_names[0]]
    with torch.inference_mode():
        got = pe.program.fn(pe.place_weights(carried, pe.program),
                            {"0": torch.from_numpy(x)})
    np.testing.assert_array_equal(
        got[pe.output_names[0]].numpy(), own)


# ---- op lowerings -----------------------------------------------------------
def make_ops(type_, params=None, attrs=None):
    """The same pnnx Operator in both packages' IR."""
    ops = []
    for g in (jgraph, tgraph):
        op = g.Operator(type=type_, name="t0")
        for k, v in (params or {}).items():
            op.params[k] = g.Parameter.from_value(v)
        for k, v in (attrs or {}).items():
            op.attrs[k] = g.Attribute.from_array(np.asarray(v, np.float32))
        ops.append(op)
    return ops


def run_both(type_, x, params, attrs, use_kernels=None):
    jop, top = make_ops(type_, params, attrs)
    jimpl = jlower(jop, JCfg())
    timpl = tlower(top, TCfg(device="cpu", use_kernels=use_kernels))
    got = timpl.apply(timpl.weights, torch.from_numpy(x)).numpy()
    want = np.asarray(jimpl.apply(
        {k: jnp.asarray(v) for k, v in jimpl.weights.items()},
        jnp.asarray(x)))
    assert timpl.decode_info == jimpl.decode_info or \
        timpl.type != "si.RotaryAttention" or all(
            timpl.decode_info[k] == jimpl.decode_info[k]
            for k in timpl.decode_info)
    return got, want


def _rattn_case(e, heads, kv, d=None, bias=False, qk_norm=False, seed=0):
    rng = np.random.default_rng(seed)
    d = d or e // heads
    attrs = {f"{k}_proj.weight": rng.standard_normal(
        (e if k == "o" else (heads if k == "q" else kv) * d,
         heads * d if k == "o" else e)).astype(np.float32) / np.sqrt(e)
        for k in "qkvo"}
    if bias:
        for k in "qkv":
            attrs[f"{k}_proj.bias"] = rng.standard_normal(
                (heads if k == "q" else kv) * d).astype(np.float32) * 0.1
    if qk_norm:
        attrs["q_norm.weight"] = 1 + 0.1 * rng.standard_normal(d)
        attrs["k_norm.weight"] = 1 + 0.1 * rng.standard_normal(d)
    x = rng.standard_normal((2, 12, e)).astype(np.float32)
    return x, attrs


@pytest.mark.parametrize("extra", [
    dict(), dict(num_kv_heads=1), dict(bias=True), dict(head_dim=6),
    dict(qk_norm_eps=1e-5, qk_norm=True), dict(rotary_dim=4),
    dict(rope_interleaved=1), dict(attn_scale=0.2, rope_theta=500.0)],
    ids=["mha", "gqa", "bias", "head_dim", "qk_norm", "partial_rotary",
         "interleaved", "scale_theta"])
def test_rotary_attention_vs_jax_lowering(extra):
    extra = dict(extra)
    e, heads = 16, 4
    kv = extra.pop("num_kv_heads", 2)
    bias = extra.pop("bias", False)
    qk_norm = extra.pop("qk_norm", False)
    x, attrs = _rattn_case(e, heads, kv, extra.get("head_dim"), bias,
                           qk_norm)
    params = dict(embed_dim=e, num_heads=heads, num_kv_heads=kv,
                  bias=bias, **extra)
    got, want = run_both("si.RotaryAttention", x, params, attrs)
    np.testing.assert_allclose(got, want, atol=OP_TOL * max(
        1.0, float(np.abs(want).max())), rtol=OP_TOL)


@pytest.mark.parametrize("param", ["sliding_window", "logit_softcap",
                                   "alibi", "alibi_sliding_window"])
def test_rotary_attention_unported_options_raise(param):
    """The options this test once held to "not ported yet" (the name is
    kept): sliding_window, logit_softcap and alibi now lower as the JAX
    package's do (op tolerance); alibi with a sliding window raises in
    both packages."""
    x, attrs = _rattn_case(16, 4, 2)
    opts = {"sliding_window": dict(sliding_window=5),
            "logit_softcap": dict(logit_softcap=2.0),
            "alibi": dict(alibi=1),
            "alibi_sliding_window": dict(alibi=1, sliding_window=5)}[param]
    params = dict(embed_dim=16, num_heads=4, num_kv_heads=2, **opts)
    if param == "alibi_sliding_window":
        jop, top = make_ops("si.RotaryAttention", params, attrs)
        for lower, op, cfg in ((jlower, jop, JCfg()),
                               (tlower, top, TCfg(device="cpu"))):
            with pytest.raises(ValueError, match="mutually exclusive"):
                lower(op, cfg)
        return
    got, want = run_both("si.RotaryAttention", x, params, attrs)
    np.testing.assert_allclose(got, want, atol=OP_TOL * max(
        1.0, float(np.abs(want).max())), rtol=OP_TOL)


@pytest.mark.parametrize("type_,params,attrs", [
    ("nn.RMSNorm", dict(normalized_shape=[8], eps=1e-6,
                        elementwise_affine=True),
     {"weight": np.linspace(0.5, 1.5, 8)}),
    ("nn.RMSNorm", dict(normalized_shape=[8], eps=1e-5), {}),
    ("nn.LayerNorm", dict(normalized_shape=[8], eps=1e-5,
                          elementwise_affine=True),
     {"weight": np.linspace(0.5, 1.5, 8), "bias": np.linspace(-1, 1, 8)}),
    ("nn.Linear", dict(in_features=8, out_features=5, bias=True),
     {"weight": np.arange(40).reshape(5, 8) / 40.0, "bias": np.ones(5)}),
    ("nn.Embedding", dict(num_embeddings=10, embedding_dim=8),
     {"weight": np.arange(80).reshape(10, 8) / 80.0}),
], ids=["rmsnorm", "rmsnorm_plain", "layernorm", "linear", "embedding"])
def test_token_ops_vs_jax_lowering(type_, params, attrs):
    rng = np.random.default_rng(1)
    if type_ == "nn.Embedding":
        x = rng.integers(0, 10, (2, 7)).astype(np.float32)
    else:
        x = rng.standard_normal((2, 7, 8)).astype(np.float32)
    got, want = run_both(type_, x, params, attrs)
    np.testing.assert_allclose(got, want, atol=OP_TOL, rtol=OP_TOL)


def test_linear_static_int8_not_ported():
    """Static int8 nn.Linear is ported now (tests/test_torch_int8.py
    holds it to the JAX lowering): an act_scale over an fp weight is
    ignored, as in the JAX package; over an int8 weight the activation
    is quantized and the product is the exact s8 one."""
    top = make_ops("nn.Linear", dict(in_features=4, out_features=2,
                                     bias=False),
                   {"weight": np.ones((2, 4))})[1]
    impl = tlower(top, TCfg(device="cpu"))
    x = torch.tensor([[0.5, -1.0, 2.0, 0.25]])
    fp = impl.apply({**impl.weights, "act_scale": torch.ones(())}, x)
    np.testing.assert_allclose(fp.numpy(), [[1.75, 1.75]])
    wq = tquant(impl.weights["weight"].numpy(), 1)
    q8 = impl.apply({"weight": wq, "act_scale": torch.tensor(0.25)}, x)
    # x / 0.25 rounds half to even: [2, -4, 8, 1] -> 7 x 0.25 x w_scale
    np.testing.assert_allclose(q8.numpy(), [[1.75, 1.75]], rtol=1e-6)


# ---- KV-cache decode ---------------------------------------------------------
@pytest.fixture(scope="module")
def engines():
    return jax_engine(), port_engine(use_kernels=True)


@pytest.mark.parametrize("kv_dtype", [None, "bfloat16", "int8"])
@pytest.mark.parametrize("mode", ["per_step", "scratch", "kernel"])
def test_greedy_decode_token_equal_to_jax(engines, kv_dtype, mode):
    """CachedDecoder.generate: the per-step path, scratch blocks and the
    decode kernel (JAX: decode_attn='pallas', interpret mode) give the
    JAX decoder's greedy tokens for every cache dtype."""
    je, pe = engines
    prompt = np.array([[5, 1, 8], [2, 9, 3]])
    want = JDecoder(je, kv_dtype=kv_dtype, scratch_blocks=mode != "per_step",
                    decode_attn="pallas" if mode == "kernel" else "xla"
                    ).generate(prompt, steps=8, block=4)
    got = CachedDecoder(pe, kv_dtype=kv_dtype,
                        scratch_blocks=mode != "per_step",
                        decode_attn="kernel" if mode == "kernel" else "torch"
                        ).generate(prompt, steps=8, block=4)
    np.testing.assert_array_equal(got, want)


def test_prefill_and_step_logits_vs_jax(engines):
    """prefill's last logits and one per-step decode's logits against the
    JAX decoder's, fp32 at the op tolerance x 10 (16 positions deep)."""
    je, pe = engines
    tokens = np.zeros((2, 32), np.float32)
    tokens[0, :5] = [3, 1, 4, 1, 5]
    tokens[1, :3] = [9, 2, 6]
    lengths = np.array([5, 3])
    jd, td = JDecoder(je), CachedDecoder(pe)
    jl, jc = jd.prefill(tokens, lengths)
    tl, tc = td.prefill(tokens, lengths)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    nxt = np.argmax(np.asarray(jl), -1)[:, None]
    jl2, _ = jd.step(nxt, lengths, jc)
    tl2, _ = td.step(nxt, lengths, tc)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=1e-4,
                               rtol=1e-4)


def test_decode_eos_and_validation(engines):
    _, pe = engines
    dec = CachedDecoder(pe, scratch_blocks=True)
    prompt = np.array([[5, 1, 8]])
    full = dec.generate(prompt, steps=6)
    eos = int(full[0, 5])
    cut = dec.generate(prompt, steps=6, eos_id=eos)
    assert cut.shape[1] <= 6 and cut[0, -1] == eos
    with pytest.raises(ValueError, match="scratch_blocks"):
        CachedDecoder(pe, decode_attn="kernel")
    with pytest.raises(ValueError, match="'torch' or 'kernel'"):
        CachedDecoder(pe, decode_attn="pallas")
    with pytest.raises(ValueError, match="window"):
        dec.generate(prompt, steps=40)


def test_cache_nbytes_matches_init_cache(engines):
    _, pe = engines
    for kv in (None, "bfloat16", "int8"):
        dec = CachedDecoder(pe, kv_dtype=kv)
        caches = dec.init_cache(3)
        total = sum(t.numel() * t.element_size()
                    for leaves in caches.values() for t in leaves)
        assert dec.cache_nbytes(3) == total


def test_use_kernels_false_takes_torch_paths(monkeypatch):
    """An int4w engine with use_kernels=False and decode_attn="torch"
    calls no kernel wrapper, and decodes the same greedy tokens as the
    same model with kernels on (their plain versions on the CPU)."""
    monkeypatch.setenv("SI_FLASH_MIN_LK", "32")
    monkeypatch.setenv("SI_FLASH_MIN_LQ", "32")
    calls = {}
    for mod, name in ((kernels.matmul, "matmul_int4w"),
                      (kernels.attention, "flash_attention"),
                      (kernels.decode_attn, "decode_attention")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=orig, **k: (
            calls.__setitem__(_n, calls.get(_n, 0) + 1) or _f(*a, **k)))
    prompt = np.array([[4, 4, 2], [9, 1, 7]])
    x = ids(1, 32, 64, seed=2)
    toks, logits = {}, {}
    for uk, attn in ((True, "kernel"), (False, "torch")):
        calls.clear()
        eng = port_engine(quant="int4w", use_kernels=uk)
        dec = CachedDecoder(eng, scratch_blocks=True, decode_attn=attn)
        toks[uk] = dec.generate(prompt, steps=6, block=3)
        logits[uk] = eng.run({"0": x})[eng.output_names[0]]
        assert set(calls) == ({"matmul_int4w", "flash_attention",
                               "decode_attention"} if uk else set())
    np.testing.assert_array_equal(toks[True], toks[False])
    golden_close(logits[True], logits[False])


# ---- sampling ------------------------------------------------------------------
def test_sample_logits_greedy_equal_to_jax():
    logits = np.random.default_rng(0).standard_normal((5, 50)).astype(
        np.float32)
    t = np.zeros(5, np.float32)
    k = np.zeros(5, np.int64)
    p = np.ones(5, np.float32)
    want = np.asarray(jsample(jnp.asarray(logits), jax.random.PRNGKey(0),
                              jnp.asarray(t), jnp.asarray(k, jnp.int32),
                              jnp.asarray(p)))
    got = sample_logits(torch.from_numpy(logits), None, t, k, p).numpy()
    np.testing.assert_array_equal(got, want)
    # a greedy row inside a sampled batch stays greedy
    t2 = np.array([0.0, 1.0, 0.0, 0.7, 0.0], np.float32)
    got2 = sample_logits(torch.from_numpy(logits), step_generator(
        "cpu", 0, 1), t2, k, p).numpy()
    np.testing.assert_array_equal(got2[t2 == 0], want[t2 == 0])


@pytest.mark.parametrize("temp,top_k,top_p", [
    (1.0, 0, 1.0), (0.5, 0, 1.0), (1.0, 3, 1.0), (1.0, 0, 0.6),
    (2.0, 4, 0.8)])
def test_sample_logits_distribution(temp, top_k, top_p):
    """Sampled rows follow the filtered, renormalized softmax (the JAX
    package's sample_logits_np semantics): empirical frequencies over
    20000 draws within 0.015 of the exact probabilities."""
    v, draws = 8, 20000
    logits = np.linspace(-1.0, 1.5, v).astype(np.float32)[::-1].copy()
    scaled = logits.astype(np.float64) / temp
    order = np.argsort(-scaled, kind="stable")
    probs = np.exp(scaled[order] - scaled.max())
    probs /= probs.sum()
    keep = np.ones(v, bool)
    if top_k:
        keep &= np.arange(v) < top_k
    keep &= (np.cumsum(probs) - probs) < top_p
    exact = np.zeros(v)
    exact[order[keep]] = probs[keep] / probs[keep].sum()
    toks = sample_logits(
        torch.from_numpy(np.tile(logits, (draws, 1))),
        step_generator("cpu", 3, 0), np.full(draws, temp, np.float32),
        np.full(draws, top_k, np.int64), np.full(draws, top_p, np.float32))
    freq = np.bincount(toks.numpy(), minlength=v) / draws
    np.testing.assert_allclose(freq, exact, atol=0.015)
    assert np.all(freq[exact == 0] == 0)


def test_sampled_stream_independent_of_block_size(engines):
    """Step i draws from the generator of (seed, step): the same sampled
    tokens for any decode block size."""
    _, pe = engines
    dec = CachedDecoder(pe, scratch_blocks=True)
    prompt = np.array([[3, 7, 1], [6, 6, 2]])
    kw = dict(temperature=0.9, top_k=20, seed=11)
    a = dec.generate(prompt, steps=9, block=1, **kw)
    b = dec.generate(prompt, steps=9, block=4, **kw)
    np.testing.assert_array_equal(a, b)


# ---- the service -----------------------------------------------------------------
PROMPTS = [[4, 8, 2], [7, 1], [3, 3, 9], [9, 4], [1, 2, 3, 4, 5, 6], [7],
           [5, 5, 5, 5], [2, 8]]


@pytest.mark.parametrize("slots", [2, 16])
def test_service_token_equal_to_jax(engines, slots):
    """Greedy GenerationService against the JAX service (its
    kv_prefix_ladder off) at slots 2 and 16, the decode kernel under
    decode_attn='auto' at both (KERNEL_MIN_SLOTS, measured on the H100;
    JAX: its torch-style attention at 2, its Pallas kernel in interpret
    mode at 16): mid-flight admissions, horizon 4, equal tokens."""
    je, pe = engines
    jsvc = JService(je, slots=slots, decode_horizon=4,
                    kv_prefix_ladder=None).start()
    want = [f.result(timeout=300) for f in
            [jsvc.submit(p, max_new=6) for p in PROMPTS]]
    jsvc.stop()
    svc = GenerationService(pe, slots=slots, decode_horizon=4).start()
    got = [f.result(timeout=300) for f in
           [svc.submit(p, max_new=6) for p in PROMPTS]]
    svc.stop()
    assert svc._attn_auto == (slots >= GenerationService.KERNEL_MIN_SLOTS)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert svc.stats.completed == len(PROMPTS)


def test_service_stream_eos_and_int4w():
    """An int4w bf16 engine through the service: streams yield the same
    tokens as the future, eos stops a request, and the tokens equal the
    engine's own CachedDecoder."""
    kw = dict(NANO, width=128)
    pe = port_engine(kw, quant="int4w", compute_dtype="bfloat16",
                     use_kernels=True)
    want = CachedDecoder(pe, kv_dtype="bfloat16", scratch_blocks=True,
                         decode_attn="kernel").generate(
        np.array([[5, 1, 8]]), steps=8)
    svc = GenerationService(pe, slots=16, kv_dtype="bfloat16",
                            decode_horizon=2).warmup().start()
    h = svc.submit_stream([5, 1, 8], max_new=8)
    streamed = list(h)
    eos = int(want[0, 5])
    cut = svc.submit([5, 1, 8], max_new=8, eos_id=eos).result(timeout=120)
    svc.stop()
    np.testing.assert_array_equal(h.result(), want[0])
    assert streamed == list(want[0, 3:])
    assert cut[-1] == eos and len(cut) <= 6
    with pytest.raises(RuntimeError, match="not started"):
        svc.submit([1], max_new=1)


def test_service_validation(engines):
    _, pe = engines
    svc = GenerationService(pe, slots=2)
    with pytest.raises(ValueError, match="decode_attn"):
        GenerationService(pe, decode_attn="pallas")
    svc.start()
    try:
        with pytest.raises(ValueError, match="window"):
            svc.submit([1] * 30, max_new=5)
        with pytest.raises(ValueError, match="empty"):
            svc.submit([], max_new=5)
    finally:
        svc.stop()
    assert svc._prefill_ladder == [32]


# ---- chip_smoke's llama phases, rehearsed ------------------------------------------
def test_chip_smoke_llama_phases_rehearse_on_cpu():
    """chip_smoke.py's llama phases (kernel checks, the service run with
    its recorder, checks at the recorded shapes, kernels on vs off, fp32
    card vs CPU) on the CPU at a tiny size with the plain versions."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    cpu = torch.device("cpu")
    chip_smoke.llama_kernel_checks(cpu)
    eng, _, _ = chip_smoke.llama_engine(cpu, variant="nano", seq_len=64,
                                        vocab_size=128)
    run = chip_smoke.service_run(eng, cpu, n_requests=5,
                                 prompt_range=(4, 40), max_new=6)
    assert run["res"]["requests"] == 5
    assert run["recorder"].count("decode_attention")
    chip_smoke.llama_kernel_checks(cpu, chip_smoke.main_shapes_of(
        run["recorder"]))
    ref, _, _ = chip_smoke.llama_engine(cpu, compute="float32",
                                        variant="nano", seq_len=64,
                                        vocab_size=128)
    off, _, _ = chip_smoke.llama_engine(cpu, use_kernels=False,
                                        variant="nano", seq_len=64,
                                        vocab_size=128)
    res = chip_smoke.onoff(eng, off, cpu, ref, prompt_lens=(60, 50))
    assert res["vs_fp32"]["prefill_logits"]["on"]["scale"] > 0
    chip_smoke.check_onoff(res)
    chip_smoke.llama_fp32_card_vs_cpu(cpu, seq_len=32, steps=4,
                                      variant="nano", vocab_size=64)


def test_llama_runs_without_jax():
    """With jax made unimportable, the port builds a llama, decodes and
    serves on the CPU, and never loads the JAX package."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np\n"
        "from simpleinfer_tpu_torch import Engine, EngineConfig\n"
        "from simpleinfer_tpu_torch.zoo import build_llama\n"
        "from simpleinfer_tpu_torch.serving import GenerationService\n"
        "g, i, o = build_llama('nano', seq_len=16, vocab_size=32)\n"
        "e = Engine(EngineConfig(device='cpu', quant='int4w',\n"
        "                        use_kernels=True)).load_model(None, graph=g)\n"
        "s = GenerationService(e, slots=2).start()\n"
        "out = s.submit([1, 2, 3], max_new=4).result(timeout=60)\n"
        "s.stop()\n"
        "assert out.shape == (7,), out.shape\n"
        "assert not any(m == 'simpleinfer_tpu' or\n"
        "               m.startswith('simpleinfer_tpu.') for m in sys.modules)\n"
        "print('OK')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("OK")
