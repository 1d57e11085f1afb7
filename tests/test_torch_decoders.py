"""The attention lineages in the port's decoder and service
(simpleinfer_tpu_torch/zoo/generate.py, serving/llm.py) and the gpt /
bloom / neox / vit / bert builders, against the JAX package on the CPU,
on the same graphs, weights and numpy-seeded inputs.

Covered: builder graphs byte-equal to the JAX builders'; fp32 forwards
at the golden tolerance (atol = rtol = 5e-4 x scale, tests/test_golden.py);
greedy KV-cache decode token-equal to the JAX CachedDecoder for GPT
(nn.MultiheadAttention, learned positions, the graph's -1e9 mask
dropped), BLOOM (ALiBi), NeoX (partial rotary, parallel residual), the
gemma2-ish llama (attn_scale, softcap, alternate sliding layers) and a
sliding llama whose ring (72 slots) is shorter than its prompts, in KV
f32 / bf16 / int8, per step and with scratch blocks; GenerationService
token-equal to the JAX service with rows admitted mid-flight into rings
at other phases; greedy_generate equal to the JAX one; carried weights
byte-equal in int8w and int4w. The JAX decoder's decode_attn="pallas"
runs its Pallas kernel in interpret mode; the port's engines run on the
CPU with the kernels' plain versions.
"""
import os
import subprocess
import sys

import jax  # noqa: F401  (both frameworks in one process, JAX on CPU)
import numpy as np
import pytest
import torch

from simpleinfer_tpu import Engine as JEngine
from simpleinfer_tpu import EngineConfig as JConfig
from simpleinfer_tpu.quant.tensor import Quantized4Tensor as JQ4
from simpleinfer_tpu.quant.tensor import QuantizedTensor as JQ
from simpleinfer_tpu.serving.llm import GenerationService as JService
from simpleinfer_tpu.zoo import builders as jbuilders
from simpleinfer_tpu.zoo.generate import CachedDecoder as JDecoder
from simpleinfer_tpu.zoo.generate import greedy_generate as jgreedy
from simpleinfer_tpu_torch import Engine, EngineConfig
from simpleinfer_tpu_torch import kernels
from simpleinfer_tpu_torch.convert import program_weights_from_numpy
from simpleinfer_tpu_torch.quant.tensor import (Quantized4Tensor,
                                                QuantizedTensor)
from simpleinfer_tpu_torch.serving import GenerationService
from simpleinfer_tpu_torch.zoo import builders as tbuilders
from simpleinfer_tpu_torch.zoo import generate as tgenerate
from simpleinfer_tpu_torch.zoo import greedy_generate
from simpleinfer_tpu_torch.zoo.generate import CachedDecoder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (builder, kwargs): small widths, few layers
MODELS = {
    "gpt": ("build_gpt", dict(variant="nano", seq_len=32, vocab_size=64)),
    "bloom": ("build_bloom", dict(variant="nano", seq_len=32,
                                  vocab_size=64)),
    "neox": ("build_neox", dict(variant="nano", seq_len=32, vocab_size=64)),
    "gemma2ish": ("build_llama", dict(variant="nano", seq_len=128,
                                      vocab_size=64, attn_scale=0.3,
                                      logit_softcap=25.0, sliding_window=8,
                                      sliding_pattern="alternate", seed=4)),
    "swa": ("build_llama", dict(variant="nano", seq_len=128, vocab_size=64,
                                sliding_window=8)),
}
BUILDERS = {
    **{k: MODELS[k] for k in ("gpt", "bloom", "neox")},
    "gpt_small_b2": ("build_gpt", dict(variant="micro", batch=2,
                                       seq_len=16, vocab_size=100)),
    "neox_phi": ("build_neox", dict(variant="nano", shared_ln=True,
                                    head_bias=True, rotary_pct=0.5)),
    "vit": ("build_vit", dict(variant="tiny", batch=1, image_size=32,
                              patch_size=8, num_classes=6, depth=2,
                              embed_dim=32, num_heads=4)),
    "bert": ("build_bert", dict(variant="tiny", batch=2, seq_len=16,
                                vocab_size=64, num_classes=4, depth=2,
                                hidden=32, num_heads=4)),
}


def golden_close(got, want):
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=5e-4 * scale, rtol=5e-4)


def graphs(name):
    fn, kw = (MODELS.get(name) or BUILDERS[name])
    return getattr(tbuilders, fn)(**kw), getattr(jbuilders, fn)(**kw), kw


def ids(n, length, vocab, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, (n, length)).astype(np.float32)


_ENGINES: dict = {}


def engines(name, quant=None):
    """(JAX engine, port engine with kernels on: their plain versions),
    cached per model for the module."""
    key = (name, quant)
    if key not in _ENGINES:
        (tg, _, _), (jg, _, _), _ = graphs(name)
        _ENGINES[key] = (
            JEngine(JConfig(quant=quant)).load_model(None, graph=jg),
            Engine(EngineConfig(device="cpu", quant=quant,
                                use_kernels=True)).load_model(None, graph=tg))
    return _ENGINES[key]


# ---- builders -----------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_graph_identical(name, tmp_path):
    """The same .pnnx.param text and .bin bytes as the JAX builder for
    the same arguments and seed."""
    (tg, ti, to), (jg, ji, jo), _ = graphs(name)
    assert (ti, to) == (ji, jo)
    paths = []
    for pkg, g in (("port", tg), ("jax", jg)):
        p = (str(tmp_path / f"{pkg}.pnnx.param"),
             str(tmp_path / f"{pkg}.pnnx.bin"))
        g.save(*p)
        paths.append(p)
    for a, b in zip(*paths):
        assert open(a, "rb").read() == open(b, "rb").read(), a


def test_gpt2_small_preset_identical():
    """GPT_PRESETS["small"] (GPT-2 small: 12 x 768, 12 heads) and the
    other presets equal the JAX package's."""
    for p in ("GPT_PRESETS", "BLOOM_PRESETS", "NEOX_PRESETS", "VIT_PRESETS",
              "BERT_PRESETS"):
        assert getattr(tbuilders, p) == getattr(jbuilders, p)
    assert tbuilders.GPT_PRESETS["small"] == (12, 768, 12)


@pytest.mark.parametrize("name,quant", [
    ("gpt", None), ("bloom", None), ("neox", None), ("gemma2ish", None),
    ("gpt", "int4w"), ("bloom", "int8w")])
def test_forward_vs_jax(name, quant):
    """fp32 logits of the whole forward against the JAX Engine (the
    graph's -1e9 mask in GPT, BLOOM's slopes up to the last key)."""
    je, pe = engines(name, quant)
    kw = graphs(name)[2]
    x = ids(1, kw["seq_len"], kw["vocab_size"], seed=5)
    out = pe.output_names[0]
    golden_close(pe.run({"0": x})[out], np.asarray(je.run({"0": x})[out]))


# ---- KV-cache decode ----------------------------------------------------------------
PROMPT_LEN = {"gpt": 10, "bloom": 10, "neox": 10, "gemma2ish": 90,
              "swa": 90}


@pytest.mark.parametrize("kv_dtype", [None, "bfloat16", "int8"])
@pytest.mark.parametrize("mode", ["per_step", "scratch"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_greedy_decode_token_equal_to_jax(name, mode, kv_dtype):
    """CachedDecoder.generate, per step and with scratch blocks, gives the
    JAX decoder's greedy tokens in every cache dtype; the sliding models'
    90-token prompts are longer than their 72-slot rings."""
    je, pe = engines(name)
    kw = graphs(name)[2]
    prompt = np.random.default_rng(1).integers(
        0, kw["vocab_size"], (2, PROMPT_LEN[name]))
    scratch = mode == "scratch"
    want = JDecoder(je, kv_dtype=kv_dtype, scratch_blocks=scratch).generate(
        prompt, steps=12, block=4)
    dec = CachedDecoder(pe, kv_dtype=kv_dtype, scratch_blocks=scratch)
    got = dec.generate(prompt, steps=12, block=4)
    np.testing.assert_array_equal(got, want)
    assert dec._has_ring == (name in ("gemma2ish", "swa"))


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_gpt_decode_kernel_token_equal_to_jax(kv_dtype):
    """GPT's MHA lineage through the decode kernel (kernel_ok: no band,
    softcap or ALiBi): the JAX decoder's Pallas kernel in interpret mode
    and the port's plain version give the same greedy tokens."""
    je, pe = engines("gpt")
    prompt = np.array([[5, 1, 8, 2], [2, 9, 3, 3]])
    want = JDecoder(je, kv_dtype=kv_dtype, scratch_blocks=True,
                    decode_attn="pallas").generate(prompt, steps=10, block=3)
    dec = CachedDecoder(pe, kv_dtype=kv_dtype, scratch_blocks=True,
                        decode_attn="kernel")
    assert dec.kernel_ok
    np.testing.assert_array_equal(dec.generate(prompt, steps=10, block=3),
                                  want)


@pytest.mark.parametrize("name", ["gpt", "bloom", "swa"])
def test_prefill_and_step_logits_vs_jax(name):
    """prefill's last logits and one per-step decode's logits against the
    JAX decoder's, fp32 within 1e-4 (GPT's position table gathered at
    each row's position; the sliding model's ring folded from the
    prompt)."""
    je, pe = engines(name)
    kw = graphs(name)[2]
    window = kw["seq_len"]
    lengths = np.array([window - 30, 7])
    tokens = np.zeros((2, window), np.float32)
    for i, p in enumerate(lengths):
        tokens[i, :p] = ids(1, p, kw["vocab_size"], seed=i)[0]
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


def test_ring_caches_and_kernel_rules():
    """Ring length ceil((W + 64) / 8) * 8 where shorter than the window,
    the gemma2-ish model's rings on its sliding layers only, cache_nbytes
    equal to what init_cache allocates, kernel_ok false for sliding,
    softcap and ALiBi, and the decode kernel refused where it cannot
    serve."""
    _, swa = engines("swa")
    _, gem = engines("gemma2ish")
    _, bloom = engines("bloom")
    _, gpt = engines("gpt")
    for eng, rings in ((swa, [72, 72]), (gem, [None, 72])):
        for kv in (None, "bfloat16", "int8"):
            dec = CachedDecoder(eng, kv_dtype=kv, scratch_blocks=True)
            assert [dec._op_ring(i) for _, i in dec._mha_ops] == rings
            caches = dec.init_cache(3)
            assert [c[0].shape[2] for c in caches.values()] == [
                r or 128 for r in rings]
            assert dec.cache_nbytes(3) == sum(
                t.numel() * t.element_size()
                for leaves in caches.values() for t in leaves)
            assert not dec.kernel_ok
    assert not CachedDecoder(bloom, scratch_blocks=True).kernel_ok
    assert CachedDecoder(gpt, scratch_blocks=True).kernel_ok
    with pytest.raises(ValueError, match="sliding"):
        CachedDecoder(swa, scratch_blocks=True, decode_attn="kernel")
    dec = CachedDecoder(bloom, scratch_blocks=True, decode_attn="kernel")
    with pytest.raises(ValueError, match="ALiBi"):
        dec.generate(np.array([[1, 2]]), steps=3)
    dec = CachedDecoder(swa, scratch_blocks=True)
    with pytest.raises(ValueError, match="limited to 64"):
        dec.decode_block(np.zeros(1), np.ones(1), dec.init_cache(1), 0, 1,
                         np.zeros(1), np.zeros(1), np.ones(1), 65)
    with pytest.raises(ValueError, match="limited to 64"):
        GenerationService(swa, slots=2, decode_horizon=65)
    assert CachedDecoder(swa)._op_ring({"sliding_window": 200}) is None


def test_mha_decoder_validation():
    """KV-cache decode needs batch-first self-attention (as the JAX
    decoder); the graph's causal-mask operand is dropped."""
    b = tbuilders.GraphBuilder()
    x = b.input([1, 8], name="0")
    y = b.embedding(x, 16, 8)
    y = b.mha(y, 2)
    b.g.get_operand(y).producer.params["batch_first"] = \
        type(b.g.get_operand(y).producer.params["num_heads"]).from_value(
            False)
    b.output(y)
    eng = Engine(EngineConfig(device="cpu")).load_model(None, graph=b.build())
    with pytest.raises(ValueError, match="batch_first"):
        CachedDecoder(eng)


def test_fp32_decoder_runs_with_tf32_off(monkeypatch):
    """An fp32 engine's decoder walks the plan inside fp32_parity(True)
    (TF32 off, as Engine.forward), a bf16 engine's inside
    fp32_parity(False)."""
    seen = []
    orig = tgenerate.fp32_parity
    monkeypatch.setattr(tgenerate, "fp32_parity",
                        lambda enabled: seen.append(enabled) or orig(enabled))
    (tg, _, _), _, _ = graphs("gpt")
    for compute in ("float32", "bfloat16"):
        seen.clear()
        eng = Engine(EngineConfig(device="cpu", compute_dtype=compute)
                     ).load_model(None, graph=tg)
        CachedDecoder(eng, scratch_blocks=True).generate(
            np.array([[3, 4]]), steps=4, block=2)
        assert seen and set(seen) == {compute == "float32"}


# ---- greedy_generate --------------------------------------------------------------
@pytest.mark.parametrize("name,eos", [("gpt", None), ("bloom", None),
                                      ("gpt", "from_run")])
def test_greedy_generate_equal_to_jax(name, eos):
    je, pe = engines(name)
    prompt = np.array([[4, 8, 1], [9, 2, 6]])
    want = jgreedy(je, prompt, steps=6)
    got = greedy_generate(pe, prompt, steps=6)
    np.testing.assert_array_equal(got, want)
    if eos == "from_run":
        eos_id = int(want[0, 4])
        np.testing.assert_array_equal(
            greedy_generate(pe, prompt, steps=6, eos_id=eos_id),
            jgreedy(je, prompt, steps=6, eos_id=eos_id))
    # the cache agrees with the fixed-window re-forward
    np.testing.assert_array_equal(
        CachedDecoder(pe).generate(prompt, steps=6), want)
    with pytest.raises(ValueError, match="window"):
        greedy_generate(pe, prompt, steps=40)


# ---- the service -----------------------------------------------------------------
@pytest.mark.parametrize("name,slots", [("gpt", 3), ("swa", 3), ("swa", 16),
                                        ("gemma2ish", 3)])
def test_service_token_equal_to_jax(name, slots):
    """Greedy GenerationService against the JAX service (its
    kv_prefix_ladder off), horizon 4: with 3 slots the 8 requests are
    admitted mid-flight, into ring rows whose neighbours sit at other
    phases; prompts past the ring's 72 slots included."""
    je, pe = engines(name)
    kw = graphs(name)[2]
    rng = np.random.default_rng(3)
    hi = kw["seq_len"] - 12
    prompts = [rng.integers(0, kw["vocab_size"], int(p))
               for p in rng.integers(2, hi, 8)]
    jsvc = JService(je, slots=slots, decode_horizon=4,
                    kv_prefix_ladder=None).start()
    want = [f.result(timeout=300) for f in
            [jsvc.submit(p, max_new=10) for p in prompts]]
    jsvc.stop()
    svc = GenerationService(pe, slots=slots, decode_horizon=4).start()
    got = [f.result(timeout=300) for f in
           [svc.submit(p, max_new=10) for p in prompts]]
    svc.stop()
    assert svc._attn_auto == (name == "gpt")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_service_sliding_uses_no_decode_kernel(monkeypatch):
    """decode_attn="auto" keeps sliding, softcapped and ALiBi models off
    the decode kernel (kernel_ok), as in the JAX package, and GPT on it."""
    calls = []
    orig = kernels.decode_attn.decode_attention
    monkeypatch.setattr(kernels.decode_attn, "decode_attention",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    for name in ("swa", "gemma2ish", "bloom", "gpt"):
        calls.clear()
        _, pe = engines(name)
        svc = GenerationService(pe, slots=2, decode_horizon=2).start()
        svc.submit([3, 1, 4, 1, 5], max_new=5).result(timeout=120)
        svc.stop()
        assert bool(calls) == (name == "gpt"), name


# ---- carried weights ------------------------------------------------------------------
def _as_numpy(v):
    if isinstance(v, JQ4):
        return (np.asarray(v.packed), np.asarray(v.scale), v.group, v.k)
    if isinstance(v, JQ):
        return (np.asarray(v.data), np.asarray(v.scale), v.axis)
    return np.asarray(v)


@pytest.mark.parametrize("name,quant", [("gpt", "int4w"), ("gpt", "int8w"),
                                        ("bloom", "int4w"),
                                        ("bloom", "int8w")])
def test_weights_carried_from_jax(name, quant):
    """program_weights_from_numpy carries the JAX program's MHA
    (wq/wk/wv/wo, bq/bk/bv/bo) and ALiBi-op weights byte-equal into the
    port, int8w and int4w; the port's forward on them is its own."""
    je, pe = engines(name, quant)
    carried = program_weights_from_numpy(
        {op: {k: _as_numpy(v) for k, v in d.items()}
         for op, d in je.program.weights.items()}, device="cpu")
    nq = 0
    for op, d in pe.program.weights.items():
        assert carried[op].keys() == d.keys(), op
        for k, w in d.items():
            c = carried[op][k]
            if isinstance(w, Quantized4Tensor):
                nq += 1
                assert (c.group, c.k) == (w.group, w.k)
                pairs = ((c.packed, w.packed), (c.scale, w.scale))
            elif isinstance(w, QuantizedTensor):
                nq += 1
                pairs = ((c.data, w.data), (c.scale, w.scale))
            else:
                pairs = ((c, w),)
            for a, b in pairs:
                assert a.numpy().tobytes() == b.numpy().tobytes(), (op, k)
    assert nq > 0
    x = ids(1, 32, 64, seed=3)
    own = pe.run({"0": x})[pe.output_names[0]]
    with torch.inference_mode():
        got = pe.program.fn(pe.place_weights(carried, pe.program),
                            {"0": torch.from_numpy(x)})
    np.testing.assert_array_equal(got[pe.output_names[0]].numpy(), own)


# ---- chip_smoke's lineage phases, rehearsed --------------------------------------------
def test_chip_smoke_lineage_phases_rehearse_on_cpu():
    """chip_smoke.py's gpt2, llama_swa and attn_variants phases on the CPU
    at a tiny size with the plain versions (the service runs, service vs
    solo tokens, kernels on vs off, fp32 card vs CPU, the encoders'
    matmul_int8w calls per forward)."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    chip_smoke.lineage_rehearsal(torch.device("cpu"))


def test_gpt_runs_without_jax():
    """With jax made unimportable, the port builds a GPT and a sliding
    llama, decodes, serves and re-forwards greedily on the CPU, and
    never loads the JAX package."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np\n"
        "from simpleinfer_tpu_torch import Engine, EngineConfig\n"
        "from simpleinfer_tpu_torch.zoo import build_gpt, build_llama, "
        "greedy_generate\n"
        "from simpleinfer_tpu_torch.serving import GenerationService\n"
        "for g, i, o in (build_gpt('nano', seq_len=16, vocab_size=32),\n"
        "                build_llama('nano', seq_len=96, vocab_size=32,\n"
        "                            sliding_window=4)):\n"
        "    e = Engine(EngineConfig(device='cpu', quant='int4w',\n"
        "               use_kernels=True)).load_model(None, graph=g)\n"
        "    s = GenerationService(e, slots=2).start()\n"
        "    r = s.submit([1, 2, 3], max_new=4).result(timeout=60)\n"
        "    s.stop()\n"
        "    assert r.shape == (7,)\n"
        "    assert greedy_generate(e, np.array([[1, 2]]), 3).shape == (1, 5)\n"
        "assert not any(m == 'simpleinfer_tpu' or\n"
        "               m.startswith('simpleinfer_tpu.') for m in sys.modules)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
