"""The port's Hugging Face converters (simpleinfer_tpu_torch/frontends/
hf_llama.py, hf_gpt2.py) against the JAX package's and against
transformers, on the CPU.

- every family of tests/test_hf_llama.py and tests/test_bloom.py (llama
  with 4 / 2 / 1 KV heads and tied, qwen2, qwen3, mistral, gemma, the
  gemma legacy hidden_act, gemma2, phi3, stablelm, phi, GPT-NeoX both
  wirings, GPT-J, BLOOM, Falcon's three wirings, MPT, OPT, GPT-2): the
  port's graph has the JAX converter's .param / .bin bytes;
- the port's CPU Engine against the transformers forward at rtol = atol
  = 2e-4 (fp32 both sides);
- greedy CachedDecoder tokens equal to HF's own greedy loop, the mistral
  ring past a turn among them;
- a bf16 state dict converts to the graph of its f32 upcast (the JAX
  converters raise on it: numpy has no bfloat16);
- falcon_graph_from_hf rejects a non-default rope_scaling (the JAX
  converter ignores it);
- chip_smoke.py's TinyLlama and GPT-2 stand-ins at a tiny width give the
  logits of LlamaForCausalLM / GPT2LMHeadModel loaded with their state
  dicts (rtol = atol = 2e-4): the card's fp32 oracle held to
  transformers.
"""
import os
import sys

import jax  # noqa: F401  (both frameworks in one process, JAX on CPU)
import numpy as np
import pytest
import torch

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

from simpleinfer_tpu.frontends import hf_gpt2 as jgpt2
from simpleinfer_tpu.frontends import hf_llama as jllama
from simpleinfer_tpu_torch import Engine, EngineConfig
from simpleinfer_tpu_torch.frontends import hf_gpt2 as tgpt2
from simpleinfer_tpu_torch.frontends import hf_llama as tllama
from simpleinfer_tpu_torch.zoo.generate import CachedDecoder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = EngineConfig(device="cpu")
IDS = np.array([[3, 7, 11, 2, 40, 9, 1, 0, 5, 43, 30, 12, 8, 4, 2, 6]],
               np.int64)
TOL = 2e-4


def _tf():
    return pytest.importorskip("transformers")


def _model(cls_name, cfg_name, seed, **kw):
    tf = _tf()
    torch.manual_seed(seed)
    return getattr(tf, cls_name)(getattr(tf, cfg_name)(**kw)).eval()


SMALL = dict(vocab_size=64, hidden_size=32, intermediate_size=48,
             num_hidden_layers=2, num_attention_heads=4,
             max_position_embeddings=16)

# name -> (converter, model factory, seq_len): the configurations of
# tests/test_hf_llama.py and tests/test_bloom.py
FAMILIES = {
    "llama_kv4": ("llama", lambda: _model(
        "LlamaForCausalLM", "LlamaConfig", 7, num_key_value_heads=4,
        rope_theta=10000.0, tie_word_embeddings=False, **SMALL), 16),
    "llama_kv2": ("llama", lambda: _model(
        "LlamaForCausalLM", "LlamaConfig", 7, num_key_value_heads=2,
        rope_theta=10000.0, tie_word_embeddings=False, **SMALL), 16),
    "llama_kv1": ("llama", lambda: _model(
        "LlamaForCausalLM", "LlamaConfig", 7, num_key_value_heads=1,
        rope_theta=10000.0, tie_word_embeddings=False, **SMALL), 16),
    "llama_tied": ("llama", lambda: _model(
        "LlamaForCausalLM", "LlamaConfig", 7, num_key_value_heads=2,
        rope_theta=10000.0, tie_word_embeddings=True, **SMALL), 16),
    "qwen2_bias": ("llama", lambda: _model(
        "Qwen2ForCausalLM", "Qwen2Config", 9, **{
            **SMALL, "vocab_size": 48, "intermediate_size": 40},
        num_key_value_heads=2, rope_theta=1e6), 16),
    "qwen2_sliding_off": ("llama", lambda: _model(
        "Qwen2ForCausalLM", "Qwen2Config", 7, num_key_value_heads=2,
        sliding_window=6, use_sliding_window=False, **SMALL), 16),
    "mistral_sliding": ("llama", lambda: _model(
        "MistralForCausalLM", "MistralConfig", 7, num_key_value_heads=2,
        rope_theta=10000.0, sliding_window=6, **SMALL), 16),
    "gemma": ("llama", lambda: _model(
        "GemmaForCausalLM", "GemmaConfig", 11, num_key_value_heads=2,
        head_dim=8, rope_theta=10000.0, hidden_act="gelu_pytorch_tanh",
        hidden_activation="gelu_pytorch_tanh", **SMALL), 16),
    "gemma_legacy_act": ("llama", lambda: _model(
        "GemmaForCausalLM", "GemmaConfig", 21, num_key_value_heads=2,
        head_dim=8, hidden_act="gelu", **SMALL), 16),
    "phi3": ("llama", lambda: _model(
        "Phi3ForCausalLM", "Phi3Config", 13, num_key_value_heads=2,
        rope_theta=10000.0, tie_word_embeddings=False, pad_token_id=0,
        **SMALL), 16),
    "qwen3": ("llama", lambda: _model(
        "Qwen3ForCausalLM", "Qwen3Config", 21, vocab_size=48,
        hidden_size=48, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=64,
        max_position_embeddings=16, rope_theta=1e6), 16),
    "gemma2": ("llama", lambda: _model(
        "Gemma2ForCausalLM", "Gemma2Config", 31, vocab_size=48,
        hidden_size=32, intermediate_size=40, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        max_position_embeddings=16, rope_theta=1e4,
        query_pre_attn_scalar=12, attn_logit_softcapping=50.0,
        final_logit_softcapping=30.0, sliding_window=4), 16),
    "stablelm": ("llama", lambda: _model(
        "StableLmForCausalLM", "StableLmConfig", 17,
        num_key_value_heads=2, partial_rotary_factor=0.25,
        rope_theta=10000.0, **SMALL), 16),
    "phi": ("neox", lambda: _model(
        "PhiForCausalLM", "PhiConfig", 11, **{
            **SMALL, "intermediate_size": 64}, num_key_value_heads=4,
        partial_rotary_factor=0.5, rope_theta=10000.0), 16),
    "neox_parallel": ("neox", lambda: _model(
        "GPTNeoXForCausalLM", "GPTNeoXConfig", 13, **{
            **SMALL, "intermediate_size": 64}, rotary_pct=0.25,
        use_parallel_residual=True), 16),
    "neox_sequential": ("neox", lambda: _model(
        "GPTNeoXForCausalLM", "GPTNeoXConfig", 13, **{
            **SMALL, "intermediate_size": 64}, rotary_pct=0.25,
        use_parallel_residual=False), 16),
    "gptj": ("neox", lambda: _model(
        "GPTJForCausalLM", "GPTJConfig", 41, vocab_size=64, n_embd=32,
        n_layer=2, n_head=4, rotary_dim=4, n_positions=32,
        initializer_range=0.2), 16),
    "bloom": ("bloom", lambda: _model(
        "BloomForCausalLM", "BloomConfig", 19, vocab_size=64,
        hidden_size=48, n_layer=2, n_head=6, initializer_range=0.2), 16),
    "falcon_7b_mqa": ("falcon", lambda: _model(
        "FalconForCausalLM", "FalconConfig", 31, vocab_size=64,
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        initializer_range=0.2), 16),
    "falcon_40b_newarch": ("falcon", lambda: _model(
        "FalconForCausalLM", "FalconConfig", 31, vocab_size=64,
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        initializer_range=0.2, new_decoder_architecture=True,
        num_kv_heads=2), 16),
    "falcon_rw_alibi": ("falcon", lambda: _model(
        "FalconForCausalLM", "FalconConfig", 31, vocab_size=64,
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        initializer_range=0.2, alibi=True, parallel_attn=False,
        multi_query=False, bias=True), 16),
    "mpt": ("mpt", lambda: _model(
        "MptForCausalLM", "MptConfig", 37, vocab_size=64, d_model=48,
        n_heads=6, n_layers=2, max_seq_len=32, initializer_range=0.2), 16),
    "opt": ("opt", lambda: _model(
        "OPTForCausalLM", "OPTConfig", 43, vocab_size=64, hidden_size=32,
        num_hidden_layers=2, num_attention_heads=4, ffn_dim=64,
        max_position_embeddings=32, init_std=0.2), 16),
    "gpt2": ("gpt2", lambda: _model(
        "GPT2LMHeadModel", "GPT2Config", 17, vocab_size=64, n_positions=16,
        n_embd=32, n_layer=2, n_head=4, attn_implementation="eager"), 16),
}


def converter(kind, port=True):
    if kind == "gpt2":
        return (tgpt2 if port else jgpt2).gpt2_graph_from_hf
    return getattr(tllama if port else jllama, f"{kind}_graph_from_hf")


def saved(graph, tmp_path, tag):
    p = (str(tmp_path / f"{tag}.pnnx.param"), str(tmp_path / f"{tag}.pnnx.bin"))
    graph.save(*p)
    return tuple(open(f, "rb").read() for f in p)


def hf_logits(model, ids):
    with torch.no_grad():
        return model(torch.from_numpy(np.asarray(ids, np.int64))).logits.numpy()


def port_engine(model, kind, seq_len):
    graph, in_name, out_name = converter(kind)(model, seq_len=seq_len)
    return Engine(CPU).load_model(None, graph=graph), in_name, out_name


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_graph_bytes_equal_jax(name, tmp_path):
    """The same HF model through both packages' converters: the same
    names and the same .param / .bin bytes."""
    kind, make, seq_len = FAMILIES[name]
    model = make()
    tg, ti, to = converter(kind)(model, seq_len=seq_len)
    jg, ji, jo = converter(kind, port=False)(model, seq_len=seq_len)
    assert (ti, to) == (ji, jo)
    assert saved(tg, tmp_path, "port") == saved(jg, tmp_path, "jax")


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_logits_match_transformers(name):
    """The port's CPU Engine against the transformers forward, fp32."""
    kind, make, seq_len = FAMILIES[name]
    model = make()
    eng, in_name, out_name = port_engine(model, kind, seq_len)
    ids = IDS % model.config.vocab_size
    got = eng.run({in_name: ids.astype(np.float32)})[out_name]
    np.testing.assert_allclose(got, hf_logits(model, ids), rtol=TOL,
                               atol=TOL)


def hf_greedy(model, prompt, steps):
    ids = list(prompt)
    for _ in range(steps):
        ids.append(int(hf_logits(model, [ids])[0, -1].argmax()))
    return np.asarray(ids)


# name -> (steps, decoder kwargs, generate kwargs): the decode cases of
# tests/test_hf_llama.py and tests/test_bloom.py
GREEDY = {
    "llama_kv2": (8, {}, {}),
    "gemma": (8, {}, {}),
    "qwen3": (10, {}, {}),
    "gemma2": (10, {}, {}),
    "phi": (8, {}, dict(block=4)),
    "stablelm": (8, {}, dict(block=4)),
    "gptj": (8, dict(scratch_blocks=True), dict(block=4)),
    "bloom": (8, {}, dict(block=4)),
    "falcon_40b_newarch": (6, {}, dict(block=3)),
    "falcon_rw_alibi": (6, {}, dict(block=3)),
    "mpt": (6, {}, dict(block=3)),
    "opt": (8, dict(scratch_blocks=True), dict(block=4)),
    "gpt2": (8, {}, dict(block=4)),
}


@pytest.mark.parametrize("name", sorted(GREEDY))
def test_greedy_decode_matches_hf(name):
    """CachedDecoder on the port's converted model streams HF's greedy
    tokens (its forward re-run per token, fp32)."""
    kind, make, _ = FAMILIES[name]
    steps, dec_kw, gen_kw = GREEDY[name]
    model = make()
    window = 32 if name in ("qwen3", "gemma2") else 16
    model.config.max_position_embeddings = max(
        window, getattr(model.config, "max_position_embeddings", 0) or 0)
    eng, _, _ = port_engine(model, kind, window)
    prompt = [3, 7, 11, 2, 40][:5 if name in ("qwen3", "gemma2") else 3]
    want = hf_greedy(model, prompt, steps)
    got = CachedDecoder(eng, **dec_kw).generate(np.asarray([prompt]),
                                                steps=steps, **gen_kw)
    np.testing.assert_array_equal(got[0], want)


def test_mistral_ring_decode_matches_hf_greedy():
    """A mistral model at window 128 keeps its sliding KV in a ring of 72
    slots (W + 64) and greedy-decodes HF's own tokens 100 steps deep,
    past a ring turn."""
    model = _model("MistralForCausalLM", "MistralConfig", 7,
                   num_key_value_heads=2, rope_theta=10000.0,
                   sliding_window=6, **{**SMALL,
                                        "max_position_embeddings": 128})
    eng, _, _ = port_engine(model, "llama", 128)
    dec = CachedDecoder(eng, scratch_blocks=True)
    assert next(iter(dec.init_cache(1).values()))[0].shape[2] == 72
    prompt = [3, 7, 11, 2]
    want = hf_greedy(model, prompt, 100)
    got = dec.generate(np.asarray([prompt]), steps=100, block=25)
    np.testing.assert_array_equal(got[0], want)


# one model per converter for the bf16 checkpoint
BF16 = ("llama_kv2", "gemma2", "phi3", "neox_parallel", "gptj", "bloom",
        "falcon_40b_newarch", "mpt", "opt", "gpt2")


@pytest.mark.parametrize("name", BF16)
def test_bf16_state_dict_converts_like_its_f32_upcast(name, tmp_path):
    """A model cast to bf16 (as published checkpoints mostly are)
    converts, and to the graph of the same weights upcast to f32; the
    JAX converter raises on it (numpy has no bfloat16)."""
    kind, make, seq_len = FAMILIES[name]
    model = make().to(torch.bfloat16)
    up = make()
    up.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    got = converter(kind)(model, seq_len=seq_len)[0]
    want = converter(kind)(up, seq_len=seq_len)[0]
    assert saved(got, tmp_path, "bf16") == saved(want, tmp_path, "f32")
    with pytest.raises(TypeError):
        converter(kind, port=False)(model, seq_len=seq_len)


@pytest.mark.parametrize("scaling", [
    {"rope_type": "linear", "factor": 2.0},
    {"type": "dynamic", "factor": 2.0}])
def test_falcon_rejects_rope_scaling(scaling):
    """Falcon's config carries rope_scaling; the port's converter refuses
    a non-default one, as llama_graph_from_hf does (the JAX converter
    ignores it and builds unscaled rotary tables)."""
    model = _model("FalconForCausalLM", "FalconConfig", 31, vocab_size=64,
                   hidden_size=32, num_hidden_layers=1,
                   num_attention_heads=4, rope_scaling=scaling)
    with pytest.raises(ValueError, match="rope_scaling"):
        tllama.falcon_graph_from_hf(model)
    jllama.falcon_graph_from_hf(model)      # the reference's fault
    model.config.rope_scaling = {"rope_type": "default"}
    tllama.falcon_graph_from_hf(model)


def test_converters_reject_other_families():
    model = FAMILIES["llama_kv2"][1]()
    for fn in (tllama.bloom_graph_from_hf, tllama.falcon_graph_from_hf,
               tllama.mpt_graph_from_hf, tllama.opt_graph_from_hf,
               tllama.neox_graph_from_hf, tgpt2.gpt2_graph_from_hf):
        with pytest.raises(ValueError):
            fn(model)
    model.config.model_type = "gpt2"
    with pytest.raises(ValueError):
        tllama.llama_graph_from_hf(model)


def test_opt_rejects_post_ln():
    model = _model("OPTForCausalLM", "OPTConfig", 1, vocab_size=32,
                   hidden_size=16, num_hidden_layers=1,
                   num_attention_heads=2, ffn_dim=32,
                   max_position_embeddings=16, do_layer_norm_before=False)
    with pytest.raises(ValueError, match="do_layer_norm_before"):
        tllama.opt_graph_from_hf(model)


def test_mpt_slopes_equal_jax():
    for h in (1, 2, 4, 6, 8, 12):
        assert tllama.mpt_slopes(h).tobytes() == \
            jllama.mpt_slopes(h).tobytes()


# ---- chip_smoke.py's stand-ins at a tiny width ------------------------------
def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


def test_llama_stand_in_matches_transformers():
    """chip_smoke's TinyLlama stand-in (GQA group 4 here) at a tiny
    width, seeded as on the card: LlamaForCausalLM of its config loads
    its state dict with no key missing or left over and gives its
    logits; both converters give the same bytes for it."""
    tf = _tf()
    cs = _chip_smoke()
    stand_in = cs.hf_stand_in(
        "llama", torch.device("cpu"), torch.float32, layers=2, hidden=64,
        intermediate=96, heads=8, kv_heads=2, vocab=128, positions=32)
    c = stand_in.config
    hf = tf.LlamaForCausalLM(tf.LlamaConfig(
        vocab_size=c.vocab_size, hidden_size=c.hidden_size,
        intermediate_size=c.intermediate_size,
        num_hidden_layers=c.num_hidden_layers,
        num_attention_heads=c.num_attention_heads,
        num_key_value_heads=c.num_key_value_heads,
        max_position_embeddings=c.max_position_embeddings,
        rms_norm_eps=c.rms_norm_eps, rope_theta=c.rope_theta,
        tie_word_embeddings=False)).eval()
    hf.load_state_dict(stand_in.state_dict(), strict=True)
    ids = np.random.default_rng(3).integers(0, 128, (2, 24))
    with torch.no_grad():
        want = stand_in(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(hf_logits(hf, ids), want, rtol=TOL, atol=TOL)
    eng, in_name, out_name = port_engine(stand_in, "llama", 24)
    got = eng.run({in_name: ids[:1].astype(np.float32)})[out_name]
    np.testing.assert_allclose(got, want[:1], rtol=TOL, atol=TOL)


def test_gpt2_stand_in_matches_transformers(tmp_path):
    """chip_smoke's GPT-2 stand-in at a tiny width: GPT2LMHeadModel loads
    its state dict (the head tied to wte) and gives its logits; both
    converters give the same bytes for it."""
    tf = _tf()
    cs = _chip_smoke()
    stand_in = cs.hf_stand_in("gpt2", torch.device("cpu"), torch.float32,
                              layers=2, hidden=32, heads=4, vocab=64,
                              positions=32)
    c = stand_in.config
    hf = tf.GPT2LMHeadModel(tf.GPT2Config(
        vocab_size=c.vocab_size, n_positions=c.n_positions, n_embd=c.n_embd,
        n_layer=c.n_layer, n_head=c.n_head,
        layer_norm_epsilon=c.layer_norm_epsilon,
        activation_function="gelu_new", attn_implementation="eager")).eval()
    missing, unexpected = hf.load_state_dict(stand_in.state_dict(),
                                             strict=False)
    assert not unexpected
    assert all(k.endswith(".attn.bias") or k.endswith(".attn.masked_bias")
               for k in missing), missing
    ids = np.random.default_rng(3).integers(0, 64, (2, 24))
    with torch.no_grad():
        want = stand_in(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(hf_logits(hf, ids), want, rtol=TOL, atol=TOL)
    tg = tgpt2.gpt2_graph_from_hf(stand_in, seq_len=24)[0]
    jg = jgpt2.gpt2_graph_from_hf(stand_in, seq_len=24)[0]
    assert saved(tg, tmp_path, "port") == saved(jg, tmp_path, "jax")


def test_chip_smoke_import_phases_rehearse_on_cpu():
    """chip_smoke.py's hf_llama, hf_gpt2, torch_export, zoo_rest and
    compat phases at a tiny size on the CPU (the wrappers run their plain
    versions): every greedy reply equal to its wave's replay, on vs off
    within the limits, fp32 within 2e-4 x scale of the stand-ins, the
    exported modules within the golden tolerance, matmul_int8w called on
    each CNN path, the compat flow all Success and bit-equal."""
    cs = _chip_smoke()
    res = cs.imports_rehearsal(torch.device("cpu"))
    calls = {k: v["matmul_int8w_calls"] for k, v in
             {**res["export"], **res["zoo_rest"]}.items()}
    assert calls == {"resnet50_export": 10, "vit_b16_export": 5,
                     "convnext_tiny": 25, "mobilenet_v3": 31,
                     "squeezenet": 11}
    assert set(res["compat"]["status"].values()) == {"Success"}
    assert res["compat"]["bit_equal"]
