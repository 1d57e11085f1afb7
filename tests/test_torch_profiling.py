"""The port's profiling.py and the FLOP counts of its Program, against the
JAX package: the seven cases of tests/test_profiling.py (OpCost bounds
on the H100 spec, roofline totals, timed_run, the device timer, the
formatter on synthetic rows, a CPU torch.profiler round trip,
attribute_slices covering the program), and Program.flops_per_item,
every op's FLOPs and op_output_shapes equal to the JAX program's on the
same graphs.

One difference is the reference's layout, not a count: the JAX YOLOv5
Detect op emits its head packed [N, R, na*c] (a TPU retile its Engine
undoes on the host, Program.output_transforms); the test unpacks that
shape before comparing with the port's logical [N, R*na, c].

One count is a fault of the reference (ROADMAP.md §3): the JAX package
counts nn.Linear as 2*in*out once a batch item, whatever rows it
multiplies (the tokens of a transformer's projections and MLPs, the
pixels of a ConvNeXt channel MLP). The port counts every row;
JAX_LINEAR_ONE_ROW names the ops where the two counts part."""
import json
import math
import os

import numpy as np
import pytest
import torch

import simpleinfer_tpu.zoo as jzoo
import simpleinfer_tpu_torch.zoo as tzoo
from simpleinfer_tpu import EngineConfig as JConfig
from simpleinfer_tpu.executor import _estimate_flops as j_estimate
from simpleinfer_tpu.executor import build_program as j_build
from simpleinfer_tpu.profiling import summarize_roofline as j_summarize
from simpleinfer_tpu_torch import Engine, EngineConfig
from simpleinfer_tpu_torch.executor import _estimate_flops, build_program
from simpleinfer_tpu_torch.profiling import (
    H100, KERNEL_STAT_KEYS, OpCost, attribute_slices, chip_speed_factor,
    device_profile, format_kernel_stats, kernel_category,
    measure_device_time, roofline_report, summarize_roofline, timed_run)

RNG = np.random.default_rng(41)

# (builder, keywords, config): YOLOv5n, ResNet-18, llama and GPT nano, a
# C3-fused YOLOv5n, and a graph of each other builder family
GRAPHS = {
    "yolov5n_64": ("build_yolov5", dict(variant="n", batch=1,
                                        image_size=64), {}),
    "resnet18_32": ("build_resnet18", dict(batch=1, image_size=32,
                                           num_classes=5, width=8), {}),
    "llama_nano": ("build_llama", dict(variant="nano", seq_len=64,
                                       vocab_size=128), {}),
    "gpt_nano_mha": ("build_gpt", dict(variant="nano", seq_len=64,
                                       vocab_size=128), {}),
    "yolov5n_64_c3": ("build_yolov5", dict(variant="n", batch=1,
                                           image_size=64),
                      dict(quant="int8", c3_fusion=True)),
    "yolov8n_64": ("build_yolov8", dict(variant="n", batch=1,
                                        image_size=64), {}),
    "vit_tiny_32": ("build_vit", dict(variant="tiny", batch=1,
                                      image_size=32), {}),
    "bert_tiny_16": ("build_bert", dict(variant="tiny", batch=1,
                                        seq_len=16), {}),
    "unet_32": ("build_unet", dict(batch=1, image_size=32, width=8,
                                   depth=1, num_classes=3), {}),
    "bloom_nano": ("build_bloom", dict(variant="nano"), {}),
}


# graph -> its nn.Linear ops of more than one row a batch item, where
# the port's count is the JAX package's times the rows
_VIT_MLP = tuple(f"fc_{13 + 8 * k + d}" for k in range(12) for d in (0, 2))
JAX_LINEAR_ONE_ROW = {
    "llama_nano": ("fc_6", "fc_8", "fc_10", "fc_16", "fc_18", "fc_20",
                   "fc_23"),
    "gpt_nano_mha": ("fc_9", "fc_11", "fc_17", "fc_19", "fc_25", "fc_27",
                     "fc_30"),
    "vit_tiny_32": _VIT_MLP,
    "bert_tiny_16": ("fc_8", "fc_10", "fc_16", "fc_18"),
    "bloom_nano": ("fc_7", "fc_9", "fc_15", "fc_17", "fc_20"),
}


def _programs(name):
    build, kw, cfg = GRAPHS[name]
    jp = j_build(getattr(jzoo, build)(**kw)[0], JConfig(**cfg))
    tp = build_program(getattr(tzoo, build)(**kw)[0],
                       EngineConfig(device="cpu", **cfg))
    return jp, tp


def _logical(jp, name, shapes):
    """The JAX op's shapes with a packed terminal head unpacked."""
    na = next((v for k, v in jp.output_transforms.items()
               if any(k in outs for impl, _, outs in jp.plan
                      if impl.name == name)), None)
    if not na:
        return shapes
    return [[n, r * na, c // na] for n, r, c in shapes]


@pytest.mark.parametrize("name", list(GRAPHS))
def test_flops_and_shapes_equal_jax(name):
    """Every op's shapes and FLOPs equal the JAX program's, but for the
    reference's one-row nn.Linear count (JAX_LINEAR_ONE_ROW), where the
    port's is the JAX count times the op's rows."""
    jp, tp = _programs(name)
    assert [i.name for i in tp.impls] == [i.name for i in jp.impls]
    parted = []
    for ti, ji in zip(tp.impls, jp.impls):
        want = _logical(jp, ji.name, jp.op_output_shapes[ji.name])
        assert tp.op_output_shapes[ti.name] == want, ti.name
        j = j_estimate(ji, jp.op_output_shapes[ji.name])
        if ti.type == "nn.Linear":
            s = tp.op_output_shapes[ti.name][0]
            rows = math.prod(s[:-1]) // tp.walk_items
            assert ti.flops_per_element * s[-1] == ji.flops_per_item > 0
            assert tp.op_flops(ti) == j * rows, ti.name
            if rows > 1:
                parted.append(ti.name)
            continue
        assert (ti.flops_per_item, ti.flops_per_pixel) == \
            (ji.flops_per_item, ji.flops_per_pixel), ti.name
        assert tp.op_flops(ti) == \
            _estimate_flops(ti, tp.op_output_shapes[ti.name]) == j, ti.name
    assert tuple(parted) == JAX_LINEAR_ONE_ROW.get(name, ())
    assert tp.flops_per_item == sum(tp.op_flops(i) for i in tp.impls) > 0
    if not parted:
        assert tp.flops_per_item == jp.flops_per_item
    else:
        assert tp.flops_per_item > jp.flops_per_item


def test_undeclared_input_shape_gives_no_shapes():
    """No op shapes, no FLOP count and no roofline, never a partial
    count (the JAX package leaves its per-pixel ops out here)."""
    g, _, _ = tzoo.build_resnet18(batch=1, image_size=32, num_classes=5,
                                  width=8)
    for op in g.ops:
        if op.type == "pnnx.Input":
            for r in op.outputs:
                r.shape = []
    p = build_program(g, EngineConfig(device="cpu"))
    assert p.op_output_shapes is None and p.flops_per_item is None
    with pytest.raises(ValueError, match="op shapes are unknown"):
        summarize_roofline(p)
    with pytest.raises(ValueError, match="op shapes are unknown"):
        p.op_flops(p.impls[0])


def test_failed_shape_walk_gives_no_flops(monkeypatch, caplog):
    """An op that cannot run on fake tensors stops the walk: a warning
    names it, and the program has no op shapes and no FLOP count rather
    than the count of the ops before it."""
    g, _, _ = tzoo.build_resnet18(batch=1, image_size=32, num_classes=5,
                                  width=8)
    p = build_program(g, EngineConfig(device="cpu"))
    impl = p.impls[3]
    real = impl.apply

    def host_read(weights, x, *rest):
        if isinstance(x, torch._subclasses.fake_tensor.FakeTensor):
            x.sum().item()
        return real(weights, x, *rest)

    monkeypatch.setattr(impl, "apply", host_read)
    with caplog.at_level("WARNING", logger="simpleinfer_tpu_torch"):
        assert p.flops_per_item is None
    assert p.op_output_shapes is None
    assert impl.name in caplog.text
    with pytest.raises(ValueError, match="op shapes are unknown"):
        roofline_report(p)


def test_shape_walk_runs_once_at_first_read(monkeypatch):
    """Loading an engine walks no shapes; the first read of the FLOP
    count walks them once."""
    import simpleinfer_tpu_torch.executor as tex

    calls = []
    real = tex._infer_op_shapes
    monkeypatch.setattr(tex, "_infer_op_shapes",
                        lambda *a: calls.append(1) or real(*a))
    graph, _, _ = tzoo.build_resnet18(batch=1, image_size=32,
                                      num_classes=5, width=8)
    eng = Engine(EngineConfig(device="cpu")).load_model(None, graph=graph)
    assert calls == []
    flops = eng.program.flops_per_item
    assert flops > 0 and eng.program.op_output_shapes and calls == [1]


def test_opcost_bounds():
    # big dense matmul: compute bound
    big = OpCost("m", "nn.Linear", flops=2 * 4096 ** 3,
                 weight_bytes=4096 * 4096 * 2, out_bytes=4096 * 4096 * 2,
                 out_shape=[4096, 4096])
    assert big.bound(H100) == "compute"
    # elementwise op: bandwidth bound
    ew = OpCost("r", "nn.ReLU", flops=10 ** 6, weight_bytes=0,
                out_bytes=4 * 10 ** 6, out_shape=[1, 10 ** 6])
    assert ew.bound(H100) == "bandwidth"
    assert ew.min_time_us(H100) > 0
    # the ridge: 989 TFLOP/s over 3.35 TB/s ~ 295 FLOP a byte in bf16
    ridge = OpCost("k", "x", flops=296 * 1000, weight_bytes=1000,
                   out_bytes=0, out_shape=[])
    assert ridge.bound(H100) == "compute"
    assert ridge.bound(H100, "float32") == "compute"
    assert OpCost("k", "x", flops=19 * 1000, weight_bytes=1000,
                  out_bytes=0, out_shape=[]).bound(H100, "float32") \
        == "bandwidth"


def test_roofline_report_totals_match_program():
    jp, tp = _programs("yolov5n_64")
    costs = roofline_report(tp, batch=1)
    assert sum(c.flops for c in costs) == tp.flops_per_item
    assert all(c.out_bytes >= 0 for c in costs)
    convs = [c for c in costs if c.type == "nn.Conv2d"]
    assert convs and all(c.weight_bytes > 0 for c in convs)
    text = summarize_roofline(tp, batch=8)
    assert "speed-of-light" in text and "nn.Conv2d" in text
    # the same GFLOP a batch as the JAX package's table
    head = text.split(",")[1]
    assert head == j_summarize(jp, batch=8).split(",")[1]
    assert head.strip().endswith("GFLOP/batch8")


def test_roofline_counts_quantized_weight_bytes():
    g, _, _ = tzoo.build_resnet18(batch=1, image_size=32, num_classes=5,
                                  width=8)
    fp = build_program(g, EngineConfig(device="cpu"))
    g, _, _ = tzoo.build_resnet18(batch=1, image_size=32, num_classes=5,
                                  width=8)
    q = build_program(g, EngineConfig(device="cpu", quant="int8w"))
    by = {c.name: c for c in roofline_report(q)}
    for c in roofline_report(fp):
        if c.type == "nn.Conv2d":
            w = q.weights[c.name]["weight"]
            # int8 data + f32 scales (+ the f32 bias) against f32 weights
            assert by[c.name].weight_bytes == c.weight_bytes - \
                3 * w.data.numel() + 4 * w.scale.numel()


def test_timed_run_matches_engine():
    graph, in_name, out_name = tzoo.build_resnet18(
        batch=1, image_size=32, num_classes=5, width=8)
    eng = Engine(EngineConfig(device="cpu", compute_dtype="float32")
                 ).load_model(None, graph=graph)
    x = RNG.standard_normal((1, 32, 32, 3)).astype(np.float32)
    eng.run({in_name: x})
    rows = timed_run(eng.program, eng._device_weights,
                     {in_name: torch.from_numpy(x)})
    assert [r[0] for r in rows] == [i.name for i in eng.program.impls]
    assert all(t >= 0 for _, _, t in rows)


def test_measure_device_time_on_the_host():
    """CPU tensors are timed by the host clock; the GEMM reference of
    chip_speed_factor is a card's and refuses the CPU."""
    x = torch.from_numpy(RNG.standard_normal((16, 16)).astype(np.float32))
    dt = measure_device_time(lambda a: torch.tanh(a @ a.T), x, iters=3)
    assert dt > 0
    assert measure_device_time(lambda: None, iters=2, device="cpu") >= 0
    with pytest.raises(RuntimeError, match="card"):
        chip_speed_factor(device="cpu")


def test_format_kernel_stats_renders_synthetic_rows():
    def row(name, cat, us, n=1, rate=None):
        r = {k: None for k in KERNEL_STAT_KEYS}
        r.update(kernel_name=name, category=cat, total_self_time=us,
                 occurrences=n, total_self_time_percent=50.0,
                 model_flop_rate=rate)
        return r

    rows = [row("si_matmul_mma_kernel<1>", "si:matmul", 200.0, 10, 1000.0),
            row("Memcpy HtoD", "copy", 100.0, 10)]
    text = format_kernel_stats(rows, top=5, iters=10)
    assert "si:matmul" in text and "Memcpy HtoD" in text
    # 300 us over 10 iters = 0.030 ms/iter
    assert "0.030 ms/iter" in text
    assert "1000" in text
    # empty capture should not crash
    assert "0.000 ms/iter" in format_kernel_stats([], iters=1)


@pytest.mark.parametrize("name,cat", [
    ("void si_matmul_mma_kernel<__nv_bfloat16, signed char>", "si:matmul"),
    ("si_matmul_int4w_kernel", "si:matmul_int4w"),
    ("si_int4w_mma_kernel<2>", "si:matmul_int4w"),
    ("si_s8s8_wgmma_kernel", "si:matmul_s8s8"),
    ("si_flash_mma_kernel", "si:flash_attention"),
    ("si_decode_split_kernel<bf16>", "si:decode_attention"),
    ("void c3_tc_kernel<1>", "si:c3_block"),
    ("sm90_xmma_fprop_implicit_gemm_bf16", "conv"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4>", "elementwise"),
    ("Memcpy DtoH (Device -> Pinned)", "copy"),
    ("something_else", "other")])
def test_kernel_categories(name, cat):
    assert kernel_category(name) == cat


def test_device_profile_cpu_trace_roundtrip(tmp_path):
    """trace -> key_averages -> rows on the CPU: the rows are CPU ops
    (no card), the Chrome trace is written, FLOPs given for a category
    give a rate."""
    x = torch.ones((64, 64))
    logdir = str(tmp_path / "tr")
    rows = device_profile(lambda a: (a @ a).sum(), x, iters=2,
                          logdir=logdir, flops={"cpu": 2 * 2 * 64 ** 3})
    assert rows and all(set(r) == set(KERNEL_STAT_KEYS) for r in rows)
    assert any("mm" in r["kernel_name"] for r in rows)
    assert all(r["category"] == "cpu" and r["model_flop_rate"] is not None
               for r in rows if r["total_self_time"] > 0)
    assert rows == sorted(rows, key=lambda r: -r["total_self_time"])
    with open(os.path.join(logdir, "trace.json")) as f:
        assert json.load(f)["traceEvents"]


def test_device_profile_capture_holds_only_the_timed_calls():
    """The untraced warm-up call and the traced-and-discarded one stay
    out of the capture: aten::mm counts `iters` calls, no step marker
    is a row, and `info` says one capture was taken."""
    x = torch.ones((16, 16))
    info: dict = {}
    rows = device_profile(lambda a: a @ a, x, iters=3, info=info)
    assert [r["occurrences"] for r in rows
            if r["kernel_name"] == "aten::mm"] == [3]
    assert not any(r["kernel_name"].startswith("ProfilerStep")
                   for r in rows)
    assert info == {"captures": 1,
                    "launches": [{"launched": 0, "recorded": 0}]}


def test_attribute_slices_segments_cover_program():
    """Segments partition the plan in order, every op in exactly one,
    FLOPs match the roofline estimator's totals; explicit cuts give one
    segment per op over the first three."""
    graph, in_name, _ = tzoo.build_resnet18(batch=1, image_size=32,
                                            num_classes=4, width=8)
    eng = Engine(EngineConfig(device="cpu", compute_dtype="float32")
                 ).load_model(None, graph=graph)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 32, 32, 3)).astype(np.float32))
    rows = attribute_slices(eng.program, eng._device_weights,
                            {in_name: x}, n_slices=4, iters=3,
                            verbose=False)
    assert len(rows) >= 2
    all_ops = [impl.name for impl, _, _ in eng.program.plan]
    seen = [op for _, ops, _, _ in rows for op in ops]
    assert seen == all_ops
    assert all(t >= 0 for _, _, t, _ in rows)
    want_flops = sum(_estimate_flops(
        impl, eng.program.op_output_shapes.get(impl.name, []))
        for impl, _, _ in eng.program.plan)
    assert sum(f for _, _, _, f in rows) == want_flops == \
        eng.program.flops_per_item
    rows = attribute_slices(eng.program, eng._device_weights,
                            {in_name: x}, cuts=[1, 2, 3], iters=3,
                            verbose=False)
    assert [len(ops) for _, ops, _, _ in rows[:3]] == [1, 1, 1]
    assert [op for _, ops, _, _ in rows for op in ops] == all_ops
    assert sum(f for _, _, _, f in rows) == want_flops


def test_roofline_table_lists_the_jax_ops():
    """The JAX package's roofline table and the port's list the same ops
    with the same FLOPs (the speed-of-light differs: the specs do)."""
    jp, tp = _programs("llama_nano")
    jt = j_summarize(jp, batch=1, top=50).splitlines()[2:]
    tt = summarize_roofline(tp, batch=1, top=50).splitlines()[2:]
    parted = JAX_LINEAR_ONE_ROW["llama_nano"]
    key = lambda ln: (ln[:28].strip(), ln[48:57].strip())  # noqa: E731
    assert sorted(k[0] for k in map(key, tt)) == \
        sorted(k[0] for k in map(key, jt))
    assert sorted(k for k in map(key, tt) if k[0] not in parted) == \
        sorted(k for k in map(key, jt) if k[0] not in parted)
