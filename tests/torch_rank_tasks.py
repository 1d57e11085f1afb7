"""Rank bodies of the port's parallel tests (tests/test_torch_parallel.py,
test_torch_mesh_engine.py, test_torch_tp_decode.py).

`multiproc.spawn("<this file>:<function>", ...)` runs each function on
every rank of a torch.distributed world of gloo ranks on the CPU; the
test process holds the results against the JAX package on its
simulated 8-device mesh. This module imports neither jax nor the JAX
package (the ranks run where only PyTorch is needed); the seeded inputs
live here so that both sides draw the same numbers.
"""
from __future__ import annotations

import numpy as np

WORLD = 4
# the tensor-parallel decode cases' world (and the JAX meshes they meet)
TP = 2


# ---- seeded inputs (both sides) -------------------------------------------
def tp_linear_inputs():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((4, 32)).astype(np.float32),
            rng.standard_normal((32, 64)).astype(np.float32),
            rng.standard_normal((64,)).astype(np.float32))


def tp_row_inputs():
    rng = np.random.default_rng(1)
    return (rng.standard_normal((4, 64)).astype(np.float32),
            rng.standard_normal((64, 48)).astype(np.float32),
            rng.standard_normal((48,)).astype(np.float32))


def tp_mlp_inputs():
    rng = np.random.default_rng(2)
    return (rng.standard_normal((4, 32)).astype(np.float32),
            rng.standard_normal((32, 128)).astype(np.float32),
            rng.standard_normal((128,)).astype(np.float32),
            rng.standard_normal((128, 32)).astype(np.float32),
            rng.standard_normal((32,)).astype(np.float32))


def tp_conv_inputs():
    rng = np.random.default_rng(5)
    return (rng.standard_normal((2, 8, 8, 16)).astype(np.float32),
            (rng.standard_normal((1, 1, 16, 32)) / 4).astype(np.float32),
            rng.standard_normal(32).astype(np.float32) * 0.1,
            (rng.standard_normal((3, 3, 32, 16)) / 17).astype(np.float32),
            rng.standard_normal(16).astype(np.float32) * 0.1)


def sp_conv_inputs():
    rng = np.random.default_rng(6)
    return (rng.standard_normal((2, 32, 8, 12)).astype(np.float32),
            (rng.standard_normal((3, 3, 12, 20)) / 10).astype(np.float32),
            rng.standard_normal(20).astype(np.float32) * 0.1)


def dp_mlp_inputs():
    rng = np.random.default_rng(9)
    return (rng.standard_normal((8, 24)).astype(np.float32),
            (rng.standard_normal((24, 32)) / 5).astype(np.float32),
            rng.standard_normal(32).astype(np.float32) * 0.1,
            (rng.standard_normal((32, 24)) / 6).astype(np.float32),
            rng.standard_normal(24).astype(np.float32) * 0.1)


def image(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _clock():
    """chip_smoke.CollectiveClock: the torch.distributed calls a block
    makes (the counterpart of reading collectives out of the JAX
    package's HLO)."""
    from chip_smoke import CollectiveClock

    return CollectiveClock()


def _take(clock) -> dict:
    """The calls counted so far, the counts then set to 0."""
    out = dict(clock.calls)
    for k in clock.calls:
        clock.calls[k] = 0
    return out


def _t(a):
    import torch

    return torch.from_numpy(np.asarray(a))


# ---- tests/test_torch_parallel.py -------------------------------------------
def parallel_cases() -> dict:
    """Every case of tests/test_parallel.py on this rank: mesh shapes and
    rules, multihost helpers, and each function of parallel/tp.py on this
    rank's shards, with the collectives it called."""
    import torch.nn.functional as F

    from simpleinfer_tpu_torch import MeshConfig
    from simpleinfer_tpu_torch.parallel import multihost, tp
    from simpleinfer_tpu_torch.parallel.mesh import (
        AXIS_DATA, AXIS_MODEL, AXIS_SPATIAL, build_mesh, input_sharding,
        shard_of, weight_shardings)

    with _clock() as clock:
        out = {}
        m22 = build_mesh(MeshConfig(data=2, model=2))
        out["shape_22"] = np.asarray(m22.shape)
        out["names"] = np.asarray(m22.mesh_dim_names)
        out["shape_sp"] = np.asarray(build_mesh(
            MeshConfig(data=2, spatial=2)).shape)
        out["none"] = np.asarray([build_mesh(MeshConfig()) is None,
                                  build_mesh(None) is None])
        try:
            build_mesh(MeshConfig(data=16, model=16))
            out["too_big"] = np.asarray("")
        except ValueError as e:
            out["too_big"] = np.asarray(str(e))
        m4 = build_mesh(MeshConfig(data=4))
        x = np.arange(16 * 4 * 4 * 3, dtype=np.float32).reshape(16, 4, 4, 3)
        out["input_shard"] = shard_of(x, input_sharding(m4, 4), m4)
        weights = {"weight": np.zeros((3, 3, 8, 16), np.float32),
                   "bias": np.zeros((16,), np.float32),
                   "other": np.zeros((5,), np.float32)}
        hints = {"weight": (None, None, None, "model"), "bias": ("model",)}
        out["wsh_22"] = np.asarray(repr(weight_shardings(m22, weights, hints)))
        out["wsh_4"] = np.asarray(repr(weight_shardings(m4, weights, hints)))

        # multihost, on 2 hosts of 2 ranks
        out["mh"] = np.asarray([multihost.process_count(),
                                multihost.process_index(),
                                multihost.is_primary(),
                                multihost.initialize() is not None])
        mm2 = multihost.make_mesh(model=2)
        out["mh_shape"] = np.asarray(mm2.shape)
        rows = np.arange(8 * 2, dtype=np.float32).reshape(8, 2)
        mh1 = multihost.make_mesh(model=1)
        host = rows[multihost.process_index() * 8 // 2:
                    (multihost.process_index() + 1) * 8 // 2]
        out["mh_local"] = np.asarray(
            multihost.host_local_batch(host, mh1).rank_rows())
        out["mh_gather"] = multihost.process_allgather(host)
        try:
            multihost.make_mesh(model=3)
            out["mh_bad"] = np.asarray(False)
        except ValueError:
            out["mh_bad"] = np.asarray(True)
        _take(clock)

        m8 = build_mesh(MeshConfig(model=4))
        x, w, b = tp_linear_inputs()
        col = tp.tp_linear_column(
            _t(x), _t(shard_of(w, (None, AXIS_MODEL), m8)),
            _t(shard_of(b, (AXIS_MODEL,), m8)), mesh=m8)
        out["col"], out["col_calls"] = col.numpy(), _take(clock)
        x, w, b = tp_row_inputs()
        row = tp.tp_linear_row(_t(shard_of(x, (None, AXIS_MODEL), m8)),
                               _t(shard_of(w, (AXIS_MODEL, None), m8)), _t(b),
                               mesh=m8)
        out["row"], out["row_calls"] = row.numpy(), _take(clock)
        x, w1, b1, w2, b2 = tp_mlp_inputs()
        shards = tp.shard_tp_weights(m8, *(_t(a) for a in (w1, b1, w2, b2)))
        out["mlp"] = tp.tp_mlp(_t(x), *shards, mesh=m8).numpy()
        out["mlp_calls"] = _take(clock)
        x, w1, b1, w2, b2 = tp_conv_inputs()
        cc = tp.tp_conv_column(
            _t(x), _t(shard_of(w1, (None,) * 3 + (AXIS_MODEL,), m8)),
            _t(shard_of(b1, (AXIS_MODEL,), m8)), mesh=m8)
        out["conv_col"] = cc.numpy()
        _take(clock)
        h = F.conv2d(_t(x).permute(0, 3, 1, 2), _t(w1).permute(3, 2, 0, 1),
                     _t(b1)).permute(0, 2, 3, 1)
        hs = shard_of(h, (None, None, None, AXIS_MODEL), m8)
        out["conv_row"] = tp.tp_conv_row(
            hs, _t(shard_of(w2, (None, None, AXIS_MODEL, None), m8)), _t(b2),
            mesh=m8).numpy()
        out["conv_pair"] = tp.tp_conv_pair(
            _t(x), _t(shard_of(w1, (None,) * 3 + (AXIS_MODEL,), m8)),
            _t(shard_of(b1, (AXIS_MODEL,), m8)),
            _t(shard_of(w2, (None, None, AXIS_MODEL, None), m8)), _t(b2),
            mesh=m8).numpy()
        out["conv_calls"] = _take(clock)
        msp = build_mesh(MeshConfig(spatial=4))
        x, w, b = sp_conv_inputs()
        out["sp"] = tp.sp_conv3x3_halo(
            _t(shard_of(x, (None, AXIS_SPATIAL), msp)), _t(w), _t(b), mesh=msp,
            axis=AXIS_SPATIAL).numpy()
        out["sp_calls"] = _take(clock)
        mdp = build_mesh(MeshConfig(data=2, model=2))
        x, w1, b1, w2, b2 = dp_mlp_inputs()
        shards = tp.shard_tp_weights(mdp, *(_t(a) for a in (w1, b1, w2, b2)))
        out["dp_mlp"] = tp.tp_mlp(
            _t(shard_of(x, (AXIS_DATA,), mdp)), *shards, mesh=mdp,
            batch_axis=AXIS_DATA).numpy()
        out["dp_mlp_calls"] = _take(clock)
        return out


# ---- tests/test_torch_mesh_engine.py ----------------------------------------
MESH_CASES = {
    # name: (builder kwargs, MeshConfig kwargs, engine kwargs)
    "r18_dp": ("resnet18", dict(batch=8, image_size=32, num_classes=4,
                                width=8), dict(data=4), {}),
    "r18_tp": ("resnet18", dict(batch=2, image_size=32, num_classes=4,
                                width=8), dict(data=2, model=2), {}),
    "vit_tp": ("vit", dict(variant="tiny", batch=2, image_size=32,
                           patch_size=8, num_classes=7, depth=2,
                           embed_dim=32, num_heads=4),
               dict(data=2, model=2), {}),
    "r18_sp": ("resnet18", dict(batch=1, image_size=32, num_classes=4,
                                width=8), dict(spatial=2, model=2), {}),
    "r18_sp1": ("resnet18", dict(batch=1, image_size=32, num_classes=4,
                                 width=8), dict(spatial=4), {}),
    "y5_spm": ("yolov5", dict(variant="n", batch=2, image_size=64),
               dict(spatial=2, model=2), {}),
    "y5_dsp": ("yolov5", dict(variant="n", batch=2, image_size=64),
               dict(data=2, spatial=2), {}),
    "int8_dp": ("resnet18", dict(batch=8, image_size=32, num_classes=4,
                                 width=8), dict(data=4), dict(quant="int8")),
    "int8_tp": ("resnet18", dict(batch=2, image_size=32, num_classes=8,
                                 width=16), dict(data=2, model=2),
                dict(quant="int8")),
}


def mesh_graph(zoo, kind: str, kw: dict):
    """(graph, input, output) of a MESH_CASES model from `zoo` (either
    package's)."""
    kw = dict(kw)
    if kind == "yolov5":
        return zoo.build_yolov5(kw.pop("variant"), **kw)
    return getattr(zoo, f"build_{kind}")(**kw)


def mesh_input(name: str, kw: dict) -> np.ndarray:
    n, s = kw["batch"], kw["image_size"]
    return image(sum(map(ord, name)), (n, s, s, 3))


def mesh_engine_cases() -> dict:
    """Every MESH_CASES model through a mesh engine of the world's 4
    ranks: the global output, and for int8 the installed scales."""
    import simpleinfer_tpu_torch.ops.conv as conv
    from simpleinfer_tpu_torch import Engine, EngineConfig, MeshConfig
    from simpleinfer_tpu_torch import zoo

    # the JAX tests' int8_min_channels=1, int8_pointwise=True
    conv.INT8_MIN_CHANNELS, conv.INT8_POINTWISE = 1, True
    with _clock() as clock:
        out = {}
        for name, (kind, kw, mesh, ekw) in MESH_CASES.items():
            graph, i, o = mesh_graph(zoo, kind, kw)
            eng = Engine(EngineConfig(device="cpu", mesh=MeshConfig(**mesh),
                                      **ekw)).load_model(None, graph=graph)
            x = mesh_input(name, kw)
            if ekw.get("quant") == "int8":
                scales = eng.calibrate([{i: x}])
                out[f"{name}_scales"] = {k: np.asarray(v)
                                         for k, v in scales.items()}
            _take(clock)
            out[name] = eng.run({i: x})[o]
            out[f"{name}_calls"] = _take(clock)
            out[f"{name}_modes"] = eng.op_modes
        return out


# ---- tests/test_torch_tp_decode.py ------------------------------------------
PROMPT = [[5, 1, 8], [2, 9, 3]]
SERVE_PROMPTS = ([5, 1, 8], [2, 9, 3, 4], [7, 7])
# the TP tiers: [7, 7] + 6 new tokens fits the 8-slot window, the other
# two prompts go to the full one
TP_TIERS = ((2, 8), (2, None))


def tp_graph(zoo, which: str):
    if which == "micro":
        return zoo.build_llama("micro", batch=1, seq_len=32, vocab_size=64)
    if which == "odd":          # 3 heads: indivisible by a 2-way axis
        return zoo.build_llama("nano", batch=1, seq_len=16, vocab_size=64,
                               width=48, num_heads=3, num_kv_heads=3)
    return zoo.build_gpt(variant="nano", batch=1, seq_len=16,
                         vocab_size=50, depth=2, width=32, num_heads=4)


def forward_ids(length: int, vals) -> np.ndarray:
    ids = np.zeros((1, length), np.float32)
    ids[0, :len(vals)] = vals
    return ids


def tp_decode_cases() -> dict:
    """TP decode on TP ranks: greedy tokens in both tp_modes, forward
    logits of ring and gspmd engines (llama micro, GPT nano), the
    indivisible-heads fallback, the kv heads a rank's cache holds, a
    data-axis decoder's refusal, sampled decode agreeing across ranks,
    and GenerationService and TieredGenerationService (TP_TIERS) on the
    TP engine in both modes, with the calls each tier's plan ran on
    every rank."""
    import torch.distributed as dist

    from simpleinfer_tpu_torch import Engine, EngineConfig, MeshConfig
    from simpleinfer_tpu_torch import zoo
    from simpleinfer_tpu_torch.serving.llm import (GenerationService,
                                                   TieredGenerationService)
    from simpleinfer_tpu_torch.zoo.generate import CachedDecoder

    with _clock() as clock:
        out = {"rank": np.asarray(dist.get_rank())}
        graph, i, o = tp_graph(zoo, "micro")
        for mode in ("gspmd", "ring"):
            eng = Engine(EngineConfig(device="cpu", mesh=MeshConfig(model=TP),
                                      tp_mode=mode)).load_model(None,
                                                                graph=graph)
            out[f"fwd_{mode}"] = eng.run(
                {i: forward_ids(32, [3, 7, 11, 2])})[o]
            dec = CachedDecoder(eng)
            _take(clock)
            out[f"tokens_{mode}"] = dec.generate(np.asarray(PROMPT), steps=8,
                                                 block=4)
            out[f"calls_{mode}"] = _take(clock)
            out[f"sampled_{mode}"] = dec.generate(
                np.asarray(PROMPT), steps=6, temperature=1.0, top_k=8, seed=3)
            leaf = next(iter(dec.init_cache(2).values()))[0]
            out["cache_shape"] = np.asarray(leaf.shape)
            svc = GenerationService(eng, slots=2, decode_horizon=3).warmup()
            svc.start()
            outs = []
            if not svc.follower:
                futs = [svc.submit(p, max_new=6) for p in SERVE_PROMPTS]
                outs = [f.result(timeout=60) for f in futs]
            else:
                try:
                    svc.submit([1, 2], max_new=2)
                    out["follower_submit"] = np.asarray(False)
                except RuntimeError:
                    out["follower_submit"] = np.asarray(True)
            svc.stop()
            out[f"served_{mode}"] = outs
            tsvc = TieredGenerationService(eng, tiers=TP_TIERS,
                                           decode_horizon=3).warmup()
            for s in tsvc.services:
                s._cast.log = []
            tsvc.start()
            outs = []
            if not tsvc.follower:
                futs = [tsvc.submit(p, max_new=6) for p in SERVE_PROMPTS]
                outs = [f.result(timeout=60) for f in futs]
            else:
                try:
                    tsvc.submit([7, 7], max_new=2)
                    out["tier_follower_submit"] = np.asarray(False)
                except RuntimeError:
                    out["tier_follower_submit"] = np.asarray(True)
            tsvc.stop()
            out[f"tiered_{mode}"] = outs
            out[f"tier_calls_{mode}"] = np.asarray(
                [len(s._cast.log) for s in tsvc.services])
        gg, gi, go = tp_graph(zoo, "gpt")
        for mode in ("gspmd", "ring"):
            eng = Engine(EngineConfig(device="cpu", mesh=MeshConfig(model=TP),
                                      tp_mode=mode)).load_model(None, graph=gg)
            out[f"gpt_{mode}"] = eng.run({gi: forward_ids(16, [3, 7, 11, 2,
                                                               9])})[go]
        og, oi, oo = tp_graph(zoo, "odd")
        eng = Engine(EngineConfig(device="cpu", mesh=MeshConfig(model=TP),
                                  tp_mode="ring")).load_model(None, graph=og)
        out["odd"] = eng.run({oi: forward_ids(16, [5, 1, 8])})[oo]
        out["odd_modes"] = eng.op_modes
        out["odd_tokens"] = CachedDecoder(eng).generate(np.asarray(PROMPT),
                                                        steps=6)
        eng = Engine(EngineConfig(device="cpu", mesh=MeshConfig(data=TP))
                     ).load_model(None, graph=tp_graph(zoo, "micro")[0])
        try:
            CachedDecoder(eng)
            out["data_refused"] = np.asarray("")
        except ValueError as e:
            out["data_refused"] = np.asarray(str(e))
        return out
