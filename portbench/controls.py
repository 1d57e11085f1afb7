"""The controls of `correct`: what each compared number reads when the
timed path computes in the next precision below the configuration's.

    python3 portbench/controls.py --workload <cell> --seeds 1 2 3

On a card, at the cell's own sizes. For each seed it prints one JSON
line with the readings:

- a YOLOv5s cell: `head_gap` of the program's own static-int8 path
  (`EngineConfig(quant="int8")`, calibrated on the batch it then runs:
  int8 activations below the bf16 ones of int8w), and of the reference
  with every conv input through float8 e4m3 (`models.fp8_round`), each
  against the float32 reference on the cell's first batch of frames;
- the GPT-2 cell: `logit_gap` of the token that the reference with every
  matmul input through float8 e4m3 puts first, on the float32
  reference's logits, over the first `check_requests` prompts of the
  cell's schedule (the longest among them).

The sound readings are those of the benchmark's own runs (`checks` in
their result lines). A limit lies between the two (PERF.md).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import harness, models, weights  # noqa: E402
from portbench.drivers import closed_loop_generate as gen  # noqa: E402
from portbench.drivers import offline_detect as det  # noqa: E402


def _gap(p, r) -> float:
    return float(((p.float() - r).abs() / r.abs().clamp(min=1.0)).max())


def yolo_controls(run) -> dict:
    from simpleinfer_tpu_torch import Engine, EngineConfig, zoo

    cfg, tr = run.config, run.traffic
    graph, in_name, out_name = zoo.build_yolov5(
        (cfg["depth_multiple"], cfg["width_multiple"]), batch=tr["batch"],
        image_size=cfg["image_size"], num_classes=cfg["nc"])
    made = weights.fill_graph(graph, run.seed, run.device)
    frames = det._frames(run)[0]
    eng = Engine(EngineConfig(compute_dtype=cfg["compute_dtype"],
                              quant="int8", device=run.device))
    eng.load_model(None, graph=graph)
    eng.calibrate([{in_name: frames}])
    eng.input(in_name, frames)
    eng.forward()
    int8_head = eng.extract(out_name, as_numpy=False).float()
    del eng
    imgs = frames.to(run.device)
    convs, head = models.yolo_weights(made, run.device)
    ref = models.yolo_reference(convs, head, imgs, cfg)
    fp8 = models.yolo_reference(convs, head, imgs, cfg,
                                lowp=models.fp8_round)
    return {"head_gap.int8_static": _gap(int8_head, ref),
            "head_gap.fp8_reference": _gap(fp8, ref)}


def gpt2_controls(run) -> dict:
    cfg, tr = run.config, run.traffic
    from simpleinfer_tpu_torch import zoo

    graph, _, _ = zoo.build_gpt(
        "small", seq_len=cfg["n_positions"], vocab_size=cfg["vocab_size"],
        depth=cfg["n_layer"], width=cfg["n_embd"], num_heads=cfg["n_head"])
    made = gen._as_published(graph, weights.fill_graph(
        graph, run.seed, run.device), cfg)
    del graph
    clients = gen._Clients(run, svc=None)
    n = tr["check_requests"]
    prompts = [clients.prompt(j) for j in range(n)]
    w = models.gpt2_weights(models.gpt2_raw(made, cfg, run.device), cfg,
                            cfg["int4_group"])
    ref = models.gpt2_reference(w, cfg, prompts)
    low = models.gpt2_reference(w, cfg, prompts, lowp=models.fp8_round)
    tok = low.argmax(-1)
    gap = ref.max(-1).values - ref.gather(1, tok[:, None])[:, 0]
    return {"logit_gap.fp8_reference": float(gap.max()),
            "fp8_tokens_differ": int((tok != ref.argmax(-1)).sum()),
            "prompts": n, "longest": max(len(p) for p in prompts)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    manifest = harness.load_manifest()
    _, _, config, traffic = harness.cell_spec(manifest, args.workload)
    if not torch.cuda.is_available():
        print("controls: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t = time.perf_counter()
        run = harness.Run(args.workload, config, traffic, seed, 0.0, False,
                          "cuda", t)
        fn = (gpt2_controls if traffic["driver"] == "closed_loop_generate"
              else yolo_controls)
        out = fn(run)
        out.update(workload=args.workload, seed=seed,
                   seconds=time.perf_counter() - t,
                   device=torch.cuda.get_device_name())
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
