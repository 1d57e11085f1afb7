"""Command-line tools of the PyTorch/CUDA port: the counterpart of
simpleinfer_tpu/tools.py.

- `dump`      print every operator, operand, param and attr of a model
- `detect`    letterbox -> engine -> NMS -> annotated image
- `classify`  argmax / top-k printout
- `segment`   per-pixel classes -> overlay image
- `calibrate` offline static-int8 calibration -> scales npz
- `serve`     HTTP inference server over a continuous-batching service

Every command that runs a model takes `--device` (default `cuda`): it
runs on the card unless asked for the CPU (`--device cpu`), and asking
for the card without one raises.

Usage: python -m simpleinfer_tpu_torch <command> [args]
"""
from __future__ import annotations

import argparse
import sys


def cmd_dump(args) -> int:
    from .ir.dtypes import type_to_string
    from .ir.graph import Graph

    g = Graph.load(args.param, args.bin)
    print(f"{len(g.ops)} operators, {len(g.operands)} operands")
    for op in g.ops:
        print(f"\n{op.type} {op.name}")
        for r in op.inputs:
            print(f"  in:  {r.name} {type_to_string(r.type)}{r.shape}")
        for r in op.outputs:
            print(f"  out: {r.name} {type_to_string(r.type)}{r.shape}")
        for k, p in op.params.items():
            print(f"  param {k} = {p.encode()}")
        for k, a in op.attrs.items():
            print(f"  attr {k}: {type_to_string(a.type)}{a.shape}"
                  f" ({a.nbytes} bytes)")
    return 0


def _load_engine(args):
    from . import Engine, EngineConfig

    quant = args.quant or ("int8w" if args.int8 else None)
    cfg = EngineConfig(compute_dtype=args.dtype, quant=quant,
                       device=args.device)
    return Engine(cfg).load_model(args.param, args.bin)


def _maybe_calibrate(eng, batch: "np.ndarray") -> None:
    """Static-int8 CLI flow: calibrate on the (preprocessed) inference
    batch itself — the demo-tool shortcut; production should calibrate
    on held-out data via Engine.calibrate."""
    if eng.config.quant == "int8":
        eng.calibrate([{eng.input_names[0]: batch}])


def cmd_detect(args) -> int:
    from .zoo.detect import detect_images
    from .zoo.imageio import draw_detections, imread, imwrite

    eng = _load_engine(args)
    images = [imread(p) for p in args.images]
    if eng.config.quant == "int8":
        import numpy as np

        from .zoo.detect import letterbox

        _maybe_calibrate(eng, np.stack(
            [letterbox(im, args.size)[0] for im in images]))
    results = detect_images(eng, images, size=args.size,
                            conf_thresh=args.conf, iou_thresh=args.iou,
                            device_decode=args.device_decode,
                            stage_uint8=args.stage_uint8)
    for path, img, dets in zip(args.images, images, results):
        print(f"{path}: {len(dets)} detections")
        for d in dets:
            x1, y1, x2, y2 = (int(v) for v in d.box)
            print(f"  {d.class_name:16s} {d.score:.3f} "
                  f"[{x1},{y1},{x2},{y2}]")
        if args.out:
            out_path = f"{args.out}/{path.split('/')[-1]}"
            imwrite(out_path, draw_detections(img, dets))
            print(f"  -> {out_path}")
    return 0


def cmd_classify(args) -> int:
    from .zoo.classify import classify_images
    from .zoo.imageio import imread

    eng = _load_engine(args)
    images = [imread(p, bgr=False) for p in args.images]
    if eng.config.quant == "int8":
        import numpy as np

        from .zoo.classify import preprocess_classify

        _maybe_calibrate(eng, np.stack(
            [preprocess_classify(im, args.size) for im in images]))
    for path, topk in zip(args.images,
                          classify_images(eng, images, size=args.size,
                                          k=args.topk)):
        print(f"{path}:")
        for cls, prob in topk:
            print(f"  class {cls}: {prob:.4f}")
    return 0


def cmd_segment(args) -> int:
    import numpy as np

    from .zoo.imageio import imread, imwrite
    from .zoo.segment import colorize_mask, segment_images

    eng = _load_engine(args)
    images = [imread(p) for p in args.images]
    masks = segment_images(eng, images, size=args.size or None)
    for path, img, m in zip(args.images, images, masks):
        classes, counts = np.unique(m, return_counts=True)
        top = sorted(zip(counts, classes), reverse=True)[:5]
        print(f"{path}: classes " + ", ".join(
            f"{c}({n}px)" for n, c in top))
        if args.out:
            out_path = f"{args.out}/{path.split('/')[-1]}"
            imwrite(out_path, colorize_mask(img, m))
            print(f"  -> {out_path}")
    return 0


def cmd_calibrate(args) -> int:
    """Offline static-int8 calibration: sample batches in -> reusable
    scales artifact out (Engine.save_calibration). Each sample file is
    an npz of {input name: batch array}; feed representative data."""
    import numpy as np

    from . import Engine, EngineConfig

    cfg = EngineConfig(compute_dtype=args.dtype, quant="int8",
                       act_clip_percentile=args.percentile,
                       act_per_channel=args.per_channel,
                       device=args.device)
    eng = Engine(cfg).load_model(args.param, args.bin)

    def batches():
        for path in args.samples:
            with np.load(path) as z:
                yield {k: z[k] for k in z.files}

    scales = eng.calibrate(batches())
    eng.save_calibration(args.out)
    print(f"calibrated {len(scales)} ops from {len(args.samples)} "
          f"sample file(s) -> {args.out}")
    return 0


def cmd_serve(args) -> int:
    """HTTP inference server: pnnx model -> continuous-batched endpoint
    (serving/http.py). Blocks until interrupted."""
    from .serving import BatchingService, InferenceServer

    eng = _load_engine(args)
    if eng.config.quant == "int8":
        if not args.calibration:
            raise SystemExit(
                "serve: static int8 needs offline calibration; pass "
                "--calibration scales.npz (from the calibrate command) "
                "or use --quant int8w")
        eng.load_calibration(args.calibration)
    post = None
    if args.device_decode:
        from .zoo.detect import decode_device

        post = (lambda o: decode_device(o, conf_thresh=args.conf,
                                        iou_thresh=args.iou,
                                        max_det=args.max_det))
    svc = BatchingService(eng, max_batch=args.max_batch,
                          max_wait_ms=args.max_wait_ms,
                          device_postprocess=post)
    if args.warmup:
        print("running buckets "
              f"{svc.buckets} ...", flush=True)
        svc.warmup(probe_spill=args.probe_spill)
        if args.probe_spill:
            print(f"spill-probed buckets: {svc.buckets}", flush=True)
    svc.start()
    server = InferenceServer(svc, host=args.host, port=args.port).start()
    host, port = server.address[:2]
    print(f"serving {args.param} on http://{host}:{port} "
          f"(POST /v1/infer, POST /v1/detect, GET /v1/stats, "
          f"GET /healthz)", flush=True)
    try:
        import time

        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        print("shutting down", flush=True)
    finally:
        server.stop()
        svc.stop(drain=False)
    return 0


def _add_model_args(p, quant_help=None) -> None:
    """--dtype, --int8, --quant and --device of a command that runs a
    model."""
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--int8", action="store_true",
                   help="shorthand for --quant int8w")
    p.add_argument("--quant", choices=["int8w", "int8", "int4w"],
                   help=quant_help)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; raises "
                        "without a card: pass --device cpu for the CPU)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="simpleinfer_tpu_torch",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("dump", help="print the pnnx IR of a model")
    p.add_argument("param")
    p.add_argument("bin", nargs="?")
    p.set_defaults(fn=cmd_dump)

    for name, fn in (("detect", cmd_detect), ("classify", cmd_classify)):
        p = sub.add_parser(name, help=f"{name} demo pipeline")
        p.add_argument("param")
        p.add_argument("bin")
        p.add_argument("images", nargs="+")
        p.add_argument("--size", type=int,
                       default=640 if name == "detect" else 224)
        _add_model_args(p, "int8w = weight-only; int8 = static "
                           "activation quant (calibrates on the input "
                           "batch)")
        if name == "detect":
            p.add_argument("--conf", type=float, default=0.25)
            p.add_argument("--iou", type=float, default=0.45)
            p.add_argument("--out", help="directory for annotated images")
            p.add_argument("--stage-uint8", action="store_true",
                           help="ship the letterboxed canvas as uint8 "
                                "bytes and normalize on the device (4x "
                                "fewer upload bytes)")
            p.add_argument("--device-decode", action="store_true",
                           help="run score-filter + NMS on the device "
                                "and fetch only the kept rows")
        else:
            p.add_argument("--topk", type=int, default=5)
        p.set_defaults(fn=fn)

    p = sub.add_parser("segment", help="semantic segmentation demo "
                                       "pipeline")
    p.add_argument("param")
    p.add_argument("bin")
    p.add_argument("images", nargs="+")
    p.add_argument("--size", type=int, default=0,
                   help="input size (default: model's declared size)")
    _add_model_args(p)
    p.add_argument("--out", help="directory for overlay images")
    p.set_defaults(fn=cmd_segment)

    p = sub.add_parser("serve", help="HTTP inference server "
                                     "(continuous batching)")
    p.add_argument("param")
    p.add_argument("bin", nargs="?")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    _add_model_args(p)
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    p.add_argument("--warmup", action="store_true",
                   help="run every bucket before accepting traffic")
    p.add_argument("--probe-spill", action="store_true",
                   help="with --warmup: drop buckets whose forwards hold "
                        "more temporaries than "
                        "serving.batcher.SPILL_BUDGET_BYTES (measured on "
                        "an H100; large offered loads are then served as "
                        "waves of the largest kept bucket)")
    p.add_argument("--calibration",
                   help="scales npz from the calibrate command "
                        "(required with --quant int8)")
    p.add_argument("--device-decode", action="store_true",
                   help="detection models: run score-filter + NMS on "
                        "the device; /v1/infer and /v1/detect return "
                        "[max_det, 6] rows instead of the raw head")
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--iou", type=float, default=0.45)
    p.add_argument("--max-det", type=int, default=300)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("calibrate",
                       help="offline static-int8 calibration -> "
                            "scales npz artifact")
    p.add_argument("param")
    p.add_argument("bin", nargs="?")
    p.add_argument("samples", nargs="+",
                   help="npz files of {input name: batch array}")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--percentile", type=float,
                   help="clip to this percentile of |x| instead of absmax")
    p.add_argument("--per-channel", action="store_true",
                   help="per-channel activation scales, SmoothQuant-"
                        "balanced and folded into the weights (zero "
                        "inference cost; helps skewed channel ranges). "
                        "Load the artifact with the same flag.")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    p.set_defaults(fn=cmd_calibrate)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
