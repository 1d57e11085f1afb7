"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. The last line of standard output is one JSON object (correct,
attempted, failed, metrics, device, with --trace 1 breakdown, and the
numbers compared with their limits under `checks`); the last lines of
standard error repeat the numbers compared. Exits 2, printing no
result, without enough CUDA cards, and 3 when the run loaded JAX or the
JAX package.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    harness.set_cache_dirs()
    manifest = harness.load_manifest()
    cell = harness.cell_spec(manifest, args.workload)[0]
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch sees {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    run, result = harness.run_cell(args.workload, args.seed, args.seconds,
                                   bool(args.trace), "cuda", manifest,
                                   t_start=T_START)
    forbidden = sorted(set(run.forbidden) | set(harness.forbidden_modules()))
    if forbidden:
        print(f"portbench: the run loaded {forbidden}, which the "
              f"benchmark must not load", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
