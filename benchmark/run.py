"""The benchmark of chaq_sdfgen_tpu_torch, one cell a run:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It finds the cell in BENCHMARK.json and its
files by name (harness/manifest.py), makes its inputs on the card from the
seed, warms up, measures for ``--seconds`` (with ``--trace 1``, reads a
profiled sub-window instead), checks the answers against the plain
reference, and prints one JSON line last on standard output. It exits
non-zero and prints no result without enough NVIDIA cards, or when JAX or
the JAX package is loaded."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT  # the checkout's root, not benchmark/: the harness imports as benchmark.*


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark.harness import device, manifest, runner

    try:
        chips = manifest.resolve(manifest.load(), args.workload).chips
    except (OSError, KeyError, ValueError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    why = device.missing_cards(chips)
    if why:
        print(f"benchmark: {why}; no result", file=sys.stderr)
        return 3
    try:
        result = runner.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    except runner.IsolationError as e:
        print(f"benchmark: {e}; no result", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
