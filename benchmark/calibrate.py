"""Readings for the limits of a cell's comparison, on the card, many seeds
in one process (the benchmark's own runs do not run this):

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... \\
        [--kinds control ...] [--seconds 1]

For each seed: the cell's set-up (a training cell's first steps), a short
window at the cell's own load for a cell that answers calls, the numbers
compared (the program's readings), then the same numbers with each
``kind`` in the program's place: "control" (the reference one precision
below the configuration's), and planted faults ("short_band" for the hard
cells; "half_batch", "unchanged" for the training cells). One JSON line a
seed on standard output."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--kinds", nargs="*", default=["control"])
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)

    import torch

    from benchmark.harness import device, runner

    why = device.missing_cards(1)
    if why:
        print(f"calibrate: {why}", file=sys.stderr)
        return 3
    print(f"card: {device.power_limit()}", file=sys.stderr)
    for seed in args.seeds:
        run, driver = runner.prepare(args.workload, seed, "cuda")
        t0 = time.perf_counter()
        driver.setup()
        row = {"seed": seed, "setup_s": time.perf_counter() - t0}
        if hasattr(driver, "samples"):
            runner.window(driver, args.seconds)
            row["units"] = driver.units
        driver.release()
        t0 = time.perf_counter()
        row["program"] = {c.name: c.value for c in driver.check()}
        row["check_s"] = time.perf_counter() - t0
        for kind in args.kinds:
            row[kind] = {c.name: c.value for c in driver.readings(kind)}
        print(json.dumps(row), flush=True)
        del run, driver
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
