"""The readings that the limits of ``correct`` are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --first-seed <n> --seeds 12
        --control-seeds 3 [--seconds 2] [--out FILE]

For each of ``--seeds`` seeds (``--first-seed`` on), in one process: the
cell's set-up, a short window at the cell's own load (``--seconds``), and
the numbers compared for ``correct`` (the program's readings). For the
first ``--control-seeds`` of them also the control's readings (the plain
reference computed in fp8 put in the program's place) and, for a training
cell, a planted fault's (half of each batch left out, the mean taken over
the rest). Prints one JSON object a seed and a summary: the largest
program reading and the smallest control and fault reading of each number.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness, manifest

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    bench = manifest.Manifest(ROOT / "BENCHMARK.json")
    cell = bench.cell(args.workload)
    rows = []
    for i in range(args.seeds):
        seed = args.first_seed + i
        t0 = time.perf_counter()
        ctx = harness.context(cell, seed, "cuda")
        driver = manifest.module("drivers", cell.traffic["driver"]).Driver(ctx)
        harness.window(driver, args.seconds, None, 0, 0)
        driver.release()
        row = {"seed": seed, "program": driver.numbers()}
        if i < args.control_seeds:
            row["control"] = driver.control_numbers()
            if hasattr(driver, "fault_numbers"):
                row["half_batch"] = driver.fault_numbers()
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
        del driver
    summary = {"workload": args.workload, "seeds": [r["seed"] for r in rows],
               "program_max": {}, "control_min": {}, "half_batch_min": {}}
    for r in rows:
        for kind, agg, key in (("program", max, "program_max"), ("control", min, "control_min"),
                               ("half_batch", min, "half_batch_min")):
            for name, v in r.get(kind, {}).items():
                summary[key][name] = agg(summary[key].get(name, v), v)
    print(json.dumps(summary))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
