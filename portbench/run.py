"""Run one cell of the port's benchmark once, on the card it is started on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared for ``correct``
beside its limit, which also end standard error. Exits non-zero, printing
no result, without a CUDA device (or with fewer than the cell asks for),
or if JAX, jaxlib, flax or the JAX package was loaded by the run.

The kernels' build (``build/kernels/<hash>/``) and any Triton or
extension cache stay inside the checkout, at fixed paths.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up starts with the process

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHES = {"TRITON_CACHE_DIR": "build/triton", "TORCH_EXTENSIONS_DIR": "build/torch_extensions"}


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse(argv)
    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness, manifest

    bench = manifest.Manifest(ROOT / "BENCHMARK.json")
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                              "cuda", T_START)
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
