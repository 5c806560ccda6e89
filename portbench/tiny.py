"""A copy of the benchmark at a size a CPU test run can hold, in a
directory of its own: the same manifest, drivers, families, limits and
readers, with 48x48 frames, narrow models, 16-frame chunks and short
traffic, and the cells held out of ``BENCHMARK.json`` (``held/``) put
back. For the tests in this folder."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from .manifest import Manifest

ROOT = Path(__file__).resolve().parent.parent
SMALL_TRAFFIC = dict(movie_frames=64, warmup_frames=32, check_chunks=2, min_frames=5,
                     max_frames=40, length_set=8, buffer_frames=96, check_clips=3,
                     pool_samples=64, batch=8, margin=6, trace_units=2, trace_skip=1)


def window_seconds(cell: str, seconds: float) -> float:
    """A tiny run's window: ``seconds``, or for the training cell at least
    1.5 s, some tens of tiny steps, so that the window's stretch is late in
    the run as the cell's 30-s window is (its loss gap falls from the first
    steps' 1e-3 to 1e-4 within about 20 steps)."""
    return max(seconds, 1.5) if cell.endswith(".train") else seconds


def small_config(spec: dict) -> dict:
    spec = copy.deepcopy(spec)
    spec["image_shape"] = [48, 48, spec["image_shape"][2]]
    spec["chunk_size"] = 16
    if spec["family"] == "basicnet":
        spec["filters"] = 8
        spec["port_config"]["num_base_filters"] = 8
    else:
        spec.update(dim=32, depth=2, heads=2, dim_head=32)
        spec["port_config"].update(projection_dim=32, num_heads=2, transformer_layers=2)
    return spec


def with_held(data: dict, base: Path) -> dict:
    """``data`` (a manifest's) with the entries of each cell held out of the
    benchmark (``held/<cell>.json`` under its folder ``base``: its cell and
    the metrics only it reports, as ``BENCHMARK.json`` would list them)
    added, so that their drivers and readers stay tested."""
    data = copy.deepcopy(data)
    for f in sorted((base / "held").glob("*.json")):
        for key, entries in json.loads(f.read_text()).items():
            data[key].extend(entries)
    return data


def tiny_manifest(tmp: str | Path, real: str | Path = ROOT / "BENCHMARK.json") -> Manifest:
    """Write the small copy under ``tmp`` (its folder ``pb``) and return it."""
    tmp = Path(tmp)
    real = Manifest(real)
    base = tmp / "pb"
    for sub in ("configs", "traffic", "workloads"):
        (base / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(real.base / "layer_metrics", base / "layer_metrics", dirs_exist_ok=True)
    data = with_held(real.data, real.base)
    data["paths"] = ["pb"]
    for c in data["configs"]:
        spec = small_config(json.loads((real.root / c["file"]).read_text()))
        c["file"] = f"pb/configs/{c['name']}.json"
        (tmp / c["file"]).write_text(json.dumps(spec))
    for w in data["workloads"]:
        t = json.loads((real.base / "traffic" / f"{w['traffic']}.json").read_text())
        t.update({k: v for k, v in SMALL_TRAFFIC.items() if k in t})
        (base / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(t))
        shutil.copy(real.base / "workloads" / f"{w['name']}.json",
                    base / "workloads" / f"{w['name']}.json")
    (tmp / "BENCHMARK.json").write_text(json.dumps(data))
    return Manifest(tmp / "BENCHMARK.json")
