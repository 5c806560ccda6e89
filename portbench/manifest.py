"""``BENCHMARK.json`` and the files it names, found by name.

A :class:`Manifest` reads the benchmark description and resolves, for one
cell, its configuration file, its traffic file, its limits file and the
readers of its per-layer metrics. Configuration files are named in the
manifest (relative to its directory); the others sit under the
benchmark's folder (the first of ``paths``) by name:
``traffic/<traffic>.json``, ``workloads/<cell>.json`` and
``layer_metrics/<metric>.py``, or for a metric split by cell
(``device_idle_pct.train``) the reader of the name before the first dot.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

# what a name and a unit may hold (the benchmark's contract)
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH_RE = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@dataclass
class Cell:
    """One entry of ``workloads`` with what it names, loaded."""

    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


class Manifest:
    def __init__(self, path: str | Path):
        self.path = Path(path).resolve()
        self.root = self.path.parent
        self.data = json.loads(self.path.read_text())
        self.base = self.root / self.data["paths"][0]

    # ---------------------------------------------------------------- lookups
    def _entry(self, key: str, name: str) -> dict:
        for e in self.data[key]:
            if e["name"] == name:
                return e
        known = ", ".join(e["name"] for e in self.data[key])
        raise KeyError(f"no {key[:-1]} named {name!r} (known: {known})")

    def cell(self, name: str) -> Cell:
        w = self._entry("workloads", name)
        conf = self._entry("configs", w["config"])
        config = json.loads((self.root / conf["file"]).read_text())
        traffic = json.loads((self.base / "traffic" / f"{w['traffic']}.json").read_text())
        limits_file = self.base / "workloads" / f"{name}.json"
        limits = json.loads(limits_file.read_text())["limits"]
        return Cell(
            name=name, config_name=w["config"], traffic_name=w["traffic"],
            chips=int(w["chips"]), config=config, traffic=traffic, limits=limits,
            end_to_end=[m for m in self.data["end_to_end"] if _reports(m, name)],
            per_layer=[m for m in self.data["per_layer"] if _reports(m, name)],
        )

    def reader(self, metric: str) -> ModuleType:
        """The reader of per-layer metric ``metric``:
        ``layer_metrics/<metric>.py`` under the benchmark's folder, else
        that of the name before its first dot."""
        path = self.base / "layer_metrics" / f"{metric}.py"
        if not path.is_file():
            path = path.with_name(f"{metric.split('.')[0]}.py")
        spec = importlib.util.spec_from_file_location(
            f"portbench_layer_metric_{metric.replace('.', '_').replace('-', '_')}", path)
        if spec is None or spec.loader is None:
            raise FileNotFoundError(path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    # ----------------------------------------------------------------- checks
    def problems(self) -> list[str]:
        """What in the manifest breaks the contract's form: names, units,
        keys, and which cells report what."""
        d, out = self.data, []
        if set(d) != TOP_KEYS:
            out.append(f"top-level keys {sorted(d)}")
        for p in d["paths"]:
            if not PATH_RE.match(p) or p.startswith("/") or ".." in p.split("/"):
                out.append(f"path {p!r}")
        if not (1 <= len(d["command"]) <= 32):
            out.append("command length")
        if not (isinstance(d["run_seconds"], int) and 1 <= d["run_seconds"] <= 51):
            out.append("run_seconds")
        names: dict[str, set] = {"configs": set(), "workloads": set(), "metrics": set()}
        for c in d["configs"]:
            _check_keys(out, c, {"name", "source", "file", "reduced", "why"})
            _name(out, c["name"], names["configs"])
            for k in c["reduced"]:
                _name(out, k, set())
            if not any(w["config"] == c["name"] for w in d["workloads"]):
                out.append(f"config {c['name']} has no cell")
            if not (self.root / c["file"]).is_file():
                out.append(f"config file {c['file']} missing")
            if not any(Path(c["file"]).parts[: len(Path(p).parts)] == Path(p).parts
                       for p in d["paths"]):
                out.append(f"config file {c['file']} outside paths")
        for w in d["workloads"]:
            _check_keys(out, w, {"name", "config", "traffic", "chips", "why"})
            _name(out, w["name"], names["workloads"])
            _name(out, w["traffic"], set())
            if w["chips"] not in (1, 4):
                out.append(f"cell {w['name']} chips {w['chips']}")
            for text in (w["why"],):
                if not (1 <= len(text) <= 200) or "\n" in text or "\t" in text:
                    out.append(f"cell {w['name']} why")
        pairs = [(w["config"], w["traffic"]) for w in d["workloads"]]
        if len(pairs) != len(set(pairs)):
            out.append("a (config, traffic) pair appears twice")
        e2e = {m["name"]: m for m in d["end_to_end"]}
        if "setup_s" not in e2e:
            out.append("no setup_s")
        for m in d["end_to_end"]:
            _check_keys(out, m, {"name", "unit", "better", "bound", "source"},
                        optional={"workloads"})
            _metric(out, m, names["metrics"])
            if m["source"] not in ("host_clock", "device_trace"):
                out.append(f"{m['name']} source")
            if not (0.01 <= m["bound"] <= 0.25):
                out.append(f"{m['name']} bound {m['bound']}")
        for m in d["per_layer"]:
            _check_keys(out, m, {"name", "unit", "better", "source", "layer", "moves"},
                        optional={"workloads"})
            _metric(out, m, names["metrics"])
            if m["moves"] not in e2e:
                out.append(f"{m['name']} moves unknown {m['moves']}")
                continue
            if not (1 <= len(m["layer"]) <= 200) or "\n" in m["layer"]:
                out.append(f"{m['name']} layer")
            for cell in m.get("workloads", names["workloads"]):
                if not _reports(e2e[m["moves"]], cell):
                    out.append(f"{m['name']}: cell {cell} does not report {m['moves']}")
            if (m["name"].endswith("_roofline") or "mfu" in m["name"]) and m["unit"] != "%":
                out.append(f"{m['name']} unit")
        for w in d["workloads"]:
            reported = [m for m in d["end_to_end"] if _reports(m, w["name"])]
            if len(reported) < 2:
                out.append(f"cell {w['name']} reports no end-to-end metric besides setup_s")
            if not any(_reports(m, w["name"]) for m in d["per_layer"]):
                out.append(f"cell {w['name']} reports no per-layer metric")
        for m in [*d["end_to_end"], *d["per_layer"]]:
            for cell in m.get("workloads", ()):
                if cell not in names["workloads"]:
                    out.append(f"{m['name']} names unknown cell {cell}")
        return out


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _check_keys(out: list, entry: dict, keys: set, optional: set = frozenset()) -> None:
    have = set(entry)
    if not keys <= have or have - keys - optional:
        out.append(f"{entry.get('name')}: keys {sorted(have)}")


def _name(out: list, name: str, seen: set) -> None:
    if not NAME_RE.match(name):
        out.append(f"name {name!r}")
    if name in seen:
        out.append(f"name {name!r} twice")
    seen.add(name)


def _metric(out: list, m: dict, seen: set) -> None:
    _name(out, m["name"], seen)
    if not UNIT_RE.match(m["unit"]):
        out.append(f"{m['name']} unit {m['unit']!r}")
    if m["better"] not in ("lower", "higher"):
        out.append(f"{m['name']} better")
    if m["source"] not in SOURCES:
        out.append(f"{m['name']} source")


def module(kind: str, name: str) -> ModuleType:
    """``portbench.<kind>.<name>``: a driver or a model family."""
    if not NAME_RE.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return importlib.import_module(f"portbench.{kind}.{name}")
