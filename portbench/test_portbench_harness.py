"""CPU tests of the port's benchmark, at the size of ``portbench.tiny``.

Run them with ``python -m pytest portbench -m '' -p no:cacheprovider``
(the repository's pytest settings select ``quick`` tests by default).
They need no card: the port's kernel wrappers run their plain versions on
CPU tensors, and the harness is driven below its look for a card.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import compare, harness, manifest, run, serving, work
from portbench.families import basicnet, vit
from portbench.tiny import tiny_manifest, window_seconds, with_held

ROOT = Path(__file__).resolve().parent.parent
CELLS = ["basicnet.movie", "vit.movie", "basicnet.train", "basicnet.clips"]
SEED = 2**31 + 4321  # more than 32 signed bits hold, as the driver's seeds


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_manifest(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(tiny, cell, trace):
    c = tiny.cell(cell)
    r = harness.run_cell(tiny, c, SEED, window_seconds(cell, 0.5), trace, "cpu", 0.0)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks" and set(r["checks"]) == set(c.limits)
    assert r["attempted"] >= 1 and r["failed"] == 0
    wanted = c.per_layer if trace else c.end_to_end
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        # no device on the CPU: the rooflines find nothing to read
        wanted = [m for m in wanted if not m["name"].endswith("_roofline")]
    assert {m["name"] for m in wanted} <= set(r["metrics"])
    json.dumps(r)


def test_same_seed_same_inputs(tiny):
    c = tiny.cell("basicnet.clips")
    drivers = [manifest.module("drivers", "clips").Driver(harness.context(c, s, "cpu"))
               for s in (SEED, SEED, SEED + 1)]
    a, b, other = drivers
    assert np.array_equal(a.buffer, b.buffer) and not np.array_equal(a.buffer, other.buffer)
    rounds = 3 * len(a.lengths)
    seq = [[d._next() for _ in range(rounds)] for d in drivers]
    assert seq[0] == seq[1] and seq[0] != seq[2]
    # every seed offers the same clip lengths, each round in an order of its own
    lengths = [sorted(n for _, n in s) for s in seq]
    assert lengths[0] == lengths[2] == sorted(np.tile(a.lengths, 3).tolist())


def test_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "basicnet.movie", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_refuses_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's folder,
    the command fails and prints no result."""
    (tmp_path / "portbench").mkdir()
    for f in (ROOT / "portbench").rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts:
            dst = tmp_path / f.relative_to(ROOT)
            dst.parent.mkdir(parents=True, exist_ok=True)
            dst.write_bytes(f.read_bytes())
    (tmp_path / "BENCHMARK.json").write_bytes((ROOT / "BENCHMARK.json").read_bytes())
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "basicnet.movie",
                        "--seed", "1", "--seconds", "1"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_work_counts():
    spec = json.loads((ROOT / "portbench/configs/basicnet_flagship.json").read_text())
    # the encoder and decoder of one 192x192x4 -> 18 frame
    enc = sum(work.stage_ops(1, h, h, cin, cout)
              for h, cin, cout in ((192, 4, 64), (96, 64, 128), (48, 128, 256)))
    pix = 48 * 48
    dec = 2.0 * 9 * pix * (256 * 128 + 2 * 4 * 128 * 128 + 4 * 128 * 18)
    assert enc == pytest.approx(19.19e9, rel=1e-3) and dec == pytest.approx(7.18e9, rel=1e-3)
    assert basicnet.flops_per_frame(spec) == pytest.approx(enc + dec, rel=1e-12)
    # each call's bound at a 256-frame chunk, as chip_smoke.py's arithmetic gives it
    b = basicnet.kernel_bounds(spec, 256)
    stages = b["pose_estimation::fused_encoder_stage"]
    for got, (h, cin, cout) in zip(stages, ((192, 4, 64), (96, 64, 128), (48, 128, 256))):
        ms, by = work.bound(work.stage_ops(256, h, h, cin, cout), "bf16", 0)
        assert got == pytest.approx(ms * 1e-3, rel=1e-12) and by == "operations"
    assert [round(s * 1e3, 3) for s in stages] == [1.451, 1.759, 1.759]
    assert round(b["pose_estimation::fused_decoder"][0] * 1e3, 3) == 1.858
    # the ViT, counted by hand: patch conv, 8 blocks, 4 transposed convs
    vspec = json.loads((ROOT / "portbench/configs/vit_per_wing.json").read_text())
    n, d, inner, mlp = 144, 256, 8 * 256, 1024
    block = 2 * n * (d * 3 * inner + inner * d + 2 * d * mlp) + 2 * 2 * 8 * n * n * 256
    decoder = 2 * 9 * 256 * (144 * 256 + 576 * 256 + 2304 * 256 + 9216 * 18)
    patch = 2 * n * 1024 * d
    assert vit.flops_per_frame(vspec) == pytest.approx(patch + 8 * block + decoder, rel=1e-12)
    assert (patch + 8 * block) == pytest.approx(7.47e9, rel=1e-3)
    att = vit.kernel_bounds(vspec, 256)["pose_estimation::fused_attention"]
    assert len(att) == 8 and round(att[0] * 1e3, 3) == 0.180  # bytes-bound


@pytest.mark.parametrize("family", ["basicnet", "vit"])
def test_reference_matches_the_port(family):
    """The plain reference against the port's module route in float32 on the
    same seeded flax-layout weights, maps within 1e-4 of their range."""
    from pose_estimation_amitai_torch.infer import Predictor

    from portbench import program
    from portbench.tiny import small_config
    from portbench.weights import make_tree

    name = "basicnet_flagship" if family == "basicnet" else "vit_per_wing"
    spec = small_config(json.loads((ROOT / f"portbench/configs/{name}.json").read_text()))
    fam = manifest.module("families", family)
    tree, dev = make_tree(fam.leaves(spec), SEED, torch.device("cpu"))
    pred = Predictor(program.port_config(spec, compute_dtype="float32"), tree,
                     tuple(spec["image_shape"]), spec["out_channels"], device="cpu",
                     chunk_size=8, return_heatmaps=True)
    frames = torch.rand((8, *spec["image_shape"]), generator=torch.Generator().manual_seed(3))
    maps, _ = pred(frames.numpy())
    ref = fam.forward(dev, frames, spec).numpy()
    rng = ref.max() - ref.min()
    assert np.abs(maps - ref).max() <= 1e-4 * rng


@pytest.mark.parametrize("size,rotation", [(48, 30.0), (192, 30.0), (192, 180.0)])
def test_reference_warp_matches_the_port(size, rotation):
    """The training reference's float64 separable warp, worked out from its
    definition, against the port's float32 warp on the same drawn matrices:
    each bucket, the quarter turns, flips and shifts; within 2e-4 of [0, 1)
    frames. The exact two-dimensional warp is a different function (its
    gap is printed)."""
    from pose_estimation_amitai_torch.ops import affine

    from portbench import augment

    gen = torch.Generator().manual_seed(5)
    img = torch.rand((4, size, size, 4), generator=gen, dtype=torch.float64)
    for low, high, quad in augment._buckets(rotation) or [(0.0, rotation, False)]:
        params = augment._sample_params(gen, 4, high, 10.0, (0.9, 1.1), True, True, low, quad)
        mats = augment.forward_matrices(*params, size, size)
        ref = augment.warp_separable(img, mats)
        prog = affine.affine_warp_separable_batch(img.float(), mats.float(), 3,
                                                  affine._shear_limit(high))
        assert (prog.double() - ref).abs().max() <= 2e-4
        exact = affine.affine_warp_batch(img.float(), mats.float(), 3).double()
        print(f"{size} px, {low:g} to {high:g} deg: the exact warp's rms gap "
              f"{float((exact - ref).norm() / ref.norm()):.3f}")


def test_no_jax_in_a_run():
    """A run of every cell loads neither JAX, jaxlib, flax nor the JAX
    package (a fresh interpreter: the test process may hold them)."""
    code = (
        "import sys, tempfile; sys.path.insert(0, %r)\n"
        "from portbench import harness\n"
        "from portbench.tiny import tiny_manifest\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    b = tiny_manifest(d)\n"
        "    for c in %r:\n"
        "        harness.run_cell(b, b.cell(c), 5, 0.2, False, 'cpu', 0.0)\n"
        "print(harness.forbidden_modules(sys.modules))\n" % (str(ROOT), CELLS))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole_top_level_names():
    found = harness.forbidden_modules(
        ["jax", "jaxlib.xla_client", "flax.linen", "pose_estimation_amitai_tpu.ops",
         "pose_estimation_amitai_torch", "pose_estimation_amitai_torch.infer", "jax_like",
         "myjax", "numpy"])
    assert found == ["flax.linen", "jax", "jaxlib.xla_client", "pose_estimation_amitai_tpu.ops"]


def test_the_benchmark_and_its_harness_import_no_jax():
    for f in (ROOT / "portbench").rglob("*.py"):
        for line in f.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in harness.FORBIDDEN, (f, line)


def test_references_import_nothing_of_the_port():
    for f in ["families/__init__.py", "families/basicnet.py", "families/vit.py",
              "augment.py", "train_reference.py", "compare.py", "work.py", "weights.py"]:
        text = (ROOT / "portbench" / f).read_text()
        assert "pose_estimation_amitai" not in text.replace('"pose_estimation::', ""), f


def test_manifest_keeps_the_contract(tmp_path):
    bench = manifest.Manifest(ROOT / "BENCHMARK.json")
    assert bench.problems() == []
    d = bench.data
    assert [c["name"] for c in d["configs"]] == ["basicnet_flagship"]
    assert {m["name"] for m in d["end_to_end"]} == {"serve_fps", "clip_p95_ms", "setup_s"}
    # the held-out cells' entries, put back as they are, keep the contract too
    held = with_held(d, bench.base)
    assert [c["name"] for c in held["configs"]] == ["basicnet_flagship", "vit_per_wing"]
    assert {w["name"] for w in held["workloads"]} - {w["name"] for w in d["workloads"]} == {
        "basicnet.train", "vit.movie"}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(held))
    (tmp_path / "portbench").symlink_to(ROOT / "portbench")
    assert manifest.Manifest(tmp_path / "BENCHMARK.json").problems() == []
    for m in d["per_layer"]:
        assert m["moves"] in {e["name"] for e in d["end_to_end"]}
        for cell in m["workloads"]:
            bench.cell(cell)  # every file it names is there
            assert bench.reader(m["name"]).read is not None


def test_manifest_problems_are_found(tmp_path):
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    data["per_layer"][0]["unit"] = "frames per s"
    mfu = next(m for m in data["per_layer"] if m["name"] == "serve_mfu")
    mfu["workloads"] = ["basicnet.clips"]  # reports no serve_fps
    data["configs"].append(dict(data["configs"][0], name="unused"))
    data["workloads"][0]["name"] = "bad name"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    (tmp_path / "portbench").symlink_to(ROOT / "portbench")
    text = " | ".join(manifest.Manifest(tmp_path / "BENCHMARK.json").problems())
    for want in ("unit 'frames per s'", "does not report serve_fps", "unused has no cell",
                 "name 'bad name'"):
        assert want in text


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric added as
    new files and manifest entries only run without an edit elsewhere."""
    bench = tiny_manifest(tmp_path)
    data = bench.data
    base = bench.base
    spec = json.loads((base / "configs/basicnet_flagship.json").read_text())
    spec["filters"] = spec["port_config"]["num_base_filters"] = 16
    (base / "configs/basicnet_wide.json").write_text(json.dumps(spec))
    data["configs"].append({"name": "basicnet_wide", "source": "https://example.org/wide",
                            "file": "pb/configs/basicnet_wide.json", "reduced": [],
                            "why": "a wider BasicNet"})
    traffic = json.loads((base / "traffic/movie.json").read_text())
    traffic["prefetch"] = 1
    (base / "traffic/movie_serial.json").write_text(json.dumps(traffic))
    data["workloads"].append({"name": "wide.movie_serial", "config": "basicnet_wide",
                              "traffic": "movie_serial", "chips": 1, "why": "a new cell"})
    (base / "workloads/wide.movie_serial.json").write_text(
        (base / "workloads/basicnet.movie.json").read_text())
    (base / "layer_metrics/frames_traced.py").write_text(
        "def read(t):\n    return float(t.useful) if t.useful else None\n")
    data["per_layer"].append({"name": "frames_traced", "unit": "frames", "better": "higher",
                              "source": "program_counter", "layer": "infer.Predictor",
                              "moves": "serve_fps", "workloads": ["wide.movie_serial"]})
    for m in data["end_to_end"]:
        if m["name"] == "serve_fps":
            m["workloads"].append("wide.movie_serial")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    bench = manifest.Manifest(tmp_path / "BENCHMARK.json")
    assert bench.problems() == []
    cell = bench.cell("wide.movie_serial")
    assert cell.config["filters"] == 16 and cell.traffic["prefetch"] == 1
    r = harness.run_cell(bench, cell, SEED, 0.2, True, "cpu", 0.0)
    assert r["correct"] and r["metrics"]["frames_traced"]["value"] > 0


def test_peak_numbers():
    maps = torch.zeros((2, 8, 8, 3))
    maps[:, 2, 5, :] = 1.0
    maps[:, 4, 4, :] = 0.5
    served = np.zeros((2, 3, 3), np.float32)
    served[:, 0], served[:, 1], served[:, 2] = 5, 2, 1.0
    assert compare.peak_numbers(maps, served, "raw") == {"peak_gap": 0.0, "val_err": 0.0}
    served[1, :2, 0] = 4  # the second-best position
    got = compare.peak_numbers(maps, served, "raw")
    assert got["peak_gap"] == pytest.approx(0.5) and got["val_err"] == pytest.approx(0.5)
    served[0, 0, 1] = 8.0  # off the grid
    assert math.isinf(compare.peak_numbers(maps, served, "raw")["peak_gap"])
    served[0, 0, 1] = np.nan
    assert math.isinf(compare.peak_numbers(maps, served, "raw")["val_err"])


def test_fp8_rounds_and_passes_gradients():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = compare.fp8(x)
    assert 0 < (y - x).abs().max() < 0.1 * 3 and len(torch.unique(y.detach())) < 101
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


def test_argmax_peaks():
    maps = torch.rand((3, 6, 7, 2))
    pts = serving.argmax_peaks(maps)
    assert compare.peak_numbers(maps, pts, "minmax") == {"peak_gap": 0.0, "val_err": 0.0}
