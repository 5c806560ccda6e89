"""Import guards of the PyTorch port: it never imports jax or flax, and its
kernel modules import (and refuse to build) without nvcc or a CUDA device."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import pose_estimation_amitai_torch
from pose_estimation_amitai_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str, env: dict) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def _port_modules() -> list[str]:
    pkg = pose_estimation_amitai_torch
    return [pkg.__name__] + [
        m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
    ]


def test_every_port_module_imports_without_jax():
    mods = _port_modules()
    assert {"pose_estimation_amitai_torch.infer",
            "pose_estimation_amitai_torch.ops.hopper_conv",
            "pose_estimation_amitai_torch.ops.hopper_deconv",
            "pose_estimation_amitai_torch.weights"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'pose_estimation_amitai_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    r = _run(code, dict(os.environ))
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def test_kernel_modules_import_and_refuse_without_nvcc_or_cuda():
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env.update(PATH="/usr/bin:/bin", CUDA_VISIBLE_DEVICES="")
    code = (
        "import torch\n"
        "from pose_estimation_amitai_torch.ops import _build, hopper_conv, hopper_deconv\n"
        "assert not torch.cuda.is_available()\n"
        "x = torch.rand(1, 8, 8, 4); w = torch.rand(3, 3, 4, 8); b = torch.rand(8)\n"
        "w2 = torch.rand(3, 3, 8, 8)\n"
        "assert hopper_conv.fused_encoder_stage(x, w, b, w2, b, w2, b).shape == (1, 4, 4, 8)\n"
        "for name in ('encoder_stage', 'decoder'):\n"
        "    try:\n"
        "        _build.load(name)\n"
        "    except RuntimeError as e:\n"
        "        assert 'CUDA device' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('built without a CUDA device')\n"
        "print('ok')\n"
    )
    r = _run(code, env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_find_nvcc_raises_without_toolkit(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_sources_and_hash():
    names = sorted(p.name for p in _build._sources())
    assert names == ["decoder.cu", "encoder_stage.cu"]
    assert _build._source_hash() == _build._source_hash()
    assert "-gencode" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.BUILD_ROOT.relative_to(ROOT).as_posix() == "build/kernels"
    for p in _build._sources():  # each kernel names the Pallas function it replaces
        assert "Replaces pose_estimation_amitai_tpu/ops/pallas_" in p.read_text()


def test_load_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        _build.load("encoder_stage")
