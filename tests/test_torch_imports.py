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
            "pose_estimation_amitai_torch.ops.hopper_qconv",
            "pose_estimation_amitai_torch.ops.hopper_attention",
            "pose_estimation_amitai_torch.ops.hopper_probes",
            "pose_estimation_amitai_torch.ops.int8_conv",
            "pose_estimation_amitai_torch.models.quantized",
            "pose_estimation_amitai_torch.models.quantized_generic",
            "pose_estimation_amitai_torch.models.vit",
            "pose_estimation_amitai_torch.weights",
            "pose_estimation_amitai_torch.ops.affine",
            "pose_estimation_amitai_torch.ops.gaussian",
            "pose_estimation_amitai_torch.ops.morphology",
            "pose_estimation_amitai_torch.data.synthetic",
            "pose_estimation_amitai_torch.data.preprocess",
            "pose_estimation_amitai_torch.data.pipeline",
            "pose_estimation_amitai_torch.train.loop",
            "pose_estimation_amitai_torch.train.checkpoint",
            "pose_estimation_amitai_torch.train.trainer",
            "pose_estimation_amitai_torch.models.multicam",
            "pose_estimation_amitai_torch.models.norm",
            "pose_estimation_amitai_torch.models.resnet",
            "pose_estimation_amitai_torch.models.disentangled",
            "pose_estimation_amitai_torch.ops.geometry",
            "pose_estimation_amitai_torch.viz",
            "pose_estimation_amitai_torch.cli",
            "pose_estimation_amitai_torch.importers",
            "pose_estimation_amitai_torch.deploy",
            "pose_estimation_amitai_torch.train.selfsup",
            "pose_estimation_amitai_torch.ops.custom_ops",
            "pose_estimation_amitai_torch.__main__"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'pose_estimation_amitai_tpu'))\n"
        "assert not bad, bad\n"
        "lazy = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "              ('h5py', 'msgpack', 'matplotlib'))\n"
        "assert not lazy, lazy\n"
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
        "from pose_estimation_amitai_torch.ops import _build, hopper_conv, hopper_deconv, hopper_qconv\n"
        "from pose_estimation_amitai_torch.ops import hopper_attention, hopper_probes\n"
        "from pose_estimation_amitai_torch.models import quantized, vit\n"
        "assert not torch.cuda.is_available()\n"
        "x = torch.rand(1, 8, 8, 4); w = torch.rand(3, 3, 4, 8); b = torch.rand(8)\n"
        "w2 = torch.rand(3, 3, 8, 8)\n"
        "assert hopper_conv.fused_encoder_stage(x, w, b, w2, b, w2, b).shape == (1, 4, 4, 8)\n"
        "xq = torch.ones(1, 8, 8, 4, dtype=torch.int8); wq = torch.ones(3, 3, 4, 8, dtype=torch.int8)\n"
        "wq2 = torch.ones(3, 3, 8, 8, dtype=torch.int8)\n"
        "out = hopper_qconv.fused_quantized_stage(xq, wq, b, b, wq2, b, b, wq2, b, b, 1.0, 1.0, 1.0)\n"
        "assert out.shape == (1, 8, 8, 8) and out.dtype == torch.int8\n"
        "assert hopper_qconv.quantized_conv3x3(xq, wq, b, b).shape == (1, 8, 8, 8)\n"
        "q = torch.rand(2, 5, 8)\n"
        "assert hopper_attention.fused_attention(q, q, q).shape == (2, 5, 8)\n"
        "net = vit.Attention(8, 2, 8, torch.float32, fused_attention=True).eval()\n"
        "assert net(torch.rand(1, 5, 8)).shape == (1, 5, 8)\n"
        "assert hopper_probes.k_concat_dot(xq).shape == (1, 8, 8, 4)\n"
        "assert hopper_probes.int8_vector_arith(xq, xq).dtype == torch.int8\n"
        "for name in ('encoder_stage', 'decoder', 'qconv_stage', 'attention', 'probes'):\n"
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
    assert names == ["attention.cu", "decoder.cu", "encoder_stage.cu", "probes.cu",
                     "qconv_stage.cu"]
    assert _build._source_hash() == _build._source_hash()
    assert "-gencode" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.BUILD_ROOT.relative_to(ROOT).as_posix() == "build/kernels"
    for p in _build._sources():  # each kernel names the Pallas function it replaces
        text = p.read_text()
        assert ("Replaces pose_estimation_amitai_tpu/ops/pallas_" in text
                or "Replaces scripts/exp_" in text), p.name


def test_load_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        _build.load("encoder_stage")
