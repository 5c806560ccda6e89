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
            "pose_estimation_amitai_torch.data.h5",
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
            "pose_estimation_amitai_torch.ops.draws",
            "pose_estimation_amitai_torch.parallel",
            "pose_estimation_amitai_torch.parallel.mesh",
            "pose_estimation_amitai_torch.parallel.sharded",
            "pose_estimation_amitai_torch.parallel.tensor",
            "pose_estimation_amitai_torch.parallel.pipeline",
            "pose_estimation_amitai_torch.parallel.sequence",
            "pose_estimation_amitai_torch.parallel.expert",
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


def test_h5_paths_load_no_h5py(tmp_path):
    """The config-file paths read and write the contract file through the
    port's own reader and writer: with ``h5py`` made unimportable, the
    modules import, ``write_synthetic_h5`` writes and the Preprocessor
    loads, and no ``h5py`` module is loaded."""
    code = (
        "import sys\n"
        "sys.modules['h5py'] = None  # an import of h5py now raises\n"
        "from pose_estimation_amitai_torch.data import preprocess, synthetic\n"
        "from pose_estimation_amitai_torch.train import selfsup, trainer\n"
        f"p = synthetic.write_synthetic_h5({str(tmp_path / 'd.h5')!r}, num_frames=2,\n"
        "                                 num_points=8, image_size=32)\n"
        "d = preprocess.Preprocessor._load_h5(p)\n"
        "assert d['box'].shape == (2, 4, 32, 32, 5), d['box'].shape\n"
        "assert [m for m in sys.modules if m.split('.')[0] == 'h5py'] == ['h5py']\n"
        "print('ok')\n"
    )
    r = _run(code, dict(os.environ))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_keras_and_msgpack_paths_load_no_h5py_or_msgpack(tmp_path):
    """A keras save and a JAX run directory load with ``h5py`` and
    ``msgpack`` made unimportable, as on the card's machine: every
    ``KERAS_CASES`` save through is_reference_checkpoint and
    import_reference_checkpoint to a tree equal bit for bit to JAX's
    importer, JAX's save_params and save_checkpoint files through
    load_flax_checkpoint to msgpack_restore's trees, and a keras save and
    the run directory through Predictor.from_checkpoint on the CPU as a
    Predictor of the same tree in memory serves. Neither module is
    loaded."""
    import json

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    from flax import serialization

    from pose_estimation_amitai_torch import importers, weights
    from pose_estimation_amitai_torch.config import Config
    from pose_estimation_amitai_torch.infer import Predictor
    from pose_estimation_amitai_tpu import importers as jimporters
    from pose_estimation_amitai_tpu.train import checkpoint as jckpt
    from pose_estimation_amitai_tpu.train.loop import TrainState
    from test_torch_importers import KERAS_CASES, _keras_case

    keras = {case: _keras_case(tmp_path, case)[0] for case in KERAS_CASES}
    rng = np.random.default_rng(9)
    params = weights.init_basicnet_params(rng, 4, 6, filters=8)
    run = tmp_path / "run"
    run.mkdir()
    jckpt.save_params(str(run / "best_model.msgpack"), params)
    state = TrainState(step=jnp.asarray(3, jnp.int32), params=params,
                       opt_state=optax.adam(1e-3).init(params), batch_stats={},
                       rng=jax.random.key(0))
    full = jckpt.save_checkpoint(str(tmp_path), state, epoch=0, val_loss=1.0)
    frames = rng.random((2, 48, 48, 4), dtype=np.float32)
    np.save(tmp_path / "frames.npy", frames)
    files = {"keras": keras, "msgpack": {"params": str(run / "best_model.msgpack"),
                                         "full": full}, "run": str(run), "out": str(tmp_path)}
    code = (
        "import json, sys\n"
        "sys.modules['h5py'] = sys.modules['msgpack'] = None  # their imports now raise\n"
        "import numpy as np\n"
        "from pose_estimation_amitai_torch import importers, weights\n"
        "from pose_estimation_amitai_torch.config import Config\n"
        "from pose_estimation_amitai_torch.infer import Predictor\n"
        f"files = json.loads({json.dumps(files)!r})\n"
        "def flat(tree, prefix):\n"
        "    if isinstance(tree, dict):\n"
        "        return {k: v for key, sub in tree.items()\n"
        "                for k, v in flat(sub, f'{prefix}/{key}').items()}\n"
        "    return {prefix: np.asarray(tree)}\n"
        "out, arch = {}, {}\n"
        "for case, path in files['keras'].items():\n"
        "    assert importers.is_reference_checkpoint(path), case\n"
        "    m = importers.import_reference_checkpoint(path)\n"
        "    out.update(flat(m.params, f'{case}/params'))\n"
        "    out.update(flat(m.batch_stats or {}, f'{case}/batch_stats'))\n"
        "    arch[case] = [m.model_kind, m.arch_flavor, m.arch_kwargs]\n"
        "for name, path in files['msgpack'].items():\n"
        "    params, stats = weights.load_flax_checkpoint(path)\n"
        "    assert stats == {}, stats\n"
        "    out.update(flat(params, name))\n"
        "frames = np.load(files['out'] + '/frames.npy')\n"
        "cfg = Config(num_base_filters=8, compute_dtype='float32')\n"
        "out['served/run'] = Predictor.from_checkpoint(cfg, files['run'], (48, 48, 4), 6,\n"
        "                                            device='cpu')(frames)\n"
        "out['served/keras'] = Predictor.from_checkpoint(cfg, files['keras']['keras_basic'],\n"
        "                                              (48, 48, 4), 6, device='cpu')(frames)\n"
        "np.savez(files['out'] + '/got.npz', **out)\n"
        "json.dump(arch, open(files['out'] + '/arch.json', 'w'))\n"
        "assert [m for m in sys.modules if m.split('.')[0] in ('h5py', 'msgpack')] == \\\n"
        "    ['h5py', 'msgpack'], 'a reader module was loaded'\n"
        "print('ok')\n"
    )
    r = _run(code, dict(os.environ))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
    got = dict(np.load(tmp_path / "got.npz"))
    arch = json.loads((tmp_path / "arch.json").read_text())

    def flat(tree, prefix):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items()
                    for k, v in flat(sub, f"{prefix}/{key}").items()}
        return {prefix: np.asarray(tree)}

    want = {}
    for case, path in keras.items():
        m = jimporters.import_reference_checkpoint(path)
        want.update(flat(m.params, f"{case}/params"))
        want.update(flat(m.batch_stats or {}, f"{case}/batch_stats"))
        assert arch[case] == [m.model_kind, m.arch_flavor, json.loads(json.dumps(m.arch_kwargs))]
    for name in files["msgpack"]:
        with open(files["msgpack"][name], "rb") as f:
            restored = serialization.msgpack_restore(f.read())
        want.update(flat(restored["params"] if name == "full" else restored, name))
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), k
    assert sorted(k for k in got if not k.startswith("served/")) == sorted(want)
    cfg = Config(num_base_filters=8, compute_dtype="float32")
    served = Predictor(cfg, params, (48, 48, 4), 6, device="cpu")(frames)
    np.testing.assert_array_equal(got["served/run"], served)
    j = jimporters.import_reference_checkpoint(keras["keras_basic"])
    imported = importers.ImportedModel(j.params, j.model_kind, j.arch_flavor, j.arch_kwargs)
    served = Predictor(cfg, j.params, (48, 48, 4), j.arch_kwargs["out_channels"], device="cpu",
                       model=lambda **kw: imported.module(torch.float32, **kw))(frames)
    np.testing.assert_array_equal(got["served/keras"], served)


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
    assert names == ["attention.cu", "decoder.cu", "encoder_stage.cu", "ftl_fusion.cu",
                     "probes.cu", "qconv_stage.cu"]
    assert _build._source_hash() == _build._source_hash()
    assert "-gencode" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.BUILD_ROOT.relative_to(ROOT).as_posix() == "build/kernels"
    for p in _build._sources():  # each kernel names the Pallas function it replaces,
        text = p.read_text()     # or says that it replaces none
        assert ("Replaces pose_estimation_amitai_tpu/ops/pallas_" in text
                or "Replaces scripts/exp_" in text
                or "It replaces no TPU kernel" in text), p.name


def test_load_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        _build.load("encoder_stage")
