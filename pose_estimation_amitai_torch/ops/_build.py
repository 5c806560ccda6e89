"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/kernels/<hash>/lib<name>.so``, where
``<hash>`` covers every file in ``csrc/`` and the compiler flags, so an edit
to any source or header rebuilds everything and an unchanged tree reuses the
libraries. All sources compile together, one ``nvcc`` process each, for
``sm_90a`` (Hopper: the ``a`` keeps ``wgmma`` and ``setmaxnreg`` available).
The libraries export plain C functions; the wrappers in ``hopper_conv.py``,
``hopper_deconv.py``, ``hopper_qconv.py``, ``hopper_attention.py`` and
``hopper_probes.py`` pass device pointers and the current stream as Python
ints.

Nothing here runs at import. Without ``nvcc`` or without a CUDA device,
:func:`load` raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# loaded libraries by source stem; filled once per process by load()
_LIBS: dict[str, ctypes.CDLL] = {}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default prefix. Raises if there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the port's "
        "kernels are built from csrc/ at first use and need the CUDA toolkit"
    )


def build() -> Path:
    """Compile every ``csrc/*.cu`` that is not built yet; return the
    directory of the libraries. Compiler output (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside each library as ``lib<name>.log``."""
    out_dir = BUILD_ROOT / _source_hash()
    todo = [s for s in _sources() if not (out_dir / f"lib{s.stem}.so").exists()]
    if not todo:
        return out_dir
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        tmp = out_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        (out_dir / f"lib{src.stem}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src.name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out_dir / f"lib{src.stem}.so")
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return out_dir


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed.

    Raises without a CUDA device or without ``nvcc``."""
    if name in _LIBS:
        return _LIBS[name]
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"kernel {name!r} needs a CUDA device; none is available"
        )
    if not (CSRC / f"{name}.cu").exists():
        raise FileNotFoundError(CSRC / f"{name}.cu")
    lib = ctypes.CDLL(str(build() / f"lib{name}.so"))
    _LIBS[name] = lib
    return lib
