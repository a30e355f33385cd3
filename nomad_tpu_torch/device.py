"""Device selection and the build of the hand-written CUDA kernels.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA and no explicit CPU request they raise -- nothing falls
back to the CPU quietly.

Kernels live in ``csrc/*.cu`` with a plain C interface (no PyTorch
headers), are compiled by ``nvcc`` for ``sm_90a`` at first use into
``build/kernels/`` at the repository root (git-ignored), keyed by a hash
of the source, every shared header ``csrc/*.cuh`` and the flags, and
loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name → compiler output of the build made by this process (ptxas
# register/spill report); empty for a library found already built.
BUILD_LOGS: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class KernelUnavailable(RuntimeError):
    """A kernel was asked for on a machine that cannot build or load it."""


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; ``cuda`` without a visible card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "plain PyTorch versions")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def find_nvcc() -> Optional[str]:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")   # the toolkit's default prefix
    return str(default) if default.exists() else None


def _lib_path(src: Path) -> Path:
    """The library's path, keyed on everything its build reads: the
    source, every shared header (any ``.cu`` may include any of them)
    and the flags -- so editing a header rebuilds every kernel."""
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_kernels() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` not yet built, one ``nvcc`` per source,
    all started together; returns name → library path.  Raises
    :class:`KernelUnavailable` when there is no ``nvcc`` or a compile
    fails (after every started compile has ended)."""
    sources = sorted(CSRC.glob("*.cu"))
    paths = {src.stem: _lib_path(src) for src in sources}
    todo = [src for src in sources if not paths[src.stem].exists()]
    if not todo:
        return paths
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelUnavailable("nvcc not found: the CUDA kernels cannot "
                                "be built on this machine")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        tmp = paths[src.stem].with_suffix(f".{os.getpid()}.tmp")
        procs.append((src, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, tmp, proc in procs:
        BUILD_LOGS[src.stem] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name}:\n"
                          f"{BUILD_LOGS[src.stem]}")
        else:
            os.replace(tmp, paths[src.stem])   # atomic: concurrent builds agree
    if failed:
        raise KernelUnavailable("\n".join(failed))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built at first use)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            paths = build_kernels()
            if name not in paths:
                raise KernelUnavailable(f"no kernel source csrc/{name}.cu")
            lib = ctypes.CDLL(str(paths[name]))
            _LIBS[name] = lib
        return lib
