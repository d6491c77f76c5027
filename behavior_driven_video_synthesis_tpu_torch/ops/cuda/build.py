"""Builds the package's CUDA sources with nvcc and loads them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into a shared library with a
plain C interface under ``build/torch_kernels/<name>-<hash>/`` at the root
of the checkout (or under ``$BDVS_TORCH_BUILD_DIR``).  The hash covers every
file in ``csrc/`` and the compiler flags, so an edited source rebuilds and
an unchanged one loads the library already built.  ``-Xptxas -v`` output
(registers, shared memory, spills) is kept beside it in ``build.log``.
Every call into a library goes through :func:`launch`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _build_root() -> Path:
    env = os.environ.get("BDVS_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parents[1] / "build" / "torch_kernels"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return nvcc


def library_dir(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _build_root() / f"{name}-{h.hexdigest()[:16]}"


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its build is missing, then load it."""
    if name in _loaded:
        return _loaded[name]
    out_dir = library_dir(name)
    lib_path = out_dir / f"lib{name}.so"
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f".lib{name}.{os.getpid()}.so"
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            capture_output=True, text=True, check=False)
        (out_dir / "build.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)  # atomic: two processes may build at once
    lib = ctypes.CDLL(str(lib_path))
    _loaded[name] = lib
    return lib


def build_log(name: str) -> str:
    """The compiler's report of the library's last build."""
    return (library_dir(name) / "build.log").read_text()


def launch(fn, what: str, device, *args, stream: bool = True) -> None:
    """``fn(*args, stream)`` under ``device``'s guard, the stream being
    the device's current CUDA stream (none with ``stream=False``, for a
    query such as a launch plan; ``device=None`` keeps the current
    device); raises a RuntimeError naming ``what`` when fn returns a
    cudaError."""
    with torch.cuda.device(device):
        if stream:
            args += (torch.cuda.current_stream(device).cuda_stream,)
        err = fn(*args)
    if err:
        raise RuntimeError(f"{what} failed: cudaError {err}")
