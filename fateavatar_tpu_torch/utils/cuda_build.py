"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface, called through
:func:`launch`. It is compiled with ``nvcc`` for Hopper (``sm_90a``) at
first use into ``_build/`` beside the package (listed in ``.gitignore``),
named by a hash of the source, the shared headers and the flags, so an
edited source is rebuilt and an unchanged one is not. The ``-Xptxas -v``
report (registers, shared memory, spills) is kept beside the library as
``<name>_<hash>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to. The name hashes the source, the
    shared headers ``csrc/*.cuh`` and the flags."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{tag}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library's path. Raises with nvcc's output on failure."""
    so = library_path(name)
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)   # atomic: a concurrent process never loads a partial file
    return so


def build_all(names) -> dict:
    """Build several sources at once, one nvcc process each."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(build, names)))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library, once per
    process."""
    return ctypes.CDLL(str(build(name)))


@functools.lru_cache(maxsize=None)
def _entry(name: str, symbol: str, argtypes: tuple, restype=ctypes.c_int):
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def call(name: str, symbol: str, argtypes: tuple, args: tuple, restype):
    """Calls the host-only C function ``symbol`` of ``csrc/<name>.cu``'s
    library (no launch, no stream) and returns its ``restype`` result."""
    return _entry(name, symbol, argtypes, restype)(*args)


def launch(name: str, symbol: str, argtypes: tuple, args: tuple, device) -> None:
    """Calls the C function ``symbol`` of ``csrc/<name>.cu``'s library, with
    the ctypes signature ``argtypes`` (the last one the stream), on
    ``device``'s current stream; raises when it returns a CUDA error (a
    refused launch)."""
    fn = _entry(name, symbol, argtypes)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {err}")
