"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``.cu`` source is compiled by its own ``nvcc`` process for ``sm_90a``
(all started together), and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use, never at import, into ``build/kernels/`` at the root of the
checkout; the library's name carries a hash of the sources and flags, so a
changed source is rebuilt and an unchanged one is reused.

Every C entry point launches on the stream it is given (PyTorch's current
stream), does not synchronise, allocates nothing, and returns
``cudaGetLastError()``; ``check`` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["library", "build", "stream", "check", "LAUNCHES", "reset_launches"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_SOURCES = ("gram_tile.cu", "chol_inv_block.cu", "slab_factor.cu", "tri_inv_block.cu")
_HEADERS = ("block_routines.cuh",)
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P, _L, _I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
_SIGNATURES = {
    # x, z, out, params, n, m, d, family, symmetric, stream
    "agp_gram_tile": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # A, lda, L, W, B, stream
    "agp_chol_inv_block": (_P, _L, _P, _P, _I, _P),
    # S, L, Winv, work, W, B, stream
    "agp_slab_factor": (_P, _P, _P, _P, _I, _I, _P),
    # L, ld, block_stride, nb, B, out, stream
    "agp_tri_inv_block": (_P, _L, _L, _I, _I, _P, _P),
}

_LIB = None

# launches of each kernel, counted by its wrapper where it launches it and
# nowhere else (so a run can show that the main path went through it)
LAUNCHES = {"gram_tile": 0, "slab_factor": 0, "chol_inv_block": 0, "tri_inv_block": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def build() -> Path:
    """Compile the kernels (one ``nvcc`` per source, in parallel) and link
    them into one shared library; returns its path."""
    build_dir = _BUILD_DIR
    digest = hashlib.sha256()
    for name in _SOURCES + _HEADERS:
        digest.update(name.encode())
        digest.update((_CSRC / name).read_bytes())
    digest.update(" ".join(_ARCH + _FLAGS).encode())
    out = build_dir / f"libagp_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    objs = [build_dir / f"{Path(s).stem}.{tag}.o" for s in _SOURCES]
    procs = [
        subprocess.Popen([nvcc, *_ARCH, *_FLAGS, "-c", str(_CSRC / s), "-o", str(o)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for s, o in zip(_SOURCES, objs)
    ]
    errors = []
    for src, p in zip(_SOURCES, procs):
        _, err = p.communicate()
        if p.returncode:
            errors.append(f"{src}:\n{err}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = build_dir / f"{out.name}.{tag}.tmp"
    link = subprocess.run([nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
    os.replace(tmp, out)
    for o in objs:
        o.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer-sized int."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
