"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface, which is loaded with
``ctypes``. The library's file name carries a hash of the sources and the
flags, so an edited source builds a new library. The build happens at the
first call of `library()` (never at import) into ``build/kernels/`` at the
root of the checkout, which ``.gitignore`` lists.

C entry points take device pointers and the CUDA stream as ``void*`` and
return the ``cudaError_t`` of ``cudaGetLastError()`` after their launches;
`check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_LIB = None
VP, I32 = ctypes.c_void_p, ctypes.c_int

# C signatures of the entry points (all return cudaError_t as int)
_SIGNATURES = {
    # xz, out, conv_w, conv_b, x_proj, dt_w, dt_b, A, Dskip, state, dtsum,
    # B, G, D, L, N, R, W, T, reverse, is_bf16, stream
    "mamba_fused_fwd": [VP] * 11 + [I32] * 10 + [VP],
    # feat, y, kernel, bias, shifts, out, B, H, W, C, F, K, is_bf16, stream
    "tap_conv_fwd": [VP] * 6 + [I32] * 7 + [VP],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # sources and headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmmu_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the sources unless the library for their hash exists.
    `verbose` adds ``-Xptxas -v`` and prints the compiler's report
    (registers, shared memory and spills of every kernel)."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr, flush=True)
    os.replace(tmp, out)  # atomic: a concurrent process never loads a torn file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.mmu_error_string.argtypes = [I32]
        lib.mmu_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(err: int, name: str) -> None:
    if err != 0:
        text = library().mmu_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({text})")
