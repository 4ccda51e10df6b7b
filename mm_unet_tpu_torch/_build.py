"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper (``sm_90a``),
all in parallel, and linked into one shared library with a plain C
interface, which is loaded with ``ctypes``. The library's file name carries
a hash of the sources and the flags, so an edited source builds a new
library. The build happens at the
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_LIB = None
VP, I32 = ctypes.c_void_p, ctypes.c_int

# C signatures of the entry points (all return int: a cudaError_t)
_SIGNATURES = {
    # xz, out, conv_w, conv_b, x_proj, dt_w, dt_b, A, Dskip, state, dtsum, xdbl,
    # B, G, D, L, N, R, W, T, Dc, reverse, is_bf16, stream
    "mamba_fused_fwd": [VP] * 12 + [I32] * 11 + [VP],
    # D, R, N, T, Dc, is_bf16, out (int[3]: resident blocks per SM of the two chunk
    # passes and of pass X)
    "mamba_fused_fwd_blocks_per_sm": [I32] * 6 + [VP],
    # xz, dout, dxz, conv_w, conv_b, x_proj, dt_w, dt_b, A, Dskip, state, dtsum,
    # gcarry, dpre, xdbl, p_dxp, p_ddtw, p_ddtb, p_dA, p_dD, p_dconv,
    # B, G, D, L, N, R, W, T, Dc, conv_tile, reverse, is_bf16, stream
    "mamba_fused_bwd": [VP] * 21 + [I32] * 12 + [VP],
    # D, R, N, T, Dc, is_bf16, out (int[4]: resident blocks per SM of passes X, A and C,
    # and the clusters of pass C the card holds at once)
    "mamba_fused_bwd_blocks_per_sm": [I32] * 6 + [VP],
    # feat, y, kernel, bias, shifts, out, B, H, W, C, F, K, is_bf16, stream
    "tap_conv_fwd": [VP] * 6 + [I32] * 7 + [VP],
    # feat, y, kernel, shifts, dout, dfeat, dy, dk, db, p_dk, p_db, B, H, W, C, F, K, ms,
    # is_bf16, stream
    "tap_conv_bwd": [VP] * 11 + [I32] * 8 + [VP],
    # u, delta, z, B, C, A, bias, D, out, state, dtsum, last, bc_strides (int64[8]),
    # b_gdiv, c_gdiv, b_var, c_var, B, Dm, L, N, T, span, chans, softplus, is_bf16,
    # bc_bf16, stream
    "selective_scan_fwd": [VP] * 13 + [I32] * 14 + [VP],
    # u, delta, z, B, C, A, bias, D, state, dtsum, dout, dlast, du, ddelta, dz, gcarry,
    # p_dA, p_dD, p_dbias, p_dB, p_dC, bc_strides, then the ints and stream of the forward
    "selective_scan_bwd": [VP] * 22 + [I32] * 14 + [VP],
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
    """Compile the sources unless the library for their hash exists: one
    ``nvcc -c`` per source, all started together, then one link.
    `verbose` adds ``-Xptxas -v`` and prints the compiler's report
    (registers, shared memory and spills of every kernel)."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp, src.stem + ".o")
            objs.append(obj)
            cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-c",
                   "-o", str(obj), str(src)]
            procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
        failed = []
        for src, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{err}")
            elif verbose:
                print(err, flush=True)
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        lib = Path(tmp, out.name)
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib), *map(str, objs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(lib, out)  # atomic: a concurrent process never loads a torn file
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
