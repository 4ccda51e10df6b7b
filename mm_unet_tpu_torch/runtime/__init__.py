"""Native data pipeline (C++ through ctypes; counterpart of
`mm_unet_tpu/runtime/__init__.py`).

`datapipe.cpp` is a copy of the JAX package's source. It is built with g++
at the first call of `get_lib()` (never at import) into ``build/runtime/``
at the root of the checkout, which ``.gitignore`` lists; the file name
carries a hash of the source, the flags and the host's CPU, so an edit or
another kind of CPU builds a new library. Without a compiler `get_lib()` returns None and the loaders take
the numpy pipeline (`mm_unet_tpu_torch.data.transforms`), which stays the
reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "datapipe.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "runtime"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _host_cpu() -> bytes:
    """The CPU's model and feature flags: `-march=native` builds for them, so
    a checkout shared between machines keeps one library per kind of CPU."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return platform.processor().encode()
    keys = (b"model name", b"flags")
    return b"".join(next((ln for ln in lines if ln.startswith(k)), b"") for k in keys)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + _host_cpu() + SRC.read_bytes())
    return BUILD_DIR / f"libmmu_datapipe_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    """Compile to a temporary name and rename it into place, so processes
    building at once never load a half-written library."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SRC), "-lpthread"],
                       check=True, capture_output=True)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.CalledProcessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native pipeline; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = library_path()
    if not path.exists() and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.mmu_version.restype = ctypes.c_int
    if lib.mmu_version() != 2:
        return None
    f32p, i32 = ctypes.POINTER(ctypes.c_float), ctypes.c_int
    i32p, i64p, u64 = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64), ctypes.c_uint64
    for name in ("mmu_resize_bilinear", "mmu_resize_nearest"):
        getattr(lib, name).argtypes = [f32p, i32, i32, i32, f32p, i32, i32]
        getattr(lib, name).restype = None
    # images, labels, hs, ws, idxs, batch, size, mean, std, seed, epoch, flags,
    # patch, mix_idxs, n_total, out_img, out_lbl
    lib.mmu_prepare_batch.argtypes = [ctypes.POINTER(f32p), ctypes.POINTER(f32p), i32p, i32p,
                                      i64p, i32, i32, f32p, f32p, u64, u64, i32, i32, i64p,
                                      i32, f32p, f32p]
    lib.mmu_prepare_batch.restype = None
    _lib = lib
    return lib


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def resize_bilinear(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    lib = get_lib()
    assert lib is not None
    src = np.ascontiguousarray(src, np.float32)
    if src.ndim == 2:
        src = src[..., None]
    sh, sw, c = src.shape
    dst = np.empty((dh, dw, c), np.float32)
    lib.mmu_resize_bilinear(_f32p(src), sh, sw, c, _f32p(dst), dh, dw)
    return dst


def resize_nearest(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    lib = get_lib()
    assert lib is not None
    src = np.ascontiguousarray(src, np.float32)
    if src.ndim == 2:
        src = src[..., None]
    sh, sw, c = src.shape
    dst = np.empty((dh, dw, c), np.float32)
    lib.mmu_resize_nearest(_f32p(src), sh, sw, c, _f32p(dst), dh, dw)
    return dst


def prepare_batch(
    images: list[np.ndarray],
    labels: list[np.ndarray],
    idxs: np.ndarray,
    size: int,
    mean,
    std,
    seed: int,
    epoch: int,
    train: bool,
    cutmix_donor_images: Optional[list[np.ndarray]] = None,
    cutmix_donor_labels: Optional[list[np.ndarray]] = None,
    color_jitter: bool = False,
    gaussian_blur: bool = False,
    resized_crop: bool = False,
    patch: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Threaded native batch prep. images[i]: (H,W,3) f32 [0,1]; labels[i]:
    (H,W) f32. Returns (B,3,S,S), (B,1,S,S)."""
    lib = get_lib()
    assert lib is not None
    batch = len(images)
    use_cutmix = cutmix_donor_images is not None

    imgs_c = [np.ascontiguousarray(im, np.float32) for im in images]
    lbls_c = [np.ascontiguousarray(lb, np.float32) for lb in labels]
    don_i = [np.ascontiguousarray(im, np.float32) for im in (cutmix_donor_images or [])]
    don_l = [np.ascontiguousarray(lb, np.float32) for lb in (cutmix_donor_labels or [])]

    PtrArr = ctypes.POINTER(ctypes.c_float) * (batch * 2 if use_cutmix else batch)
    img_ptrs = PtrArr(*([_f32p(a) for a in imgs_c] + [_f32p(a) for a in don_i]))
    lbl_ptrs = PtrArr(*([_f32p(a) for a in lbls_c] + [_f32p(a) for a in don_l]))
    hs = (ctypes.c_int * batch)(*[im.shape[0] for im in imgs_c])
    ws = (ctypes.c_int * batch)(*[im.shape[1] for im in imgs_c])
    id_arr = (ctypes.c_int64 * batch)(*[int(v) for v in idxs])
    mix_arr = (ctypes.c_int64 * batch)(*([0] * batch)) if use_cutmix else None
    mean_a = (ctypes.c_float * 3)(*[float(v) for v in mean])
    std_a = (ctypes.c_float * 3)(*[float(v) for v in std])

    out_img = np.empty((batch, 3, size, size), np.float32)
    out_lbl = np.empty((batch, 1, size, size), np.float32)
    flags = (
        (1 if train else 0) | (2 if use_cutmix else 0)
        | (4 if color_jitter else 0) | (8 if gaussian_blur else 0)
        | (16 if resized_crop else 0)
    )
    lib.mmu_prepare_batch(
        img_ptrs, lbl_ptrs, hs, ws, id_arr,
        ctypes.c_int(batch), ctypes.c_int(size), mean_a, std_a,
        ctypes.c_uint64(seed), ctypes.c_uint64(epoch), ctypes.c_int(flags),
        ctypes.c_int(int(patch or 0)), mix_arr, ctypes.c_int(batch),
        _f32p(out_img), _f32p(out_lbl),
    )
    return out_img, out_lbl
