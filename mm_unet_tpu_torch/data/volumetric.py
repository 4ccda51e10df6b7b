"""3-D volumetric data (a copy of `mm_unet_tpu/data/volumetric.py`, numpy
only): the reference's MONAI dict-transform loader for BraTS 2019/2021 and
MSD HepaticVessel as seeded numpy transforms: a dependency-free NIfTI-1
reader, the BraTS multi-channel label conversion, per-channel intensity
normalisation, RandCropByPosNegLabeld-style patch sampling, random flips
and intensity augmentation, and a BraTS case-directory dataset."""

from __future__ import annotations

import gzip
import os
import struct
import numpy as np


def read_nifti(path: str) -> np.ndarray:
    """Minimal NIfTI-1 reader: returns the data array (x, y, z[, t])."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        header = f.read(352)
        sizeof_hdr = struct.unpack("<i", header[:4])[0]
        if sizeof_hdr != 348:
            raise ValueError(f"not a NIfTI-1 file: {path}")
        dim = struct.unpack("<8h", header[40:56])
        datatype = struct.unpack("<h", header[70:72])[0]
        vox_offset = int(struct.unpack("<f", header[108:112])[0])
        shape = tuple(dim[1 : 1 + dim[0]])
        dtypes = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
                  64: np.float64, 256: np.int8, 512: np.uint16, 768: np.uint32}
        if datatype not in dtypes:
            raise ValueError(f"unsupported NIfTI datatype {datatype}")
        f.seek(vox_offset)
        data = np.frombuffer(f.read(), dtype=dtypes[datatype])
        n = int(np.prod(shape))
        return data[:n].reshape(shape, order="F").astype(np.float32)


def convert_brats_labels(label: np.ndarray, version: int = 2021) -> np.ndarray:
    """BraTS id-mask -> 3-channel (TC, WT, ET) one-hot stack (reference
    `loader.py:17-87` ConvertToMultiChannelBasedOnBrats*Classesd).

    2021 ids: 1=NCR, 2=ED, 4=ET. TC = 1|4; WT = 1|2|4; ET = 4.
    2019 uses the same mapping.
    """
    tc = np.logical_or(label == 1, label == 4)
    wt = np.logical_or(tc, label == 2)
    et = label == 4
    return np.stack([tc, wt, et], axis=0).astype(np.float32)


def normalize_intensity(img: np.ndarray, nonzero: bool = True) -> np.ndarray:
    """Per-channel z-score normalisation over nonzero voxels (MONAI
    NormalizeIntensityd(nonzero=True, channel_wise=True))."""
    out = np.empty_like(img, dtype=np.float32)
    for c in range(img.shape[0]):
        ch = img[c]
        mask = ch != 0 if nonzero else np.ones_like(ch, bool)
        vals = ch[mask]
        mu = vals.mean() if vals.size else 0.0
        sd = vals.std() if vals.size else 1.0
        out[c] = np.where(mask, (ch - mu) / max(sd, 1e-8), 0.0)
    return out


def rand_crop_pos_neg(
    rng: np.random.Generator,
    image: np.ndarray,   # (C, X, Y, Z)
    label: np.ndarray,   # (K, X, Y, Z)
    roi: tuple[int, int, int],
    pos: float = 1.0,
    neg: float = 1.0,
    num_samples: int = 1,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """RandCropByPosNegLabeld semantics (reference `loader.py:118-237`):
    sample patch centres from foreground with probability pos/(pos+neg),
    else from background; crop ROI-sized patches (padded if needed)."""
    fg = np.argwhere(label.any(axis=0))
    spatial = np.asarray(image.shape[1:])
    roi_a = np.asarray(roi)
    pad = np.maximum(roi_a - spatial, 0)
    if pad.any():
        pw = [(0, 0)] + [(p // 2, p - p // 2) for p in pad]
        image = np.pad(image, pw)
        label = np.pad(label, pw)
        if fg.size:
            fg = fg + np.asarray([p // 2 for p in pad])
        spatial = np.asarray(image.shape[1:])

    out = []
    p_fg = pos / max(pos + neg, 1e-8)
    for _ in range(num_samples):
        if fg.size and rng.random() < p_fg:
            centre = fg[rng.integers(len(fg))]
        else:
            centre = np.asarray([rng.integers(s) for s in spatial])
        start = np.clip(centre - roi_a // 2, 0, spatial - roi_a)
        sl = tuple(slice(int(s), int(s + r)) for s, r in zip(start, roi_a))
        out.append((image[(slice(None),) + sl], label[(slice(None),) + sl]))
    return out


def rand_flips_3d(rng: np.random.Generator, image: np.ndarray, label: np.ndarray,
                  prob: float = 0.5):
    for ax in (1, 2, 3):
        if rng.random() < prob:
            image = np.flip(image, axis=ax)
            label = np.flip(label, axis=ax)
    return np.ascontiguousarray(image), np.ascontiguousarray(label)


def rand_intensity(rng: np.random.Generator, image: np.ndarray,
                   shift: float = 0.1, scale: float = 0.1, prob: float = 1.0):
    """RandScaleIntensityd + RandShiftIntensityd (reference `loader.py:230-233`)."""
    if rng.random() < prob:
        image = image * (1.0 + rng.uniform(-scale, scale))
    if rng.random() < prob:
        image = image + rng.uniform(-shift, shift)
    return image


class BraTSDataset:
    """Directory of per-case folders holding 4 modality volumes + seg
    (`<case>/<case>_{flair,t1,t1ce,t2,seg}.nii.gz`)."""

    MODALITIES = ("flair", "t1", "t1ce", "t2")

    def __init__(self, root: str, version: int = 2021):
        self.cases = []
        self.version = version
        if os.path.isdir(root):
            for case in sorted(os.listdir(root)):
                d = os.path.join(root, case)
                if os.path.isdir(d):
                    self.cases.append((case, d))

    def __len__(self):
        return len(self.cases)

    def __getitem__(self, i):
        case, d = self.cases[i]

        def vol(suffix):
            for ext in (".nii.gz", ".nii"):
                p = os.path.join(d, f"{case}_{suffix}{ext}")
                if os.path.exists(p):
                    return read_nifti(p)
            raise FileNotFoundError(f"{case}_{suffix}")

        image = np.stack([vol(m) for m in self.MODALITIES], axis=0)
        label = convert_brats_labels(vol("seg"), self.version)
        return normalize_intensity(image), label
