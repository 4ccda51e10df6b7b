"""Synthetic DRIVE-like data (counterpart of
`mm_unet_tpu/data/loaders.py::make_synthetic`, the same images for the same
seed) and the DRIVE normalisation of `config.yml:25-26`. Numpy only."""

from __future__ import annotations

import numpy as np

# (mean, std) of config.yml:25-26
DRIVE_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
DRIVE_STD = np.array([0.229, 0.224, 0.225], np.float32)


def make_synthetic(n: int, hw: int, seed: int = 0) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Vessel-like images: six random smooth curves on a textured disc.
    Returns (images (hw, hw, 3) in [0, 1], labels (hw, hw) in {0, 1})."""
    rng = np.random.default_rng(seed)
    images, labels = [], []
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32) / hw
    for _ in range(n):
        img = rng.uniform(0.2, 0.5) * np.ones((hw, hw, 3), np.float32)
        img += 0.1 * rng.standard_normal((hw, hw, 3)).astype(np.float32)
        lbl = np.zeros((hw, hw), np.float32)
        for _ in range(6):
            f1, f2 = rng.uniform(2, 6, 2)
            p1, p2 = rng.uniform(0, 2 * np.pi, 2)
            curve = 0.5 + 0.3 * np.sin(f1 * xx[0] * 2 * np.pi + p1) * np.sin(
                f2 * xx[0] * np.pi + p2
            )
            width = rng.uniform(0.004, 0.012)
            lbl = np.maximum(lbl, (np.abs(yy - curve[None, :]) < width).astype(np.float32))
        img[..., 0] = np.clip(img[..., 0] + 0.4 * lbl, 0, 1)
        images.append(np.clip(img, 0, 1))
        labels.append(lbl)
    return images, labels


def synthetic_batch(n: int, hw: int, seed: int = 0, mean=DRIVE_MEAN, std=DRIVE_STD) -> dict:
    """One batch of `make_synthetic`, normalised: {"image": (n, 3, hw, hw),
    "label": (n, 1, hw, hw)} f32 arrays."""
    images, labels = make_synthetic(n, hw, seed)
    img = (np.stack(images) - mean) / std
    return {"image": np.ascontiguousarray(img.transpose(0, 3, 1, 2), np.float32),
            "label": np.stack(labels)[:, None].astype(np.float32)}
