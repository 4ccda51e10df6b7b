"""Host-side image transforms in numpy (counterpart of
`mm_unet_tpu/data/transforms.py`, the same arrays for the same inputs and
generator): flips, CutMix, centre padding, resize, normalisation, the
polyp sets' colour-statistics exchange, CLAHE, resized crop, colour
jitter, Gaussian blur and random patches. PIL (`resize_image`) and scipy
(`gaussian_blur`) are imported inside the functions that use them.
"""

from __future__ import annotations

import numpy as np


def resize_image(img: np.ndarray, size: tuple[int, int], nearest: bool = False) -> np.ndarray:
    """img: (H, W, C) or (H, W) float. PIL-based resize (bilinear / nearest)."""
    from PIL import Image

    mode_in = img
    squeeze = False
    if img.ndim == 2:
        squeeze = True
    arr = np.asarray(mode_in)
    pil = Image.fromarray(
        (arr * 255).clip(0, 255).astype(np.uint8) if arr.dtype != np.uint8 else arr
    )
    pil = pil.resize((size[1], size[0]), Image.NEAREST if nearest else Image.BILINEAR)
    out = np.asarray(pil).astype(np.float32) / 255.0
    if squeeze and out.ndim == 3:
        out = out[..., 0]
    return out


def center_padding(img: np.ndarray, target_h: int, target_w: int) -> np.ndarray:
    """Pad (H, W, ...) with zeros so H >= target_h, W >= target_w, centred
    (reference `center_padding`, `VesselLoader.py:103-141`)."""
    h, w = img.shape[:2]
    ph, pw = max(target_h - h, 0), max(target_w - w, 0)
    pad = [(ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad)


def random_flips(rng: np.random.Generator, img: np.ndarray, lbl: np.ndarray):
    """Random horizontal + vertical flips, p=0.5 each (`VesselLoader.py:290-296`)."""
    if rng.random() < 0.5:
        img, lbl = img[:, ::-1], lbl[:, ::-1]
    if rng.random() < 0.5:
        img, lbl = img[::-1], lbl[::-1]
    return np.ascontiguousarray(img), np.ascontiguousarray(lbl)


def cut_mix(rng: np.random.Generator, img_a, lbl_a, img_b, lbl_b, beta: float = 1.0):
    """CutMix between two samples (`VesselLoader.py:42-100`)."""
    h, w = img_a.shape[:2]
    lam = rng.beta(beta, beta)
    cut = np.sqrt(1.0 - lam)
    ch, cw = int(h * cut), int(w * cut)
    cy, cx = rng.integers(h), rng.integers(w)
    y1, y2 = np.clip(cy - ch // 2, 0, h), np.clip(cy + ch // 2, 0, h)
    x1, x2 = np.clip(cx - cw // 2, 0, w), np.clip(cx + cw // 2, 0, w)
    img = img_a.copy()
    lbl = lbl_a.copy()
    img[y1:y2, x1:x2] = img_b[y1:y2, x1:x2]
    lbl[y1:y2, x1:x2] = lbl_b[y1:y2, x1:x2]
    return img, lbl


def lab_color_exchange(rng: np.random.Generator, img: np.ndarray, donor: np.ndarray):
    """LAB-space colour statistics exchange between polyp samples
    (`CVCLoder.py:36-50`): donor's per-channel LAB mean/std imposed on img.
    Approximated in RGB space when no cv2 is available."""
    m_i, s_i = img.mean((0, 1)), img.std((0, 1)) + 1e-6
    m_d, s_d = donor.mean((0, 1)), donor.std((0, 1)) + 1e-6
    return ((img - m_i) / s_i * s_d + m_d).clip(0, 1)


def normalize(img: np.ndarray, mean, std) -> np.ndarray:
    return (img - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def to_nchw(img: np.ndarray) -> np.ndarray:
    return np.transpose(img, (2, 0, 1))


def clahe(img: np.ndarray, clip_limit: float = 2.0, grid: int = 8) -> np.ndarray:
    """Contrast-limited adaptive histogram equalisation on the luminance of an
    RGB [0,1] image (the reference preprocesses fundus images with
    cv2 CLAHE; this is a dependency-free numpy port with bilinear tile
    interpolation)."""
    x = np.clip(img, 0.0, 1.0)
    # luminance channel
    lum = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    h, w = lum.shape
    bins = 256
    lq = np.minimum((lum * (bins - 1)).astype(np.int32), bins - 1)

    gh, gw = grid, grid
    ys = np.linspace(0, h, gh + 1).astype(int)
    xs = np.linspace(0, w, gw + 1).astype(int)
    luts = np.zeros((gh, gw, bins), np.float32)
    for i in range(gh):
        for j in range(gw):
            tile = lq[ys[i]:ys[i + 1], xs[j]:xs[j + 1]]
            hist = np.bincount(tile.ravel(), minlength=bins).astype(np.float32)
            if tile.size == 0:
                luts[i, j] = np.linspace(0, 1, bins)
                continue
            limit = max(clip_limit * tile.size / bins, 1.0)
            excess = np.maximum(hist - limit, 0).sum()
            hist = np.minimum(hist, limit) + excess / bins
            cdf = np.cumsum(hist)
            luts[i, j] = cdf / cdf[-1]

    # bilinear interpolation between tile LUTs
    cy = (ys[:-1] + ys[1:]) / 2.0
    cx = (xs[:-1] + xs[1:]) / 2.0
    yy = np.arange(h, dtype=np.float32)
    xx = np.arange(w, dtype=np.float32)
    iy = np.clip(np.searchsorted(cy, yy) - 1, 0, gh - 2)
    ix = np.clip(np.searchsorted(cx, xx) - 1, 0, gw - 2)
    wy = np.clip((yy - cy[iy]) / np.maximum(cy[iy + 1] - cy[iy], 1e-6), 0, 1)
    wx = np.clip((xx - cx[ix]) / np.maximum(cx[ix + 1] - cx[ix], 1e-6), 0, 1)

    l00 = luts[iy[:, None], ix[None, :], lq]
    l01 = luts[iy[:, None], ix[None, :] + 1, lq]
    l10 = luts[iy[:, None] + 1, ix[None, :], lq]
    l11 = luts[iy[:, None] + 1, ix[None, :] + 1, lq]
    top = l00 * (1 - wx[None, :]) + l01 * wx[None, :]
    bot = l10 * (1 - wx[None, :]) + l11 * wx[None, :]
    new_lum = top * (1 - wy[:, None]) + bot * wy[:, None]

    scale = new_lum / np.maximum(lum, 1e-6)
    return np.clip(x * scale[..., None], 0.0, 1.0).astype(np.float32)


def random_resized_crop(rng: np.random.Generator, img, lbl, out_size: int,
                        scale=(0.5, 1.0)):
    """RandomResizedCrop applied jointly to image and label (config-gated in
    the reference, `VesselLoader.py:306-331`)."""
    h, w = img.shape[:2]
    area = h * w * rng.uniform(*scale)
    ratio = rng.uniform(0.75, 1.333)
    ch = int(round(np.sqrt(area / ratio)))
    cw = int(round(np.sqrt(area * ratio)))
    ch, cw = min(ch, h), min(cw, w)
    y0 = rng.integers(h - ch + 1)
    x0 = rng.integers(w - cw + 1)
    ci = img[y0:y0 + ch, x0:x0 + cw]
    cl = lbl[y0:y0 + ch, x0:x0 + cw]
    return (resize_image(ci, (out_size, out_size)),
            resize_image((cl > 0.5).astype(np.float32), (out_size, out_size), nearest=True))


def color_jitter(rng: np.random.Generator, img, brightness=0.2, contrast=0.2,
                 saturation=0.2):
    b = 1.0 + rng.uniform(-brightness, brightness)
    c = 1.0 + rng.uniform(-contrast, contrast)
    s = 1.0 + rng.uniform(-saturation, saturation)
    out = img * b
    mean = out.mean()
    out = (out - mean) * c + mean
    gray = out.mean(axis=-1, keepdims=True)
    out = gray + (out - gray) * s
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def gaussian_blur(rng: np.random.Generator, img, sigma_range=(0.1, 2.0)):
    from scipy import ndimage

    sigma = rng.uniform(*sigma_range)
    return ndimage.gaussian_filter(img, sigma=(sigma, sigma, 0)).astype(np.float32)


def random_patch(rng: np.random.Generator, img, lbl, patch: int):
    """Random patch extraction (BASELINE config: DRIVE 256^2 patches)."""
    h, w = img.shape[:2]
    if h <= patch or w <= patch:
        img = center_padding(img, patch, patch)
        lbl = center_padding(lbl, patch, patch)
        h, w = img.shape[:2]
    y0 = rng.integers(h - patch + 1)
    x0 = rng.integers(w - patch + 1)
    return img[y0:y0 + patch, x0:x0 + patch], lbl[y0:y0 + patch, x0:x0 + patch]
