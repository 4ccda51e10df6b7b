"""Qualitative evaluation (counterpart of the JAX package's root
`visualization.py`, the reference's `visualization.py:121-216`):

    python -m mm_unet_tpu_torch.cli.visualize [--device cuda|cpu]

Loads the best checkpoint of `visualization.checkpoint` (default
`finetune.checkpoint`), runs sliding-window inference over each validation
image and writes, into `visualization.save_dir` (default
`visualization/`), `<i>_mask.png` (the predicted mask), `<i>_contour.png`
(its boundary in green over the image) and `<i>_error.png` (white true
positives, red false positives, green false negatives). PNG files are
written with `zlib` and `struct` (no PIL); the JAX tool writes the mask as
TIFF through PIL.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np
import torch

from mm_unet_tpu_torch.cli.session import open_session, run
from mm_unet_tpu_torch.train.loop import stage
from mm_unet_tpu_torch.train.predictor import make_predictor
from mm_unet_tpu_torch.utils import ConfigDict


def error_map(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8: white true positives, red false positives, green
    false negatives, black elsewhere."""
    img = np.zeros((*pred.shape, 3), np.uint8)
    img[(pred > 0) & (gt > 0)] = (255, 255, 255)
    img[(pred > 0) & (gt == 0)] = (255, 0, 0)
    img[(pred == 0) & (gt > 0)] = (0, 255, 0)
    return img


def contour_overlay(image: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """The mask's boundary (the mask less its binary erosion) in green over
    an (H, W, 3) image in [0, 1]."""
    from scipy import ndimage

    m = mask > 0
    boundary = m & ~ndimage.binary_erosion(m)
    img = (image * 255).clip(0, 255).astype(np.uint8).copy()
    img[boundary] = (0, 255, 0)
    return img


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def write_png(path: str, img: np.ndarray) -> None:
    """An 8-bit grayscale (H, W) or RGB (H, W, 3) uint8 array as a PNG."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"write_png: (H, W) or (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]
    color = 0 if img.ndim == 2 else 2
    rows = img.reshape(h, -1)
    raw = b"".join(b"\x00" + rows[y].tobytes() for y in range(h))  # filter 0 per row
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """The array `write_png` wrote (8-bit grayscale or RGB, filter 0)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = hdr[:4]
    ch = {0: 1, 2: 3}[color]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * ch)
    if depth != 8 or rows[:, 0].any():
        raise ValueError(f"{path}: only 8-bit, filter-0 PNGs are read")
    img = rows[:, 1:].reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def main(config: Optional[ConfigDict] = None, device: str = "cuda") -> int:
    s = open_session(config, device, log_prefix="visualize_")
    try:
        vis = s.config.get("visualization", {}) or {}
        out_dir = vis.get("save_dir", "visualization")
        os.makedirs(out_dir, exist_ok=True)
        name = vis.get("checkpoint", s.config.finetune.checkpoint)
        if name != s.config.finetune.checkpoint:
            from mm_unet_tpu_torch.train.checkpoint import CheckpointManager

            s.manager = CheckpointManager("model_store", name, write=False)
        if s.manager.has("best"):
            s.manager.load("best", s.state, model_only=True)
            print(f"loaded best checkpoint for {name}", flush=True)
        else:
            print(f"warning: no best checkpoint for {name}; drawing the model at init", flush=True)
        params = s.config.dataset[s.config.trainer.dataset_choose]
        mean = np.asarray(params.get("image_mean", [0.485, 0.456, 0.406]))
        std = np.asarray(params.get("image_std", [0.229, 0.224, 0.225]))
        predictor = make_predictor(s.model)
        for i, batch in enumerate(s.val_loader):
            logits = s.inferer(stage(batch["image"], s.device), predictor)
            pred = (torch.sigmoid(logits) > 0.5).to(torch.uint8)[0, 0].cpu().numpy()
            gt = np.asarray(batch["label"])[0, 0]
            rgb = np.transpose(np.asarray(batch["image"])[0], (1, 2, 0)) * std + mean
            write_png(os.path.join(out_dir, f"{i}_mask.png"), pred * 255)
            write_png(os.path.join(out_dir, f"{i}_error.png"), error_map(pred, gt))
            write_png(os.path.join(out_dir, f"{i}_contour.png"), contour_overlay(rgb, pred))
            print(f"saved visualisation {i}", flush=True)
        return 0
    finally:
        s.close()


if __name__ == "__main__":
    run(main, "Draw the masks, contours and error maps of the best checkpoint of the model "
              "config.yml (or MMU_CONFIG) names.")
