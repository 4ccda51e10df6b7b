"""The reference's top-level mini dataset (counterpart of the root
`data.py::RetinaDataset`, unused by the main trainer): a directory of
images and a directory of masks under the same file names, each pair read
0-1 normalised into NCHW float32 numpy arrays. PIL is imported inside the
reader, as `loaders.py` does: a machine without PIL can import the
package."""

from __future__ import annotations

import os

import numpy as np


def _read(path: str, mode: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert(mode), np.float32) / 255.0


class RetinaDataset:
    """(image (3, H, W), mask (1, H, W)) pairs in file-name order: the
    images' RGB channels in [0, 1], the masks' gray levels above one half as
    1, the rest 0; an image without a mask of its name is skipped, and a
    missing image directory gives an empty set."""

    def __init__(self, img_dir: str, mask_dir: str):
        self.items = []
        for fname in sorted(os.listdir(img_dir)) if os.path.isdir(img_dir) else []:
            mask_path = os.path.join(mask_dir, fname)
            if os.path.exists(mask_path):
                img = _read(os.path.join(img_dir, fname), "RGB")
                mask = _read(mask_path, "L")
                self.items.append((img.transpose(2, 0, 1),
                                   (mask > 0.5)[None].astype(np.float32)))

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        return self.items[i]
