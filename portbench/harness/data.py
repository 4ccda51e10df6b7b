"""The cells' images, made on the card from the seed: the synthetic
DRIVE-like vessels of the program's `data/synthetic.py::make_synthetic`
(six random smooth curves on a noisy disc of constant brightness, the
curves drawn brighter in the red channel and given as the label), in bulk
with a generator on the card, then normalised as config.yml's DRIVE set.
Every seed gives the same sizes; only the pixels change."""

from __future__ import annotations

import math

import torch

from harness.spec import sub_seed

DRIVE_MEAN = (0.485, 0.456, 0.406)
DRIVE_STD = (0.229, 0.224, 0.225)


def synthetic_pool(n_batches: int, batch: int, size: int, seed: int, device,
                   mean=DRIVE_MEAN, std=DRIVE_STD) -> list[dict]:
    """n_batches distinct batches {"image": (batch, 3, size, size),
    "label": (batch, 1, size, size)} f32 on `device`."""
    n = n_batches * batch
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "images"))
    u = lambda lo, hi, *s: lo + (hi - lo) * torch.rand(*s, generator=g, device=device)  # noqa: E731
    base = u(0.2, 0.5, n, 1, 1, 1)
    img = base + 0.1 * torch.randn(n, 3, size, size, generator=g, device=device)
    f1, f2 = u(2, 6, n, 6, 1), u(2, 6, n, 6, 1)
    p1, p2 = u(0, 2 * math.pi, n, 6, 1), u(0, 2 * math.pi, n, 6, 1)
    width = u(0.004, 0.012, n, 6, 1)
    x = torch.arange(size, device=device, dtype=torch.float32) / size  # (size,)
    curves = 0.5 + 0.3 * torch.sin(f1 * x * 2 * math.pi + p1) * torch.sin(f2 * x * math.pi + p2)
    yy = x[:, None]
    label = torch.zeros(n, size, size, device=device)
    for k in range(6):
        hit = (yy[None] - curves[:, k, None, :]).abs() < width[:, k, :, None]
        label = torch.maximum(label, hit.float())
    img[:, 0] += 0.4 * label
    img = img.clamp(0, 1)
    m = torch.tensor(mean, device=device)[None, :, None, None]
    s = torch.tensor(std, device=device)[None, :, None, None]
    img = (img - m) / s
    return [{"image": img[i * batch:(i + 1) * batch].contiguous(),
             "label": label[i * batch:(i + 1) * batch, None].contiguous()}
            for i in range(n_batches)]
