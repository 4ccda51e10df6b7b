"""MMConv geometry on NHWC tensors (counterpart of
`mm_unet_tpu/ops/geometry.py:64-96`): the two-row serpentine token flatten,
its inverse, and the cumulative kernel offsets from the kernel centre."""

from __future__ import annotations

import torch


def two_row_flatten_tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H*W, C): pairs of rows interleaved column-wise
    (row0[0], row1[0], row0[1], row1[1], ...), an odd last row appended."""
    b, h, w, c = x.shape
    even = h // 2 * 2
    main = x[:, :even].reshape(b, even // 2, 2, w, c)
    main = main.transpose(2, 3).reshape(b, even * w, c)
    if h % 2 == 1:
        main = torch.cat([main, x[:, even:].reshape(b, w, c)], dim=1)
    return main


def inverse_two_row_flatten_tokens(tokens: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Inverse of `two_row_flatten_tokens`: (B, H*W, C) -> (B, H, W, C)."""
    b, _, c = tokens.shape
    even = h // 2 * 2
    main = tokens[:, : even * w].reshape(b, even // 2, w, 2, c)
    main = main.transpose(2, 3).reshape(b, even, w, c)
    if h % 2 == 1:
        main = torch.cat([main, tokens[:, even * w :].reshape(b, 1, w, c)], dim=1)
    return main


def accumulate_offsets_from_center_last(y_offset: torch.Tensor) -> torch.Tensor:
    """(..., K) -> (..., K): out[centre] = 0, out[centre+i] = sum of the i
    offsets above the centre, out[centre-i] = sum of the i offsets below it."""
    k = y_offset.shape[-1]
    center = k // 2
    # running adds, not torch.cumsum: on CUDA a cumsum over this short last
    # axis runs one block per row and took a fifth of MM_Net's device time
    parts = [torch.zeros_like(y_offset[..., :1])]
    for step in (1, -1):
        acc = None
        for j in range(center + step, k if step > 0 else -1, step):
            v = y_offset[..., j : j + 1]
            acc = v if acc is None else acc + v
            parts.insert(len(parts) if step > 0 else 0, acc)
    return torch.cat(parts, dim=-1)
