"""MM_Net's hand-written kernel launches of one forward, worked out from the
architecture (widths, depths, kernel sizes, batch, input size), not read
from the program's modules.

Every MMConv launches one tap-conv (kernel 3; kernel 4 in its backward) at
its input's resolution, and its TFM Mamba (d_model k, so D = 2k channels,
dt_rank 1) three fused scans (kernels 1/2: forward, reverse and slice
directions) over its H W tokens; each RCG's Mamba (d_model 64: D 128,
dt_rank 4) three over the (2H)(2W) tokens of its upsampled map.

With `remat` on, every MMConv runs its sample-and-conv part (the tap-conv
and its GroupNorm) again in the backward pass: one more forward launch of
kernel 3 per MMConv in a training step; its Mamba and the backward kernels
run once."""

from __future__ import annotations

import math


def kernel_shapes(cfg: dict, batch: int, size: int) -> dict:
    """{"mamba_fused": [((B, D, L, N, R, W), launches)], "tap_conv": [((B,
    H, W, C, F, K), launches)]} of one forward at (batch, 3, size, size)."""
    w = cfg["widths"]
    depths = cfg["model_kwargs"]["depths"]
    n_state, d_conv, expand = w["mamba_d_state"], w["mamba_d_conv"], w["mamba_expand"]
    k3 = w["mmconv_kernel"]
    taps: dict = {}
    scans: dict = {}

    def mamba(d_model, tokens):
        key = (batch, expand * d_model, tokens, n_state, math.ceil(d_model / 16), d_conv)
        scans[key] = scans.get(key, 0) + 3

    def mmconv(res, cin, cout, k=k3):
        key = (batch, res, res, cin, cout, k)
        taps[key] = taps.get(key, 0) + 1
        mamba(k, res * res)

    s = [size // (2 << i) for i in range(5)]  # s[0] stem ... s[4] stage 5
    c = [w["stem"]] + list(w["stages"])
    for i in range(4):  # encoder stages 2..5 at s[1..4]
        res, cin, cout = s[i + 1], c[i], c[i + 1]
        first = 1 if i else 2  # a downsampling block has one MMConv
        for b in range(depths[i]):
            n = first if b == 0 else 2
            for j in range(n):
                mmconv(res, cin if (b == 0 and j == 0 and i == 0) else cout, cout)
    dec = w["decoder"]
    for i, cin in ((2, c[2]), (3, c[3]), (4, c[4])):  # down3..5: 1x1 MMConvs
        mmconv(s[i], cin, dec, 1)

    def decoder(res, cin, cout):
        mmconv(res, cin, cin // 4)
        mmconv(res, cin // 4, cout)

    decoder(s[4], dec, dec)  # decoder5
    mmconv(s[3], dec, dec // 4)  # side5
    for res in (s[3], s[2], s[1]):  # rcg4, decoder4, side4; rcg3 ...; rcg2 ...
        mmconv(res, 2 * dec, dec)
        mamba(w["rcg_d_model"], (2 * res) ** 2)
        decoder(res, 2 * dec, dec)
        mmconv(2 * res, dec, dec // 4)
    return {"mamba_fused": sorted(scans.items()), "tap_conv": sorted(taps.items())}


def recomputed_shapes(cfg: dict, batch: int, size: int) -> dict:
    """The forward launches a training step runs again in its backward, as
    `kernel_shapes` gives them: every tap-conv once more with `remat` on
    (the model's default), nothing with it off."""
    if not cfg["model_kwargs"].get("remat", True):
        return {}
    return {"tap_conv": kernel_shapes(cfg, batch, size)["tap_conv"]}
