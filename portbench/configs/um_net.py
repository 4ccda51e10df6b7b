"""UM_Net's hand-written kernel launches of one forward, worked out from the
architecture, not read from the program's modules.

Every DSConv (9 taps, morph 0) launches one tap-conv (kernel 3; kernel 4 in
its backward) at its input's resolution; each RCG's forward-only Mamba
(d_model 64: D 128, dt_rank 4) one fused scan (kernels 1/2) over the
(2H)(2W) tokens of its upsampled map. The HPPF head's DSConv runs on its
4 x 4 max-pooled map."""

from __future__ import annotations

import math


def kernel_shapes(cfg: dict, batch: int, size: int) -> dict:
    """As `configs/mm_net.py::kernel_shapes`."""
    w = cfg["widths"]
    k, dec, dm = w["dsconv_kernel"], w["decoder"], w["rcg_d_model"]
    taps: dict = {}
    scans: dict = {}

    def dsconv(res, cin, cout):
        key = (batch, res, res, cin, cout, k)
        taps[key] = taps.get(key, 0) + 1

    def decoder(res, cin, cout):
        dsconv(res, cin, cin // 4)
        dsconv(res, cin // 4, cout)

    s = [size // (2 << i) for i in range(5)]
    decoder(s[4], dec, dec)  # decoder5
    dsconv(s[3], dec, dec // 4)  # side5
    for res in (s[3], s[2], s[1]):  # rcg, decoder, side at each level
        dsconv(res, 2 * dec, dec)
        key = (batch, w["mamba_expand"] * dm, (2 * res) ** 2, w["mamba_d_state"],
               math.ceil(dm / 16), w["mamba_d_conv"])
        scans[key] = scans.get(key, 0) + 1
        decoder(res, 2 * dec, dec)
        dsconv(2 * res, dec, dec // 4)
    c = w["hppf_channels"]
    dsconv(4, c, c // 16)
    return {"mamba_fused": sorted(scans.items()), "tap_conv": sorted(taps.items())}
