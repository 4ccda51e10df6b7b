"""TFM ("Token Flow Module") Mamba, bimamba v3 (counterpart of
`mm_unet_tpu/models/mamba.py::Mamba` with `bimamba_type="v3"`).

Three scans with independent weights: forward over the tokens, reverse
(weights `*_b`) and a slice-interleaved spatial scan (weights `*_s`). The
order of operations is the reference's kernel path (`mamba.py:263-305`,
`:326-340`): the slice direction interleaves the tokens and re-projects them,
and its output is projected before it is un-interleaved; the reverse
direction goes in unflipped and is scanned right-to-left by the fused scan.
Every direction is one `mamba_fused_scan` call.

Parameter names are the torch reference's (`mm_unet_tpu.utils.torch_convert.
mamba_pairs`): in_proj, out_proj, conv1d{s}, x_proj{s}, dt_proj{s}, A{s}_log,
D{s} for s in "", "_b", "_s".
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from mm_unet_tpu_torch.models.layers import lecun_normal_
from mm_unet_tpu_torch.ops.mamba_fused import mamba_fused_scan

DIRECTIONS = ("", "_b", "_s")


class Mamba(nn.Module):
    """(B, L, d_model) -> (out, o_fwd, o_bwd, o_slice); the three auxiliary
    returns are the pre-projection direction outputs in the reference's
    domains (o_bwd flipped, o_slice un-interleaved)."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4, expand: int = 2,
                 dt_min: float = 0.001, dt_max: float = 0.1, dt_init_floor: float = 1e-4,
                 nslices: int = 5, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d_model, self.d_state, self.nslices, self.dtype = d_model, d_state, nslices, dtype
        self.d_inner = d_in = expand * d_model
        self.dt_rank = r = math.ceil(d_model / 16)
        n = d_state
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.in_proj = nn.Linear(d_model, 2 * d_in, bias=False)
        # flax's lecun_normal reads fan_in from axis -2 of each stored shape
        lecun_normal_(self.in_proj.weight, 2 * d_in, g)
        dt_std = r ** -0.5
        for s in DIRECTIONS:
            conv = nn.Conv1d(d_in, d_in, d_conv, groups=d_in, bias=True)
            lecun_normal_(conv.weight, d_in, g)
            nn.init.zeros_(conv.bias)
            x_proj = nn.Linear(d_in, r + 2 * n, bias=False)
            lecun_normal_(x_proj.weight, r + 2 * n, g)
            dt_proj = nn.Linear(r, d_in, bias=True)
            with torch.no_grad():
                dt_proj.weight.uniform_(-dt_std, dt_std, generator=g)
                dt = torch.exp(torch.rand(d_in, generator=g)
                               * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
                dt = dt.clamp(min=dt_init_floor)
                dt_proj.bias.copy_(dt + torch.log(-torch.expm1(-dt)))  # softplus^-1
            a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32)).repeat(d_in, 1)
            setattr(self, f"conv1d{s}", conv)
            setattr(self, f"x_proj{s}", x_proj)
            setattr(self, f"dt_proj{s}", dt_proj)
            self.register_parameter(f"A{s}_log", nn.Parameter(a_log))
            self.register_parameter(f"D{s}", nn.Parameter(torch.ones(d_in)))
        self.out_proj = nn.Linear(d_in, d_model, bias=False)
        lecun_normal_(self.out_proj.weight, d_model, g)

    def _scan(self, xz: torch.Tensor, s: str, reverse: bool = False) -> torch.Tensor:
        conv = getattr(self, f"conv1d{s}")
        dt_proj = getattr(self, f"dt_proj{s}")
        A = -torch.exp(getattr(self, f"A{s}_log").float())
        return mamba_fused_scan(
            xz[:, None], conv.weight[None, :, 0], conv.bias[None],
            getattr(self, f"x_proj{s}").weight[None], dt_proj.weight[None],
            dt_proj.bias[None], A[None], getattr(self, f"D{s}")[None], reverse=reverse,
        )[:, 0]

    def forward(self, hidden_states: torch.Tensor):
        batch, seqlen, dm = hidden_states.shape
        ns = self.nslices
        if seqlen % ns:
            raise ValueError(f"v3 slice scan requires seqlen % nslices == 0, got {seqlen} % {ns}")
        cd = self.dtype or hidden_states.dtype
        x = hidden_states.to(cd)
        w_in = self.in_proj.weight.to(cd)
        xz = torch.einsum("bld,ed->bel", x, w_in)  # (B, 2D, L)
        # slice direction: token (s, l) -> position l*ns + s, then re-project
        x_il = x.reshape(batch, ns, seqlen // ns, dm).transpose(1, 2).reshape(batch, seqlen, dm)
        xz_s = torch.einsum("bld,ed->bel", x_il, w_in)

        y_fwd = self._scan(xz, "")
        y_sl = self._scan(xz_s, "_s")
        y_rev = self._scan(xz, "_b", reverse=True)

        w_out = self.out_proj.weight.to(cd)
        out = torch.einsum("bdl,ed->ble", y_fwd + y_rev, w_out)
        o3p = torch.einsum("bdl,ed->ble", y_sl, w_out)
        out = out + o3p.reshape(batch, seqlen // ns, ns, dm).transpose(1, 2).reshape(batch, seqlen, dm)

        d = self.d_inner
        o_slice = y_sl.reshape(batch, d, seqlen // ns, ns).transpose(2, 3).reshape(batch, d, seqlen)
        return out, y_fwd, y_rev.flip(-1), o_slice
