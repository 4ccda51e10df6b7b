"""TFM ("Token Flow Module") Mamba (counterpart of
`mm_unet_tpu/models/mamba.py::Mamba`).

`bimamba_type` picks the directions, each with its own weights: "none" scans
forward over the tokens; "v2" adds a reverse scan (weights `*_b`); "v3" (and
"v1", read as v3 as the JAX module does) adds a slice-interleaved spatial
scan (weights `*_s`).

Two routes compute the same function:
- the megakernel route (`_mega_scan`, `mamba.py:128-163`, `:268-305`): every
  direction is one `mamba_fused_scan` call (causal conv, projections, scan
  and gate in one kernel). The reverse direction goes in unflipped and is
  scanned right-to-left; v3's slice direction interleaves the tokens,
  re-projects them, and is projected before it is un-interleaved.
- the grouped-scan route (`_fused_scan`, `mamba.py:165-214`): one depthwise
  causal conv over all directions' channels, batched einsum projections and
  ONE `selective_scan` launch in which direction g is channel group g with
  its own B/C stream (v2 takes [xz, flip(xz)], v3 adds interleave(xz)).

Dispatch: `scan_impl="mega"`, or None with d_state % 8 == 0, takes the
megakernel route; anything else ("pallas", "ref", "assoc", or None with
another d_state) takes the grouped-scan route with `scan_impl` as the
scan's implementation. A mixer with Jamba's dt/B/C norms (`ssm_norm_eps`)
always takes the grouped-scan route: the norms sit between x_proj and
dt_proj, which the megakernel computes inside itself. The JAX module also
asks for a TPU before it takes the megakernel by default
(`mamba.py:263-266`); the port does not, on purpose: its CPU path is its
card path with the kernels' plain versions, so a model takes the same
route, with the same launch counts, on either device.

Returns (out, o_fwd, o_bwd, o_slice) for v3 (the pre-projection direction
outputs in the reference's domains: o_bwd flipped, o_slice un-interleaved),
else `out` alone.

Parameter names are the torch reference's (`mm_unet_tpu.utils.torch_convert.
mamba_pairs`): in_proj, out_proj, conv1d{s}, x_proj{s}, dt_proj{s}, A{s}_log,
D{s} for each direction suffix s; with `ssm_norm_eps`, Jamba's
dt_layernorm, b_layernorm and c_layernorm besides.

`tp` (a process group, set by `parallel.tp.shard_params`) makes the module
tensor-parallel over its channels: the three collectives of
`parallel/tp.py` run on the grouped-scan route.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from mm_unet_tpu_torch.models.layers import lecun_normal_
from mm_unet_tpu_torch.ops.causal_conv1d import causal_conv1d
from mm_unet_tpu_torch.ops.mamba_fused import mamba_fused_scan
from mm_unet_tpu_torch.ops.selective_scan import selective_scan
from mm_unet_tpu_torch.parallel.comm import all_reduce_sum, copy_to_group, reduce_from_group

# weight-set suffixes of each bimamba type, in the order the weights are drawn
DIRECTIONS = {"v3": ("", "_b", "_s"), "v2": ("", "_b"), "none": ("",)}


def kernel_launches(model: nn.Module) -> dict[str, int]:
    """Kernel launches of one forward of every Mamba in `model`, by kernel."""
    counts: dict[str, int] = {}
    for m in model.modules():
        if isinstance(m, Mamba):
            for k, v in m.kernel_launches_per_forward().items():
                counts[k] = counts.get(k, 0) + v
    return counts


def _rms_rows(x: torch.Tensor, norm: nn.RMSNorm) -> torch.Tensor:
    """`norm` (an RMSNorm over C features) at every token of x (..., C, L):
    computed in f32 and cast back before the weight, as Jamba's RMSNorm."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-2, keepdim=True) + norm.eps)
    return norm.weight.to(x.dtype)[:, None] * y.to(x.dtype)


class Mamba(nn.Module):
    """Selective-state-space mixer over (B, L, d_model) token sequences."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4, expand: int = 2,
                 dt_rank: int | str = "auto", dt_min: float = 0.001, dt_max: float = 0.1,
                 dt_init: str = "random", dt_scale: float = 1.0, dt_init_floor: float = 1e-4,
                 conv_bias: bool = True, bias: bool = False, bimamba_type: str = "v3",
                 nslices: int = 5, dtype: Optional[torch.dtype] = None,
                 scan_impl: Optional[str] = None, ssm_norm_eps: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.bimamba_type = "v3" if bimamba_type == "v1" else bimamba_type
        if self.bimamba_type not in DIRECTIONS:
            raise ValueError(f"bimamba_type {bimamba_type!r} not in v1, v2, v3, none")
        if dt_init not in ("random", "constant"):
            raise NotImplementedError(dt_init)
        self.d_model, self.d_state, self.nslices, self.dtype = d_model, d_state, nslices, dtype
        self.scan_impl = scan_impl
        self.tp = None  # the tensor-parallel group (parallel/tp.py)
        self.d_inner = d_in = int(expand * d_model)
        self.dt_rank = r = math.ceil(d_model / 16) if dt_rank == "auto" else dt_rank
        n = d_state
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.in_proj = nn.Linear(d_model, 2 * d_in, bias=bias)
        # flax's lecun_normal reads fan_in from axis -2 of each stored shape
        lecun_normal_(self.in_proj.weight, 2 * d_in, g)
        dt_std = r ** -0.5 * dt_scale
        for s in DIRECTIONS[self.bimamba_type]:
            conv = nn.Conv1d(d_in, d_in, d_conv, groups=d_in, bias=conv_bias)
            lecun_normal_(conv.weight, d_in, g)
            x_proj = nn.Linear(d_in, r + 2 * n, bias=False)
            lecun_normal_(x_proj.weight, r + 2 * n, g)
            dt_proj = nn.Linear(r, d_in, bias=True)
            with torch.no_grad():
                if dt_init == "random":
                    dt_proj.weight.uniform_(-dt_std, dt_std, generator=g)
                else:
                    dt_proj.weight.fill_(dt_std)
                dt = torch.exp(torch.rand(d_in, generator=g)
                               * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
                dt = dt.clamp(min=dt_init_floor)
                dt_proj.bias.copy_(dt + torch.log(-torch.expm1(-dt)))  # softplus^-1
                if conv.bias is not None:
                    conv.bias.zero_()
            a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32)).repeat(d_in, 1)
            setattr(self, f"conv1d{s}", conv)
            setattr(self, f"x_proj{s}", x_proj)
            setattr(self, f"dt_proj{s}", dt_proj)
            self.register_parameter(f"A{s}_log", nn.Parameter(a_log))
            self.register_parameter(f"D{s}", nn.Parameter(torch.ones(d_in)))
        self.ssm_norm_eps = ssm_norm_eps
        if ssm_norm_eps is not None:
            # Jamba's RMSNorms on dt, B and C, each over its own rows of x_dbl
            if self.bimamba_type != "none":
                raise ValueError("ssm_norm_eps: Jamba's dt/B/C norms take one direction "
                                 f"(bimamba_type 'none'), got {bimamba_type!r}")
            self.dt_layernorm = nn.RMSNorm(r, ssm_norm_eps)
            self.b_layernorm = nn.RMSNorm(n, ssm_norm_eps)
            self.c_layernorm = nn.RMSNorm(n, ssm_norm_eps)
        self.out_proj = nn.Linear(d_in, d_model, bias=bias)
        lecun_normal_(self.out_proj.weight, d_model, g)
        for lin in (self.in_proj, self.out_proj):
            if lin.bias is not None:
                nn.init.zeros_(lin.bias)

    @property
    def use_mega(self) -> bool:
        """Whether this module takes the megakernel route (see the module
        docstring); never with Jamba's dt/B/C norms."""
        if self.ssm_norm_eps is not None:
            return False
        return self.scan_impl == "mega" or (self.scan_impl is None and self.d_state % 8 == 0)

    def kernel_launches_per_forward(self) -> dict[str, int]:
        """Kernel launches of one forward: one fused scan per direction on the
        megakernel route, one grouped selective scan on the other (none when
        the plain scan is asked for)."""
        if self.use_mega:
            return {"mamba_fused_scan": len(DIRECTIONS[self.bimamba_type])}
        if self.scan_impl in (None, "auto", "pallas"):
            return {"selective_scan": 1}
        return {}

    def _project_in(self, x: torch.Tensor, w_in: torch.Tensor) -> torch.Tensor:
        xz = torch.einsum("bld,ed->bel", x, w_in)  # (B, 2D, L)
        if self.in_proj.bias is not None:
            xz = xz + self.in_proj.bias.to(xz.dtype)[None, :, None]
        return xz

    def _mega_one(self, xz: torch.Tensor, s: str, reverse: bool = False) -> torch.Tensor:
        conv = getattr(self, f"conv1d{s}")
        dt_proj = getattr(self, f"dt_proj{s}")
        A = -torch.exp(getattr(self, f"A{s}_log").float())
        return mamba_fused_scan(
            xz[:, None], conv.weight[None, :, 0], None if conv.bias is None else conv.bias[None],
            getattr(self, f"x_proj{s}").weight[None], dt_proj.weight[None],
            dt_proj.bias[None], A[None], getattr(self, f"D{s}")[None], reverse=reverse,
        )[:, 0]

    def _fused_scan(self, xz_dirs: list[torch.Tensor], sfx: tuple) -> torch.Tensor:
        """All directions fused into one depthwise conv, one batched
        projection pair and one grouped selective scan: direction g occupies
        channel group g. xz_dirs: list of (B, 2 D, L). Returns (B, G, D, L)."""
        cd = self.dtype or xz_dirs[0].dtype
        bsz, _, length = xz_dirs[0].shape
        g, d_in, r, n = len(xz_dirs), self.d_inner, self.dt_rank, self.d_state
        x_all = torch.cat([xz[:, :d_in] for xz in xz_dirs], dim=1)  # (B, G D, L)
        z_all = torch.cat([xz[:, d_in:] for xz in xz_dirs], dim=1)
        convs = [getattr(self, f"conv1d{s}") for s in sfx]
        conv_w = torch.cat([c.weight[:, 0] for c in convs]).to(cd)
        conv_b = None if convs[0].bias is None else torch.cat([c.bias for c in convs])
        x_all = causal_conv1d(x_all, conv_w, conv_b, activation="silu")
        x_proj = torch.stack([getattr(self, f"x_proj{s}").weight for s in sfx]).to(cd)
        dt_w = torch.stack([getattr(self, f"dt_proj{s}").weight for s in sfx]).to(cd)
        x_dbl = torch.einsum("bgdl,ged->bgel", x_all.reshape(bsz, g, d_in, length), x_proj)
        if self.tp is not None:  # row-parallel x_proj: the ranks' partial sums
            x_dbl = all_reduce_sum(x_dbl, self.tp)
        dt_in, b_in, c_in = x_dbl[:, :, :r], x_dbl[:, :, r:r + n], x_dbl[:, :, r + n:]
        if self.ssm_norm_eps is not None:
            dt_in, b_in, c_in = (_rms_rows(v, norm) for v, norm in (
                (dt_in, self.dt_layernorm), (b_in, self.b_layernorm), (c_in, self.c_layernorm)))
        dt = torch.einsum("bgrl,gdr->bgdl", dt_in, dt_w).reshape(bsz, g * d_in, length)
        A = -torch.exp(torch.stack([getattr(self, f"A{s}_log") for s in sfx]).float())
        dt_b = torch.cat([getattr(self, f"dt_proj{s}").bias for s in sfx]).float()
        d_skip = torch.cat([getattr(self, f"D{s}") for s in sfx]).float()
        y = selective_scan(
            x_all, dt, A.reshape(g * d_in, n), b_in, c_in, D=d_skip, z=z_all, delta_bias=dt_b,
            delta_softplus=True, implementation=self.scan_impl,
        )
        return y.reshape(bsz, g, d_in, length)

    def forward(self, hidden_states: torch.Tensor):
        batch, seqlen, dm = hidden_states.shape
        bt, ns = self.bimamba_type, self.nslices
        if bt == "v3" and seqlen % ns:
            raise ValueError(f"v3 slice scan requires seqlen % nslices == 0, got {seqlen} % {ns}")
        cd = self.dtype or hidden_states.dtype
        x = hidden_states.to(cd)
        if self.tp is not None:  # every rank's in_proj rows read the whole input
            x = copy_to_group(x, self.tp)
        w_in = self.in_proj.weight.to(cd)
        xz = self._project_in(x, w_in)

        def interleave(v):  # token (s, l) -> position l * ns + s
            return v.reshape(batch, v.shape[1], ns, seqlen // ns).transpose(2, 3).reshape(
                batch, v.shape[1], seqlen)

        def uninterleave(v):
            return v.reshape(batch, v.shape[1], seqlen // ns, ns).transpose(2, 3).reshape(
                batch, v.shape[1], seqlen)

        o_2 = o_3 = y_sl = None
        if self.use_mega:
            o_1 = self._mega_one(xz, "")
            out_dirs = o_1
            if bt == "v3":
                # interleave the tokens and re-project (in_proj is per-token)
                x_il = x.reshape(batch, ns, seqlen // ns, dm).transpose(1, 2).reshape(
                    batch, seqlen, dm)
                y_sl = self._mega_one(self._project_in(x_il, w_in), "_s")
                o_3 = uninterleave(y_sl)
            if bt in ("v2", "v3"):
                y_rev = self._mega_one(xz, "_b", reverse=True)
                out_dirs = out_dirs + y_rev
                o_2 = y_rev.flip(-1)  # the reference's (flipped) domain
        else:
            dirs = [xz]
            if bt in ("v2", "v3"):
                dirs.append(xz.flip(-1))
            if bt == "v3":
                dirs.append(interleave(xz))
            ys = self._fused_scan(dirs, DIRECTIONS[bt])
            o_1 = ys[:, 0]
            out_dirs = o_1
            if bt in ("v2", "v3"):
                o_2 = ys[:, 1]
                out_dirs = out_dirs + o_2.flip(-1)
            if bt == "v3":
                o_3 = uninterleave(ys[:, 2])
                out_dirs = out_dirs + o_3

        w_out = self.out_proj.weight.to(cd)
        out = torch.einsum("bdl,ed->ble", out_dirs, w_out)
        if y_sl is not None:
            # slice direction: project in its own token domain, then
            # un-interleave the (B, L, d_model) result
            o3p = torch.einsum("bdl,ed->ble", y_sl, w_out)
            out = out + o3p.reshape(batch, seqlen // ns, ns, dm).transpose(1, 2).reshape(
                batch, seqlen, dm)
        if self.tp is not None:  # row-parallel out_proj
            out = reduce_from_group(out, self.tp)
        if self.out_proj.bias is not None:
            out = out + self.out_proj.bias.to(cd)
        if bt == "v3":
            return out, o_1, o_2, o_3
        return out


class Block(nn.Module):
    """Prenorm residual wrapper, Add -> Norm -> Mixer (counterpart of
    `mm_unet_tpu/models/mamba.py::Block`, the reference's
    `mamba_simple.py:453-506`). Returns (hidden_states, residual).

    `rms_norm` picks RMSNorm (`nn.RMSNorm`, flax's `nn.RMSNorm`) over
    LayerNorm, both at `norm_epsilon`; with
    `fused_add_norm` the add and the norm run in f32 before the cast back
    (the observable effect of the reference's fused Triton add+norm);
    `residual_in_fp32` keeps the residual f32. The norm always computes in
    f32, as flax's does on a narrower input. The mixer is `Mamba` with
    `mamba_kwargs` (bimamba_type "none" unless they say otherwise). Names
    follow the reference: `norm.weight`, `norm.bias`, `mixer.*`."""

    def __init__(self, dim: int, norm_epsilon: float = 1e-5, residual_in_fp32: bool = False,
                 rms_norm: bool = False, fused_add_norm: bool = False,
                 mamba_kwargs: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.residual_in_fp32, self.fused_add_norm = residual_in_fp32, fused_add_norm
        kw = {"bimamba_type": "none", **(mamba_kwargs or {})}
        self.mixer = Mamba(d_model=dim, generator=generator, **kw)
        self.norm = (nn.RMSNorm(dim, norm_epsilon) if rms_norm
                     else nn.LayerNorm(dim, norm_epsilon))

    def add_norm(self, hidden_states: torch.Tensor,
                 residual: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
        """(the mixer's input, the new residual): the Add and the Norm."""
        dtype = hidden_states.dtype
        if self.fused_add_norm:
            hs32 = hidden_states.float()
            residual = hs32 + residual if residual is not None else hs32
            if not self.residual_in_fp32:
                residual = residual.to(dtype)
        else:
            residual = hidden_states + residual if residual is not None else hidden_states
            if self.residual_in_fp32:
                residual = residual.float()
        return self.norm(residual.float()).to(dtype), residual

    def forward(self, hidden_states: torch.Tensor, residual: Optional[torch.Tensor] = None):
        h, residual = self.add_norm(hidden_states, residual)
        h = self.mixer(h)
        if isinstance(h, tuple):
            h = h[0]
        return h, residual
