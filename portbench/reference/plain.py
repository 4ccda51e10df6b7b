"""Plain PyTorch building blocks of the benchmark's frozen references:
convolutions, norms, the bidirectional slice Mamba with its selective scan
as a plain recurrence, and the deformable row-sample convolution as a plain
gather. Written from the architecture's equations; imports nothing of the
program under test.

Every block computes in f32. `quant`, given to a block, rounds the inputs
of its products (convolutions, projections, the tap products): the
references pass `identity`, and the CPU tests' stand-in for the card's
TF32 control passes `tf32_round`; a bf16 feature path's control passes
`fp8_round`.

The recurrence h_t = exp(dt_t A) h_(t-1) + dt_t B_t u_t runs by recursive
doubling over all tokens where its state is small, else over blocks of
tokens with the state carried from block to block, each block as chunks of
16 tokens stepped together and joined by doubling: elementwise
multiply-adds only, no product of matrices. The blocks are recomputed in
the backward pass (`torch.utils.checkpoint`), as are the models' blocks
(`remat`), so that a reference at a benchmark's batch fits on the card.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Quant = Callable[[torch.Tensor], torch.Tensor]
SCAN_BLOCK_BYTES = 128 << 20  # f32 bytes of one (batch, channels, states, tokens) block


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def remat(fn, *args):
    """fn(*args), its activations recomputed in the backward pass when
    training (never on the meta device, where products are only counted).
    fn draws no random numbers."""
    if torch.is_grad_enabled() and args[0].device.type != "meta":
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class Remat(nn.Sequential):
    """nn.Sequential recomputed in the backward pass (`remat`)."""

    def forward(self, x):
        return remat(super().forward, x)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10 mantissa bits (to nearest, ties away from
    zero), in f32; the gradient passes through unchanged. The CPU's stand-in
    for the card's TF32 products."""
    bits = x.detach().float().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x.detach())


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per tensor (its largest
    magnitude to 448), in f32; the gradient passes through unchanged. The
    control of a bf16 feature path."""
    xd = x.detach().float()
    scale = xd.abs().amax().clamp(min=1e-30) / 448.0
    r = (xd / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (r - xd)


def set_quant(model: nn.Module, quant: Quant) -> nn.Module:
    """Give every block of `model` that rounds (`quant` attribute) `quant`."""
    for m in model.modules():
        if hasattr(m, "quant"):
            m.quant = quant
    return model


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose input and weight pass through `quant`."""

    def __init__(self, *args, quant: Quant = identity, **kwargs):
        super().__init__(*args, **kwargs)
        self.quant = quant

    def forward(self, x):
        return self._conv_forward(self.quant(x), self.quant(self.weight), self.bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    def __init__(self, *args, quant: Quant = identity, **kwargs):
        super().__init__(*args, **kwargs)
        self.quant = quant

    def forward(self, x):
        return F.conv_transpose2d(self.quant(x), self.quant(self.weight), self.bias, self.stride,
                                  self.padding, self.output_padding, self.groups, self.dilation)


class BatchNorm2d(nn.BatchNorm2d):
    """Batch normalisation with the biased batch variance E[x^2] - E[x]^2
    (clipped at 0) in training, whose running statistics follow
    running = 0.9 running + 0.1 batch; the running statistics in eval."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps)

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        mean = x.mean((0, 2, 3))
        var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class GroupNorm(nn.GroupNorm):
    def __init__(self, num_groups: int, num_channels: int):
        super().__init__(num_groups, num_channels, eps=1e-5)


class Dropout2d(nn.Module):
    """Channel dropout in training: each (sample, channel) plane is kept when
    a U(0, 1) draw from `generator` is below 1 - p, and scaled by 1 / (1 - p).
    The draws are one (batch, channels, 1, 1) tensor per call."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        u = torch.rand((x.shape[0], x.shape[1], 1, 1), generator=self.generator, device=x.device)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


def set_dropout_generator(model: nn.Module, generator) -> None:
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.generator = generator


def resize(x: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear resize with aligned corners."""
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=True)


class CBAM(nn.Module):
    """Channel attention (shared MLP over the mean- and max-pooled maps),
    then spatial attention (7x7 conv over the channel max and mean)."""

    def __init__(self, channel: int, reduction: int = 16, quant: Quant = identity):
        super().__init__()
        self.mlp = nn.Sequential(Conv2d(channel, channel // reduction, 1, bias=False, quant=quant),
                                 nn.ReLU(),
                                 Conv2d(channel // reduction, channel, 1, bias=False, quant=quant))
        self.conv = Conv2d(2, 1, 7, padding=3, bias=False, quant=quant)

    def forward(self, x):
        c = self.mlp(x.mean((2, 3), keepdim=True)) + self.mlp(x.amax((2, 3), keepdim=True))
        y = torch.sigmoid(c) * x
        s = torch.cat([y.amax(1, keepdim=True), y.mean(1, keepdim=True)], dim=1)
        return torch.sigmoid(self.conv(s)) * y


# the selective scan ---------------------------------------------------------

def _affine_prefix(a, b):
    """Inclusive prefix of x_j = a_j x_(j-1) + b_j, x_(-1) = 0, along the last
    axis by recursive doubling; returns x."""
    k, n = 1, a.shape[-1]
    while k < n:
        b = torch.cat([b[..., :k], b[..., k:] + a[..., k:] * b[..., :-k]], dim=-1)
        a = torch.cat([a[..., :k], a[..., k:] * a[..., :-k]], dim=-1)
        k *= 2
    return b


def _scan_block(h0, u, dt, A, Bm, Cm):
    """One block of T tokens from entry state h0 (B, D, N); u, dt (B, D, T);
    A (D, N); Bm, Cm (B, N, T). The block is c chunks of `SUB` tokens: a
    loop over the SUB positions runs every chunk at once from a zero state,
    giving each chunk's outputs, end state and decay product; the chunks'
    entry states follow by recursive doubling over the chunks; a second
    pass over the positions adds each entry state's decayed part. Returns (y (B,
    D, T), the state after the block)."""
    bsz, d, length = u.shape
    t = min(SUB, length)
    c = length // t
    dtc, bx = dt.reshape(bsz, d, c, t), (dt * u).reshape(bsz, d, c, t)
    bmc, cmc = Bm.reshape(bsz, -1, c, t), Cm.reshape(bsz, -1, c, t)

    def decay(i):
        return torch.exp(dtc[:, :, None, :, i] * A[None, :, :, None])  # (B, D, N, c)

    h = acc = None
    y_loc, accs = [], []
    for i in range(t):
        a = decay(i)
        drive = bx[:, :, None, :, i] * bmc[:, None, :, :, i]
        h, acc = (drive, a) if h is None else (a * h + drive, acc * a)
        y_loc.append((h * cmc[:, None, :, :, i]).sum(2))
        accs.append(acc)
    # the state after each chunk, h0 entering the first
    h = torch.cat([h[..., :1] + acc[..., :1] * h0[..., None], h[..., 1:]], dim=-1)
    after = _affine_prefix(acc, h)
    entry = torch.cat([h0[..., None], after[..., :-1]], dim=-1)
    y = [y_loc[i] + (accs[i] * entry * cmc[:, None, :, :, i]).sum(2) for i in range(t)]
    return torch.stack(y, dim=-1).reshape(bsz, d, length), after[..., -1]


SUB = 16  # tokens of a chunk of `_scan_block`
SMALL_SCAN_BYTES = 256 << 20  # a scan whose (B, D, N, L) f32 state fits runs by doubling alone
SCAN_BLOCK_BYTES = 1 << 30  # the state of one block of a larger scan
DIRECTION_REMAT_BYTES = 2 << 30  # a direction's (B, L, D) f32 stream past this is recomputed


def _doubling(u, dt, A, Bm, Cm):
    a = torch.exp(dt[:, :, None, :] * A[None, :, :, None])
    b = (dt * u)[:, :, None, :] * Bm[:, None]
    return (_affine_prefix(a, b) * Cm[:, None]).sum(2)


def selective_scan(u, dt, A, Bm, Cm):
    """y_t = C_t . h_t over h_t = exp(dt_t A) h_(t-1) + dt_t B_t u_t, h_0 = 0.
    u, dt (B, D, L) f32; A (D, N); Bm, Cm (B, N, L). Returns (B, D, L).
    A small scan runs by recursive doubling over all its tokens; a larger
    one in blocks of a power of two of tokens, the last block shorter where
    L is no multiple of the block, each recomputed in the backward pass.
    Tokens appended to make L a multiple of `SUB` come after every real one,
    so they change no output that is kept."""
    bsz, d, length = u.shape
    n = A.shape[1]
    per_token = bsz * d * n * 4
    if per_token * length <= SMALL_SCAN_BYTES:
        return _doubling(u, dt, A, Bm, Cm)
    t = max(SUB, 1 << int(math.log2(max(SCAN_BLOCK_BYTES // per_token, 1))))
    pad = -length % SUB
    if pad:
        u, dt, Bm, Cm = (F.pad(v, (0, pad)) for v in (u, dt, Bm, Cm))
    h = u.new_zeros(bsz, d, n)
    ys = []
    blockwise = torch.is_grad_enabled() and u.device.type != "meta"
    for s in range(0, length + pad, t):
        args = (h, u[..., s:s + t], dt[..., s:s + t], A, Bm[..., s:s + t], Cm[..., s:s + t])
        y, h = (checkpoint(_scan_block, *args, use_reentrant=False) if blockwise
                else _scan_block(*args))
        ys.append(y)
    return torch.cat(ys, dim=-1)[..., :length]


DIRECTIONS = {"v3": ("", "_b", "_s"), "none": ("",)}


class Mamba(nn.Module):
    """The Mamba mixer over (B, L, d_model) tokens: in_proj to (x, z); per
    direction a causal depthwise conv + SiLU, x_proj to (dt, B, C), dt_proj
    + softplus, the selective scan with the skip D u, gated by silu(z). "v3"
    adds a reversed scan (weights `*_b`) and a scan over the tokens
    interleaved by `nslices` slices (weights `*_s`); "none" scans forward
    only. The directions' outputs, each in the original token order, are
    summed and projected by out_proj. A direction whose streams pass
    `DIRECTION_REMAT_BYTES` is recomputed in the backward pass (`remat`)."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4, expand: int = 2,
                 bimamba_type: str = "v3", nslices: int = 5, quant: Quant = identity):
        super().__init__()
        self.bimamba_type, self.nslices, self.quant = bimamba_type, nslices, quant
        self.d_inner = d_in = expand * d_model
        self.dt_rank = r = math.ceil(d_model / 16)
        self.d_state = n = d_state
        self.in_proj = nn.Linear(d_model, 2 * d_in, bias=False)
        for s in DIRECTIONS[bimamba_type]:
            setattr(self, f"conv1d{s}", nn.Conv1d(d_in, d_in, d_conv, groups=d_in, bias=True))
            setattr(self, f"x_proj{s}", nn.Linear(d_in, r + 2 * n, bias=False))
            setattr(self, f"dt_proj{s}", nn.Linear(r, d_in, bias=True))
            self.register_parameter(f"A{s}_log", nn.Parameter(torch.zeros(d_in, n)))
            self.register_parameter(f"D{s}", nn.Parameter(torch.ones(d_in)))
        self.out_proj = nn.Linear(d_in, d_model, bias=False)

    def _lin(self, x, lin):
        return F.linear(self.quant(x), self.quant(lin.weight), lin.bias)

    def _direction(self, xz: torch.Tensor, s: str) -> torch.Tensor:
        """xz (B, L, 2 D) -> gated scan output (B, L, D)."""
        d, r, n = self.d_inner, self.dt_rank, self.d_state
        x, z = xz[..., :d].transpose(1, 2), xz[..., d:]
        conv = getattr(self, f"conv1d{s}")
        w = conv.weight.shape[-1]
        u = F.silu(F.conv1d(F.pad(self.quant(x), (w - 1, 0)), self.quant(conv.weight),
                            conv.bias, groups=d))
        u_t = u.transpose(1, 2)  # (B, L, D)
        x_dbl = self._lin(u_t, getattr(self, f"x_proj{s}"))
        dt = F.softplus(self._lin(x_dbl[..., :r], getattr(self, f"dt_proj{s}")))
        A = -torch.exp(getattr(self, f"A{s}_log"))
        y = selective_scan(u, dt.transpose(1, 2), A, x_dbl[..., r:r + n].transpose(1, 2),
                           x_dbl[..., r + n:].transpose(1, 2)).transpose(1, 2)
        return (y + u_t * getattr(self, f"D{s}")) * F.silu(z)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        bsz, length, dm = h.shape
        xz = self._lin(h, self.in_proj)
        big = bsz * length * self.d_inner * 4 > DIRECTION_REMAT_BYTES
        run = (lambda *a: remat(self._direction, *a)) if big else self._direction
        y = run(xz, "")
        if self.bimamba_type == "v3":
            ns = self.nslices
            if length % ns:
                raise ValueError(f"slice scan needs tokens % nslices == 0: {length} % {ns}")
            y = y + run(xz.flip(1), "_b").flip(1)
            # slice order: token s * (L / ns) + l goes to position l * ns + s
            il = xz.reshape(bsz, ns, length // ns, -1).transpose(1, 2).reshape(bsz, length, -1)
            ys = run(il, "_s")
            y = y + ys.reshape(bsz, length // ns, ns, -1).transpose(1, 2).reshape(bsz, length, -1)
        return self._lin(y, self.out_proj)


# the deformable row-sample convolution --------------------------------------

def two_row_flatten(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H W, C): rows taken in pairs, the pair's two
    pixels of each column consecutive; an odd last row appended."""
    b, h, w, c = x.shape
    even = h // 2 * 2
    main = x[:, :even].reshape(b, even // 2, 2, w, c).transpose(2, 3).reshape(b, even * w, c)
    if h % 2:
        main = torch.cat([main, x[:, even:].reshape(b, w, c)], dim=1)
    return main


def two_row_unflatten(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b, _, c = t.shape
    even = h // 2 * 2
    main = t[:, :even * w].reshape(b, even // 2, w, 2, c).transpose(2, 3).reshape(b, even, w, c)
    if h % 2:
        main = torch.cat([main, t[:, even * w:].reshape(b, 1, w, c)], dim=1)
    return main


def offsets_from_centre(off: torch.Tensor) -> torch.Tensor:
    """(..., K) -> (..., K): 0 at the centre tap, and at tap c + i (c - i)
    the sum of the i offsets from the centre outwards, the centre's own
    excluded."""
    k = off.shape[-1]
    c = k // 2
    up = torch.cumsum(off[..., c + 1:], dim=-1)
    down = torch.cumsum(off[..., :c].flip(-1), dim=-1).flip(-1)
    return torch.cat([down, torch.zeros_like(off[..., :1]), up], dim=-1)


def row_sample_conv(feat: torch.Tensor, y: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, quant: Quant = identity) -> torch.Tensor:
    """feat (B, H, W, C), row coordinates y (B, H, W, K), weight (F, C, K, 1):
    tap j reads column clamp(w + j - K//2) at row clip(y, 0, H - 1),
    linearly between rows lo = clip(floor, 0, H - 2) and lo + 1; out (B, F,
    H, W) = sum_j tap_j @ weight[:, :, j] + bias."""
    b, h, w, c = feat.shape
    k = y.shape[-1]
    yc = y.clamp(0, h - 1)
    lo = torch.floor(yc).clamp(0, max(h - 2, 0))
    frac = yc - lo
    lo = lo.long()
    hi = (lo + 1).clamp(max=h - 1)
    bi = torch.arange(b, device=feat.device)[:, None, None]
    out = None
    for j in range(k):
        cols = (torch.arange(w, device=feat.device) + j - k // 2).clamp(0, w - 1)[None, None]
        fr = frac[..., j:j + 1]
        tap = feat[bi, lo[..., j], cols] * (1.0 - fr) + feat[bi, hi[..., j], cols] * fr
        prj = quant(tap) @ quant(weight[:, :, j, 0]).T
        out = prj if out is None else out + prj
    return (out + bias).permute(0, 3, 1, 2)
