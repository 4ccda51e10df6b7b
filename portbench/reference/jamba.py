"""Plain PyTorch reference of Jamba as a causal language model, written from
the layer equations of Hugging Face's `modeling_jamba.py`; imports nothing
of the program under test. Every block computes in f32.

- token embedding; `num_hidden_layers` pre-norm layers, layer i attention
  when i % attn_layer_period == attn_layer_offset and Mamba otherwise, each
  h + mixer(norm(h)) then h + mlp(norm(h)); a final norm; the head tied to
  the embedding. Every norm an RMSNorm at `rms_norm_eps`.
- Mamba: in_proj to (x, z); a causal depthwise conv (with its bias) and
  SiLU, written as a sum of shifted products (torch's FLOP counter prices
  a grouped convolution's weight gradient as a dense one's, 5,120 times
  the work at Jamba2-3B's width); x_proj to (dt, B, C), each through its RMSNorm (dt_layernorm,
  b_layernorm, c_layernorm); dt_proj and softplus; the selective scan
  (`plain.selective_scan`) with the skip D u, gated by silu(z); out_proj.
- attention: q/k/v/o without bias, query head h over K/V head
  h // (heads / kv_heads), softmax(q k^T / sqrt(d) + causal mask) v
  written out, in blocks of `QUERY_BLOCK` queries against the keys up to
  the block's last, each block recomputed in the backward pass.
- MLP: down(silu(gate(x)) * up(x)).

Each layer is recomputed in the backward pass (`plain.remat`), so that the
reference's two training steps at 8,192 tokens fit on the card beside its
AdamW state. Parameters are made empty (the benchmark loads its seeded
weights into them) under the port's names. `quant` rounds the inputs of
every product, as `plain.py` says.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from reference.plain import Quant, identity, remat, selective_scan

QUERY_BLOCK = 1024  # queries of one block of the written-out attention


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape))


class Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int, bias: bool = False, quant: Quant = identity):
        super().__init__()
        self.quant = quant
        self.weight = _param(d_out, d_in)
        self.bias = _param(d_out) if bias else None

    def forward(self, x):
        return F.linear(self.quant(x), self.quant(self.weight), self.bias)


class RMSNorm(nn.Module):
    """weight * x / sqrt(mean(x^2) + eps) over the last axis."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps, self.weight = eps, _param(dim)

    def forward(self, x):
        return self.weight * x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps)


class Mamba(nn.Module):
    def __init__(self, cfg: dict, quant: Quant):
        super().__init__()
        dm, n, eps = cfg["hidden_size"], cfg["mamba_d_state"], cfg["rms_norm_eps"]
        self.d_inner = d = cfg["mamba_expand"] * dm
        self.dt_rank = r = cfg["mamba_dt_rank"]
        self.d_state, self.quant, proj_bias = n, quant, cfg["mamba_proj_bias"]
        self.in_proj = Linear(dm, 2 * d, proj_bias, quant)
        self.conv1d = nn.Module()
        self.conv1d.weight = _param(d, 1, cfg["mamba_d_conv"])
        self.conv1d.bias = _param(d) if cfg["mamba_conv_bias"] else None
        self.x_proj = Linear(d, r + 2 * n, False, quant)
        self.dt_proj = Linear(r, d, True, quant)
        self.dt_layernorm, self.b_layernorm, self.c_layernorm = (RMSNorm(k, eps)
                                                                for k in (r, n, n))
        self.A_log, self.D = _param(d, n), _param(d)
        self.out_proj = Linear(d, dm, proj_bias, quant)

    def forward(self, h):
        d, r, n = self.d_inner, self.dt_rank, self.d_state
        xz = self.in_proj(h)
        x, z = xz[..., :d].transpose(1, 2), xz[..., d:]
        w, length = self.quant(self.conv1d.weight[:, 0]), x.shape[-1]  # (D, W)
        xp = F.pad(self.quant(x), (w.shape[-1] - 1, 0))
        u = sum(w[:, k, None] * xp[..., k:k + length] for k in range(w.shape[-1]))
        u = F.silu(u + self.conv1d.bias[:, None] if self.conv1d.bias is not None else u)
        u_t = u.transpose(1, 2)  # (B, L, D)
        x_dbl = self.x_proj(u_t)
        dt = self.dt_layernorm(x_dbl[..., :r])
        bm, cm = self.b_layernorm(x_dbl[..., r:r + n]), self.c_layernorm(x_dbl[..., r + n:])
        dt = F.softplus(self.dt_proj(dt))
        y = selective_scan(u, dt.transpose(1, 2), -torch.exp(self.A_log), bm.transpose(1, 2),
                           cm.transpose(1, 2)).transpose(1, 2)
        return self.out_proj((y + u_t * self.D) * F.silu(z))


def _attend(q, k, v, start: int, quant: Quant):
    """Queries start.. (B, KV, G, T, d) against keys 0..start+T-1 (B, KV, 1,
    S, d): the causal softmax of the scaled scores, times v."""
    t, s = q.shape[-2], k.shape[-2]
    scores = quant(q) @ quant(k).transpose(-1, -2) * q.shape[-1] ** -0.5
    pos_q = torch.arange(start, start + t, device=q.device)[:, None]
    masked = torch.arange(s, device=q.device)[None, :] > pos_q
    p = torch.softmax(scores.masked_fill(masked, float("-inf")), dim=-1)
    return quant(p) @ quant(v)


class Attention(nn.Module):
    def __init__(self, cfg: dict, quant: Quant):
        super().__init__()
        dm = cfg["hidden_size"]
        self.heads, self.kv_heads = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        self.head_dim = hd = dm // self.heads
        self.quant = quant
        self.q_proj = Linear(dm, self.heads * hd, False, quant)
        self.k_proj = Linear(dm, self.kv_heads * hd, False, quant)
        self.v_proj = Linear(dm, self.kv_heads * hd, False, quant)
        self.o_proj = Linear(self.heads * hd, dm, False, quant)

    def forward(self, h):
        b, length, _ = h.shape
        kv, hd = self.kv_heads, self.head_dim
        g = self.heads // kv
        # (B, KV, G, L, d): query head kv_index * G + j reads K/V head kv_index
        q = self.q_proj(h).view(b, length, kv, g, hd).permute(0, 2, 3, 1, 4)
        k = self.k_proj(h).view(b, length, kv, 1, hd).permute(0, 2, 3, 1, 4)
        v = self.v_proj(h).view(b, length, kv, 1, hd).permute(0, 2, 3, 1, 4)
        blocks = []
        for s in range(0, length, QUERY_BLOCK):
            e = min(s + QUERY_BLOCK, length)
            blocks.append(remat(_attend, q[..., s:e, :], k[..., :e, :], v[..., :e, :], s,
                                self.quant))
        y = torch.cat(blocks, dim=-2)  # (B, KV, G, L, d)
        return self.o_proj(y.permute(0, 3, 1, 2, 4).reshape(b, length, -1))


class MLP(nn.Module):
    def __init__(self, cfg: dict, quant: Quant):
        super().__init__()
        dm, di = cfg["hidden_size"], cfg["intermediate_size"]
        self.gate_proj, self.up_proj = Linear(dm, di, False, quant), Linear(dm, di, False, quant)
        self.down_proj = Linear(di, dm, False, quant)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Layer(nn.Module):
    def __init__(self, cfg: dict, attention: bool, quant: Quant):
        super().__init__()
        dm, eps = cfg["hidden_size"], cfg["rms_norm_eps"]
        self.mixer_name = "self_attn" if attention else "mamba"
        self.input_layernorm = RMSNorm(dm, eps)
        self.add_module(self.mixer_name, (Attention if attention else Mamba)(cfg, quant))
        self.pre_ff_layernorm = RMSNorm(dm, eps)
        self.feed_forward = MLP(cfg, quant)

    def _forward(self, h):
        h = h + getattr(self, self.mixer_name)(self.input_layernorm(h))
        return h + self.feed_forward(self.pre_ff_layernorm(h))

    def forward(self, h):
        return remat(self._forward, h)


class Jamba(nn.Module):
    def __init__(self, cfg: dict, quant: Quant = identity):
        super().__init__()
        dm, self.quant = cfg["hidden_size"], quant
        self.embed_tokens = nn.Module()
        self.embed_tokens.weight = _param(cfg["vocab_size"], dm)
        period, offset = cfg["attn_layer_period"], cfg["attn_layer_offset"]
        self.layers = nn.ModuleList(Layer(cfg, i % period == offset, quant)
                                    for i in range(cfg["num_hidden_layers"]))
        self.final_layernorm = RMSNorm(dm, cfg["rms_norm_eps"])

    def forward(self, ids):
        h = F.embedding(ids, self.embed_tokens.weight)
        for layer in self.layers:
            h = layer(h)
        return self.quant(self.final_layernorm(h)) @ self.quant(self.embed_tokens.weight).T


def build(cfg: dict, quant: Quant = identity) -> nn.Module:
    """The reference at the configuration's widths (`model_kwargs`, the
    port's keyword arguments), its parameters empty."""
    return Jamba(cfg["model_kwargs"], quant)


def example_input(cfg: dict, batch: int, size: int) -> torch.Tensor:
    """(batch, size) token ids: the input of the FLOP count."""
    return torch.zeros(batch, size, dtype=torch.long)


def model_input(batch: dict) -> torch.Tensor:
    return batch["tokens"]


def loss(out: torch.Tensor, batch: dict) -> torch.Tensor:
    """Cross-entropy of the logits at positions 0..L-2 against the tokens at
    1..L-1, the mean over every predicted token."""
    tokens = batch["tokens"]
    return F.cross_entropy(out[:, :-1].reshape(-1, out.shape[-1]), tokens[:, 1:].reshape(-1))
