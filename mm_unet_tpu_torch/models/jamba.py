"""Jamba, AI21's hybrid of Mamba-1 and attention, as a causal language model
(the layer equations of Hugging Face's `modeling_jamba.py`; the widths of a
`config.json`, by default AI21-Jamba2-3B's,
https://huggingface.co/ai21labs/AI21-Jamba2-3B/blob/main/config.json).

- `JambaForCausalLM`: the token embedding, `num_hidden_layers` pre-norm
  decoder layers, `final_layernorm` and the head tied to the embedding,
  ids (B, L) -> logits (B, L, V). Layer i is an attention layer when
  i % attn_layer_period == attn_layer_offset, a Mamba layer otherwise;
  every layer has a SwiGLU MLP (`num_experts` 1).
- `JambaDecoderLayer`: h + mixer(input_layernorm(h)), then
  h + feed_forward(pre_ff_layernorm(h)); the mixer is `mamba` or `self_attn`.
- The Mamba mixer is `models/mamba.py::Mamba` with one direction and Jamba's
  RMSNorms on dt, B and C (`ssm_norm_eps`), so it takes the grouped-scan
  route: one `selective_scan` launch (kernels 5-6 on the card) a layer.
- `JambaAttention`: q/k/v/o without bias, `num_attention_heads` query heads
  over `num_key_value_heads` shared K/V heads, causal, no position
  encoding, scale 1/sqrt(head_dim), through `causal_attention`.
- `JambaMLP`: down(silu(gate(x)) * up(x)).

Every norm is an RMSNorm at `rms_norm_eps`. Parameter names are Hugging
Face's without the `model.` prefix (`embed_tokens`, `layers.{i}.mamba.*`,
`layers.{i}.self_attn.*`, `layers.{i}.feed_forward.*`, `final_layernorm`);
the tied head has no tensor of its own. Weights are drawn from the
generator: projections lecun-normal, the embedding N(0, 1/hidden_size), the
mixers as `Mamba` draws them, norms 1.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from mm_unet_tpu_torch.models.layers import lecun_normal_
from mm_unet_tpu_torch.models.mamba import Mamba, kernel_launches

# the fused attention kernels; never the math path, which would hold every
# head's (L, L) scores (20 x 8,192^2 f32 at Jamba2-3B's widths)
FUSED_ATTENTION = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + causal mask) v for q (B, H, L, d) and k, v
    (B, KV, L, d), query head h reading K/V head h // (H / KV). On the card
    through a fused kernel of `F.scaled_dot_product_attention` (f32 takes
    the memory-efficient one), with K and V repeated to H heads in
    contiguous copies: grouped or stride-0 K/V send f32 to the math path.
    `causal_attention.launches` counts calls."""
    causal_attention.launches += 1
    heads, kv = q.shape[1], k.shape[1]
    if kv != heads:
        k, v = (t.repeat_interleave(heads // kv, dim=1) for t in (k, v))
    ctx = sdpa_kernel(FUSED_ATTENTION) if q.is_cuda else contextlib.nullcontext()
    with ctx:
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              scale=q.shape[-1] ** -0.5)


causal_attention.launches = 0


def _linear(d_in: int, d_out: int, g: torch.Generator) -> nn.Linear:
    lin = nn.Linear(d_in, d_out, bias=False)
    lecun_normal_(lin.weight, d_in, g)
    return lin


class JambaAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, num_kv_heads: int,
                 generator: torch.Generator):
        super().__init__()
        if hidden_size % num_heads or num_heads % num_kv_heads:
            raise ValueError(f"{num_heads} heads over {num_kv_heads} K/V heads at width "
                             f"{hidden_size}")
        self.num_heads, self.num_kv_heads = num_heads, num_kv_heads
        self.head_dim = d = hidden_size // num_heads
        self.q_proj = _linear(hidden_size, num_heads * d, generator)
        self.k_proj = _linear(hidden_size, num_kv_heads * d, generator)
        self.v_proj = _linear(hidden_size, num_kv_heads * d, generator)
        self.o_proj = _linear(num_heads * d, hidden_size, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, length, _ = x.shape

        def heads(t, n):
            return t.view(b, length, n, self.head_dim).transpose(1, 2)

        y = causal_attention(heads(self.q_proj(x), self.num_heads),
                             heads(self.k_proj(x), self.num_kv_heads),
                             heads(self.v_proj(x), self.num_kv_heads))
        return self.o_proj(y.transpose(1, 2).reshape(b, length, -1))


class JambaMLP(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int, generator: torch.Generator):
        super().__init__()
        self.gate_proj = _linear(hidden_size, intermediate_size, generator)
        self.up_proj = _linear(hidden_size, intermediate_size, generator)
        self.down_proj = _linear(intermediate_size, hidden_size, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class JambaDecoderLayer(nn.Module):
    """Pre-norm residual layer around a mixer named `mixer_name` ("mamba"
    or "self_attn") and the MLP `feed_forward`."""

    def __init__(self, mixer_name: str, mixer: nn.Module, hidden_size: int,
                 intermediate_size: int, eps: float, generator: torch.Generator):
        super().__init__()
        self.mixer_name = mixer_name
        self.input_layernorm = nn.RMSNorm(hidden_size, eps)
        self.add_module(mixer_name, mixer)
        self.pre_ff_layernorm = nn.RMSNorm(hidden_size, eps)
        self.feed_forward = JambaMLP(hidden_size, intermediate_size, generator)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = h + getattr(self, self.mixer_name)(self.input_layernorm(h))
        return h + self.feed_forward(self.pre_ff_layernorm(h))


class JambaForCausalLM(nn.Module):
    """Jamba at the widths of a `config.json`, whose keys are the keyword
    arguments; the defaults are AI21-Jamba2-3B's published values. Keys that change nothing in
    training are taken as given (`max_position_embeddings`: there are no
    positions; `num_logits_to_keep`: generation's; `use_mamba_kernels`: the
    card always takes the port's kernels; `expert_layer_*` and
    `num_experts_per_tok`, with a single expert). Sparse experts
    (AI21-Jamba2-Mini), sliding windows, an untied head and activations
    other than SiLU raise NotImplementedError."""

    def __init__(self, vocab_size: int = 65536, hidden_size: int = 2560,
                 intermediate_size: int = 8192, num_hidden_layers: int = 28,
                 num_attention_heads: int = 20, num_key_value_heads: int = 1,
                 attn_layer_period: int = 14, attn_layer_offset: int = 7,
                 mamba_d_state: int = 16, mamba_d_conv: int = 4, mamba_expand: int = 2,
                 mamba_dt_rank: int = 160, mamba_conv_bias: bool = True,
                 mamba_proj_bias: bool = False, rms_norm_eps: float = 1e-6,
                 hidden_act: str = "silu", tie_word_embeddings: bool = True,
                 num_experts: int = 1, num_experts_per_tok: int = 1,
                 expert_layer_period: int = 2, expert_layer_offset: int = 1,
                 sliding_window: Optional[int] = None, max_position_embeddings: int = 262144,
                 num_logits_to_keep: int = 1, use_mamba_kernels: bool = True,
                 model_type: str = "jamba", generator: Optional[torch.Generator] = None):
        super().__init__()
        unsupported = {"model_type": model_type != "jamba", "num_experts": num_experts != 1,
                       "sliding_window": sliding_window is not None,
                       "hidden_act": hidden_act != "silu",
                       "tie_word_embeddings": not tie_word_embeddings}
        if any(unsupported.values()):
            raise NotImplementedError(
                f"Jamba: {[k for k, v in unsupported.items() if v]} not supported (one expert, "
                "global attention, SiLU, a tied head)")
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.embed_tokens = nn.Embedding(vocab_size, hidden_size)
        with torch.no_grad():
            self.embed_tokens.weight.normal_(0.0, hidden_size ** -0.5, generator=g)
        layers = []
        for i in range(num_hidden_layers):
            if i % attn_layer_period == attn_layer_offset:
                name, mixer = "self_attn", JambaAttention(hidden_size, num_attention_heads,
                                                          num_key_value_heads, g)
            else:
                name, mixer = "mamba", Mamba(
                    hidden_size, d_state=mamba_d_state, d_conv=mamba_d_conv,
                    expand=mamba_expand, dt_rank=mamba_dt_rank, conv_bias=mamba_conv_bias,
                    bias=mamba_proj_bias, bimamba_type="none", ssm_norm_eps=rms_norm_eps,
                    generator=g)
            layers.append(JambaDecoderLayer(name, mixer, hidden_size, intermediate_size,
                                            rms_norm_eps, g))
        self.layers = nn.ModuleList(layers)
        self.final_layernorm = nn.RMSNorm(hidden_size, rms_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        h = self.embed_tokens(input_ids)
        for layer in self.layers:
            h = layer(h)
        return F.linear(self.final_layernorm(h), self.embed_tokens.weight)

    def kernel_launches_per_forward(self) -> dict[str, int]:
        """One selective scan a Mamba layer, one `causal_attention` an
        attention layer."""
        return {**kernel_launches(self),
                "attention": sum(isinstance(m, JambaAttention) for m in self.modules())}
