"""The Mamba language model (counterpart of `mm_unet_tpu/models/lm.py`, the
reference's `mixer_seq_simple.py` and `utils/generation.py`).

- `MixerModel`: the embedding, `n_layer` prenorm `Block`s (each a
  one-direction `Mamba`, which takes the megakernel route, kernel 1, at
  d_state 16) and the final norm `norm_f`; `MambaLMHeadModel` adds the
  head tied to the embedding, `h @ embedding.weight.T`; `give_lm` builds
  one from a reference config.json (mamba-130m's by default; `MAMBA_370M`
  is mamba-370m's).
- `mamba_step`: one token through one Block's mixer, with the rolling conv
  and SSM caches (`ops/causal_conv1d.py::causal_conv1d_update`,
  `ops/state_update.py::selective_state_update`).
- `generate`: the eager decode loop; `generate_scan`: the same loop over one
  whole-model token step (embedding, every Block, norm_f, logits) on static
  buffers, captured once in a CUDA graph on the card (the counterpart of
  the JAX package's compiled `lax.scan`) and run eagerly on the CPU. Both
  step through the prompt token by token to warm the caches, as the JAX
  decoders do, and pick each token with `next_token`: the teacher's token
  at that absolute position while there is one, else a sample (top-k,
  then top-p) or the argmax. A sample draws once from the caller's
  generator, so the two decoders draw in the same order and agree token
  for token. `generate` stops once every sequence has emitted eos;
  `generate_scan` always runs `max_new_tokens` steps and pads with eos
  after the stop.

Where the JAX package is at fault, the port keeps to the reference
(ROADMAP.md, queue 3): `norm_f` normalises at eps 1e-5 (flax's default
1e-6 in the JAX `MixerModel`); `mamba_step` reads the unshifted dt_proj
weight, so the step computes what the forward computes; the decoders use
each Block's own norm (the JAX ones read `LayerNorm_0` and raise for
`rms_norm=True`); and teacher-forced steps draw nothing in either decoder
(the JAX `generate_scan` splits its key on them).

The stream is f32, as the JAX LM has no dtype field.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mm_unet_tpu_torch.models.mamba import Block, Mamba, kernel_launches
from mm_unet_tpu_torch.ops.causal_conv1d import causal_conv1d_update
from mm_unet_tpu_torch.ops.state_update import selective_state_update

# state-spaces/mamba-130m's and mamba-370m's published config.json (370m:
# d_inner 2048, dt_rank 64, x_dbl rows 96, d_state 16)
MAMBA_130M = {"d_model": 768, "n_layer": 24, "vocab_size": 50277, "ssm_cfg": {},
              "rms_norm": True, "residual_in_fp32": True, "fused_add_norm": True,
              "pad_vocab_size_multiple": 8}
MAMBA_370M = {"d_model": 1024, "n_layer": 48, "vocab_size": 50277, "ssm_cfg": {},
              "rms_norm": True, "residual_in_fp32": True, "fused_add_norm": True,
              "pad_vocab_size_multiple": 8}
NORM_EPS = 1e-5  # the reference's norm_epsilon, for every Block and norm_f


class MixerModel(nn.Module):
    """Embedding + n_layer prenorm Mamba Blocks + the final norm
    (`mixer_seq_simple.py:83-170`). Weights drawn from `generator` with the
    JAX initialisers' distributions (the embedding N(0, 1/d_model))."""

    def __init__(self, d_model: int, n_layer: int, vocab_size: int, d_state: int = 16,
                 rms_norm: bool = False, fused_add_norm: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.embedding = nn.Embedding(vocab_size, d_model)
        with torch.no_grad():
            self.embedding.weight.normal_(0.0, d_model ** -0.5, generator=g)
        self.layers = nn.ModuleList(
            Block(d_model, NORM_EPS, rms_norm=rms_norm, fused_add_norm=fused_add_norm,
                  mamba_kwargs={"d_state": d_state, "bimamba_type": "none"}, generator=g)
            for _ in range(n_layer))
        self.norm_f = (nn.RMSNorm(d_model, NORM_EPS) if rms_norm
                       else nn.LayerNorm(d_model, NORM_EPS))

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        h, residual = self.embedding(input_ids), None
        for layer in self.layers:
            h, residual = layer(h, residual)
        return self.norm_f(h + residual if residual is not None else h)


class MambaLMHeadModel(nn.Module):
    """MixerModel with the LM head tied to its embedding
    (`mixer_seq_simple.py:173-233`): input_ids (B, L) -> logits (B, L, V)."""

    def __init__(self, d_model: int, n_layer: int, vocab_size: int, d_state: int = 16,
                 rms_norm: bool = False, fused_add_norm: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d_model, self.n_layer, self.vocab_size, self.d_state = (
            d_model, n_layer, vocab_size, d_state)
        self.rms_norm, self.fused_add_norm = rms_norm, fused_add_norm
        self.backbone = MixerModel(d_model, n_layer, vocab_size, d_state, rms_norm,
                                   fused_add_norm, generator)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return F.linear(self.backbone(input_ids), self.backbone.embedding.weight)

    def kernel_launches_per_forward(self) -> dict[str, int]:
        """One fused scan (kernel 1) per Block on the megakernel route."""
        return kernel_launches(self)


def give_lm(config: Mapping = MAMBA_130M, device: torch.device | str = "cuda",
            generator: Optional[torch.Generator] = None) -> MambaLMHeadModel:
    """The model of a reference config.json (mamba-130m's, `MAMBA_130M`,
    unless the caller gives another), its vocabulary padded up to
    `pad_vocab_size_multiple`, weights drawn from `generator`, on `device` in
    eval mode: the card unless the caller asks for the CPU. d_state comes
    from `ssm_cfg` (16 by default). `residual_in_fp32` changes nothing on
    the f32 stream and is not a field of the JAX model, so it is not read."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("give_lm: no CUDA device here; the port runs on the card unless "
                           "the caller asks for the CPU with device='cpu'")
    multiple = config.get("pad_vocab_size_multiple", 1)
    vocab = -(-config["vocab_size"] // multiple) * multiple
    return MambaLMHeadModel(config["d_model"], config["n_layer"], vocab,
                            (config.get("ssm_cfg") or {}).get("d_state", 16),
                            config.get("rms_norm", False), config.get("fused_add_norm", False),
                            generator).to(device).eval()


def mamba_step(mixer: Mamba, x: torch.Tensor, conv_state: torch.Tensor,
               ssm_state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token through a one-direction Mamba (the reference's
    `mamba_simple.py:364-409` step): x (B, d_model), conv_state (B, D, W),
    ssm_state (B, D, N) f32. The module's own dt_proj weight, dt_rank, conv
    width and d_inner. Returns (y (B, d_model), new conv state, new SSM
    state)."""
    if mixer.bimamba_type != "none":
        raise ValueError(f"mamba_step: one direction only, not {mixer.bimamba_type!r}")
    d_in, r, n = mixer.d_inner, mixer.dt_rank, mixer.d_state
    xz = F.linear(x, mixer.in_proj.weight, mixer.in_proj.bias)
    xi, conv_state = causal_conv1d_update(xz[:, :d_in], conv_state, mixer.conv1d.weight[:, 0],
                                          mixer.conv1d.bias, activation="silu")
    x_dbl = F.linear(xi, mixer.x_proj.weight)
    dt = F.linear(x_dbl[:, :r], mixer.dt_proj.weight)
    y, ssm_state = selective_state_update(
        ssm_state, xi, dt, -torch.exp(mixer.A_log.float()), x_dbl[:, r:r + n],
        x_dbl[:, r + n:], D=mixer.D, z=xz[:, d_in:], dt_bias=mixer.dt_proj.bias,
        dt_softplus=True)
    return F.linear(y, mixer.out_proj.weight, mixer.out_proj.bias), conv_state, ssm_state


def token_step(model: MambaLMHeadModel, token: torch.Tensor, conv: torch.Tensor,
               ssm: torch.Tensor) -> torch.Tensor:
    """One token through the whole model: token (B,) -> logits (B, V). The
    caches conv (n_layer, B, D, W) and ssm (n_layer, B, D, N) are updated in
    place; each Block adds and normalises with its own norm."""
    bb = model.backbone
    h, residual = bb.embedding(token), None
    for i, block in enumerate(bb.layers):
        hn, residual = block.add_norm(h, residual)
        h, c, s = mamba_step(block.mixer, hn, conv[i], ssm[i])
        conv[i].copy_(c)
        ssm[i].copy_(s)
    return F.linear(bb.norm_f(h + residual), bb.embedding.weight)


def _caches(model: MambaLMHeadModel, batch: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Zeroed conv (n_layer, B, D, W) and SSM (n_layer, B, D, N) caches."""
    mixer = model.backbone.layers[0].mixer
    shape = (len(model.backbone.layers), batch, mixer.d_inner)
    return (torch.zeros(*shape, mixer.conv1d.weight.shape[-1], device=device),
            torch.zeros(*shape, mixer.d_state, device=device))


def _top_k_filter(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Keep the top_k largest logits of each row (and any tied with the
    k-th), -inf elsewhere."""
    kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def _top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filtering (reference `modify_logits_for_top_p_filtering`):
    drop the ascending tail whose cumulative softmax probability is
    <= 1 - top_p."""
    srt = torch.sort(logits, dim=-1).values  # ascending
    keep = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1) > 1.0 - top_p
    thresh = torch.where(keep, srt, float("inf")).min(-1, keepdim=True).values
    return logits.masked_fill(logits < thresh, float("-inf"))


def next_token(logits: torch.Tensor, pos: int, teacher_outputs: Optional[torch.Tensor],
               temperature: float, top_k: Optional[int], top_p: Optional[float],
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """The token at absolute position `pos`, for both decoders: the
    teacher's while `pos` is in its range; else, with top_k or top_p < 1, a
    sample of softmax(logits / temperature) after the top-k then the top-p
    filter, by the Gumbel maximum over one draw from `generator` (on the
    logits' device); else the argmax. Teacher-forced and greedy steps draw
    nothing."""
    if teacher_outputs is not None and pos < teacher_outputs.shape[1]:
        return teacher_outputs[:, pos].to(logits.device)
    if top_k is None and (top_p is None or top_p >= 1.0):
        return logits.argmax(-1)
    lg = logits / max(temperature, 1e-6)
    if top_k is not None:
        lg = _top_k_filter(lg, top_k)
    if top_p is not None and top_p < 1.0:
        lg = _top_p_filter(lg, top_p)
    u = torch.rand(lg.shape, generator=generator, device=lg.device)
    return (lg - torch.log(-torch.log(u))).argmax(-1)


class TokenStep:
    """`token_step` on static buffers: the token (B,), the caches and the
    logits (B, V). On the card the step is captured once in a CUDA graph
    (after one warm-up run on a side stream) and each call is one replay; on
    the CPU each call runs it eagerly. A call returns the logits buffer,
    which the next call overwrites."""

    def __init__(self, model: MambaLMHeadModel, batch: int):
        dev = model.backbone.embedding.weight.device
        self.model, self.graph = model, None
        self.token = torch.zeros(batch, dtype=torch.long, device=dev)
        self.conv, self.ssm = _caches(model, batch, dev)
        if dev.type == "cuda":
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                token_step(model, self.token, self.conv, self.ssm)
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.logits = token_step(model, self.token, self.conv, self.ssm)
            self.conv.zero_()  # the warm-up ran a token through the caches
            self.ssm.zero_()

    def __call__(self, token: torch.Tensor) -> torch.Tensor:
        self.token.copy_(token)
        if self.graph is None:
            return token_step(self.model, self.token, self.conv, self.ssm)
        self.graph.replay()
        return self.logits


@torch.no_grad()
def generate(model: MambaLMHeadModel, input_ids: torch.Tensor, max_new_tokens: int,
             temperature: float = 1.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None, generator: Optional[torch.Generator] = None,
             teacher_outputs: Optional[torch.Tensor] = None,
             eos_token_id: Optional[int] = None, return_logits: bool = False):
    """Decode `max_new_tokens` after the prompt input_ids (B, P >= 1),
    eagerly, one `token_step` per token (`utils/generation.py:207`'s
    loop). `teacher_outputs` (B, >= P + steps) forces the token at each
    absolute position in its range; `eos_token_id` stops once every
    sequence's token is eos (that column included). Returns the tokens
    (B, P + emitted) and, with `return_logits`, the logits after every
    consumed token (B, consumed, V): position p's predict token p + 1."""
    if input_ids.shape[1] < 1:
        raise ValueError("generate: the prompt needs at least one token")
    b, prompt_len = input_ids.shape
    conv, ssm = _caches(model, b, input_ids.device)
    seen = []  # the logits after each consumed token, when asked for
    for t in range(prompt_len):
        logits = token_step(model, input_ids[:, t], conv, ssm)
        seen += [logits] if return_logits else []
    out = [input_ids]
    for step in range(max_new_tokens):
        cur = next_token(logits, prompt_len + step, teacher_outputs, temperature, top_k, top_p,
                         generator)
        out.append(cur[:, None])
        if eos_token_id is not None and bool((cur == eos_token_id).all()):
            break  # the reference's should_stop: every sequence hit eos
        logits = token_step(model, cur, conv, ssm)
        seen += [logits] if return_logits else []
    tokens = torch.cat(out, dim=1)
    return (tokens, torch.stack(seen, dim=1)) if return_logits else tokens


@torch.no_grad()
def generate_scan(model: MambaLMHeadModel, input_ids: torch.Tensor, max_new_tokens: int,
                  temperature: float = 1.0, top_k: Optional[int] = None,
                  top_p: Optional[float] = None, generator: Optional[torch.Generator] = None,
                  teacher_outputs: Optional[torch.Tensor] = None,
                  eos_token_id: Optional[int] = None, return_logits: bool = False):
    """`generate` through a `TokenStep` (one CUDA-graph replay per token on
    the card), with a fixed shape: it always runs `max_new_tokens` steps,
    and after every sequence has emitted eos the remaining columns are eos.
    Token for token equal to `generate` up to its stop. With
    `return_logits`, the logits after every consumed token (B, P +
    max_new_tokens, V)."""
    if input_ids.shape[1] < 1:
        raise ValueError("generate_scan: the prompt needs at least one token")
    b, prompt_len = input_ids.shape
    step_fn = TokenStep(model, b)
    seen = []  # the logits after each consumed token, when asked for
    for t in range(prompt_len):
        logits = step_fn(input_ids[:, t])
        seen += [logits.clone()] if return_logits else []
    new = torch.empty(b, max_new_tokens, dtype=input_ids.dtype, device=input_ids.device)
    stopped = torch.zeros((), dtype=torch.bool, device=input_ids.device)
    for step in range(max_new_tokens):
        cur = next_token(logits, prompt_len + step, teacher_outputs, temperature, top_k, top_p,
                         generator)
        if eos_token_id is not None:
            cur = cur.masked_fill(stopped, eos_token_id)
            stopped = stopped | (cur == eos_token_id).all()
        new[:, step] = cur
        logits = step_fn(cur)
        seen += [logits.clone()] if return_logits else []
    tokens = torch.cat([input_ids, new], dim=1)
    return (tokens, torch.stack(seen, dim=1)) if return_logits else tokens
