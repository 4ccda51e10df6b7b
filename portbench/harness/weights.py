"""Weights made from the seed on the card, for a state dict's names and
shapes (the plain reference's, which the program's share): two draws, one
normal and one uniform, each a single call, sliced and scaled by kind.

- convolution and projection weights: N(0, 1 / fan_in), fan_in the
  product of all but the first axis;
- a Mamba's A_log: log(1..N) on every channel, D: 1; dt_proj's weight
  U(-r^-1/2, r^-1/2) and bias softplus^-1(dt), dt log-uniform in [1e-3,
  1e-1] (Mamba's initialisation);
- MMConv's altho: softplus^-1(1);
- norm weights 1, every other bias 0, running mean 0 and variance 1.
"""

from __future__ import annotations

import math

import torch

from harness.spec import sub_seed


def _kind(name: str, shape: tuple) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("running_mean", "num_batches_tracked"):
        return "zero"
    if leaf == "running_var":
        return "one"
    if leaf.startswith("A") and leaf.endswith("_log"):
        return "a_log"
    if leaf in ("D", "D_b", "D_s"):
        return "one"
    if leaf == "altho":
        return "altho"
    if ".dt_proj" in name:
        return "dt_bias" if leaf == "bias" else "dt_weight"
    if leaf == "bias":
        return "zero"
    if len(shape) <= 1:
        return "one"
    return "normal"


def seeded_state(spec: dict, seed: int, device) -> dict:
    """{name: tensor} for `spec` ({name: tensor of the wanted shape and
    dtype}, e.g. a state dict on the meta device) from `seed`."""
    names = sorted(spec)
    kinds = {n: _kind(n, tuple(spec[n].shape)) for n in names}
    n_norm = sum(spec[n].numel() for n in names if kinds[n] == "normal")
    n_unif = sum(spec[n].numel() for n in names if kinds[n] in ("dt_weight", "dt_bias"))
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    normal = torch.randn(n_norm, generator=g, device=device)
    unif = torch.rand(n_unif, generator=g, device=device)
    out, i_n, i_u = {}, 0, 0
    for n in names:
        t, kind = spec[n], kinds[n]
        shape, k = tuple(t.shape), t.numel()
        if kind == "normal":
            fan_in = math.prod(shape[1:])
            v = normal[i_n:i_n + k].reshape(shape) / math.sqrt(fan_in)
            i_n += k
        elif kind == "dt_weight":
            r = shape[1]
            v = (unif[i_u:i_u + k].reshape(shape) * 2 - 1) * r ** -0.5
            i_u += k
        elif kind == "dt_bias":
            dt = torch.exp(unif[i_u:i_u + k] * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
            v = (dt + torch.log(-torch.expm1(-dt))).reshape(shape)
            i_u += k
        elif kind == "a_log":
            v = torch.log(torch.arange(1, shape[1] + 1, dtype=torch.float32,
                                       device=device)).repeat(shape[0], 1)
        elif kind == "altho":
            v = torch.full(shape, math.log(math.e - 1.0), device=device)
        elif kind == "one":
            v = torch.ones(shape, device=device)
        else:
            v = torch.zeros(shape, device=device)
        out[n] = v.to(t.dtype)
    return out
