"""Jamba's hand-written kernel launches of one forward, worked out from the
architecture, not read from the program's modules.

Every Mamba layer (layer i with i % attn_layer_period != attn_layer_offset)
launches one selective scan (kernel 5; kernel 6 in its backward) over its
mamba_expand * hidden_size channels and the sequence's tokens: one group
of B/C, which vary along the tokens and are f32 as the stream, and three
streams (u, dt and the gate z). Its dt/B/C norms keep it off the fused
Mamba scan (kernels 1/2). Attention runs PyTorch's fused kernels, no
hand-written family."""

from __future__ import annotations


def kernel_shapes(cfg: dict, batch: int, size: int) -> dict:
    """As `configs/mm_net.py::kernel_shapes`."""
    m = cfg["model_kwargs"]
    mamba = sum(i % m["attn_layer_period"] != m["attn_layer_offset"]
                for i in range(m["num_hidden_layers"]))
    shape = (batch, m["mamba_expand"] * m["hidden_size"], size, m["mamba_d_state"], 1, 4, 3,
             False)
    return {"selective_scan": [(shape, mamba)]}
