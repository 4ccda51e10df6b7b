"""Helpers for the PyTorch port's parity tests (tests/test_torch_port_*.py):
JAX variables <-> torch modules through the reference's pair tables.

Inputs come from numpy seeds and pass between the packages as numpy arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from mm_unet_tpu.utils.torch_convert import dkdualnet_pairs, mm_net_pairs
from mm_unet_tpu_torch.utils.convert import jax_to_torch_state_dict

# every module of a depths=(1,1,1,1) MM_Net, by flax path and torch prefix
TINY_PAIRS = mm_net_pairs(depths=(1, 1, 1, 1))


def sub_pairs(fprefix: tuple, tprefix: str, pairs=TINY_PAIRS):
    """The entries of `pairs` under one submodule, re-rooted: flax paths
    lose `fprefix`, torch keys lose `tprefix` (which ends in '.')."""
    n = len(fprefix)
    out = [(fp[n:], tk[len(tprefix):], kind) for fp, tk, kind in pairs
           if tuple(fp[:n]) == tuple(fprefix)]
    assert out and all(tk.startswith(tprefix) for fp, tk, kind in pairs
                       if tuple(fp[:n]) == tuple(fprefix))
    return out


def dkdualnet_port_pairs(**kwargs):
    """`dkdualnet_pairs` for the port's dkDualNet: the reference shares one
    LayerNorm and one layer_scale between a DLKBlock's two branches and the
    table maps the JAX module's second ones to the same torch keys; the port
    keeps the second ones as `norm_layer2` and `layer_scale2`."""
    out = []
    for fp, tk, kind in dkdualnet_pairs(**kwargs):
        if fp[0].startswith("DLKBlock_"):
            if fp[1] == "LayerNorm_1":
                tk = tk.replace(".norm_layer.", ".norm_layer2.")
            elif fp[1] == "layer_scale2":
                tk = tk.replace(".layer_scale", ".layer_scale2")
        out.append((fp, tk, kind))
    return out


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def randomize_batch_stats(variables, rng: np.random.Generator):
    """Give every BatchNorm running mean/var random values, so the stats'
    conversion is exercised (freshly initialised they are 0 and 1)."""
    v = to_numpy(variables)
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda path, x: (rng.uniform(0.5, 2.0, x.shape) if path[-1].key == "var"
                             else rng.normal(0.0, 0.3, x.shape)).astype(np.float32),
            v["batch_stats"],
        )
    return v


def record_grads(tx):
    """Wraps an optax transformation so that it keeps the last gradients in
    its state (`opt_state[1]`): the JAX `train_step` itself hands them back."""

    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params):
        upd, inner = tx.update(grads, state[0], params)
        return upd, (inner, grads)

    return optax.GradientTransformation(init, update)


def load_torch(module: torch.nn.Module, variables_np, pairs) -> torch.nn.Module:
    sd = jax_to_torch_state_dict(variables_np, pairs, like=module.state_dict())
    module.load_state_dict(sd, strict=True)
    return module.eval()


def assert_close(got, want, tol: float, what: str = ""):
    """max |got - want| <= tol * (1 + max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    bound = tol * (1.0 + np.abs(want).max())
    assert err <= bound, f"{what}: max abs err {err:.3e} > {bound:.3e}"
