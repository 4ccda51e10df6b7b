"""The port's loss registry against the JAX package's, on the CPU: each of
the six `LOSS_REGISTRY` entries, with and without a per-sample `weight`
(including a zero weight, as batch padding carries), value and gradient
w.r.t. the logits, and `make_loss_fn`'s name resolution. Tolerance 1e-6
as max |port - jax| <= tol * (1 + max |jax|): the same arithmetic in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_unet_tpu.train.losses import LOSS_REGISTRY as JAX_REGISTRY
from mm_unet_tpu.train.trainer import make_loss_fn as jax_make_loss_fn
from mm_unet_tpu_torch.train.losses import LOSS_REGISTRY
from mm_unet_tpu_torch.train.trainer import make_loss_fn
from torch_port_harness import assert_close

# per entry: keyword variants beyond the defaults, as the JAX functions take them
VARIANTS = {
    "dice_focal_loss": [{}, {"gamma": 1.5, "lambda_dice": 0.5}],
    "dice_loss": [{}, {"squared_pred": True, "smooth_nr": 1e-5}],
    "focal_loss": [{}, {"alpha": 0.25, "gamma": 1.0}],
    "focal_tversky": [{}, {"alpha": 0.5, "beta": 0.5}],
    "generalized_dice": [{}, {"w_type": "simple"}, {"w_type": "uniform"}],
    "dice_bce": [{}, {"smooth": 1.0}],
}
CASES = [(name, kw) for name, kws in VARIANTS.items() for kw in kws]


def _batch(seed, c=2):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((3, c, 16, 12)) * 3).astype(np.float32)
    labels = (rng.random((3, c, 16, 12)) < 0.2).astype(np.float32)
    labels[1, 0] = 0.0  # an empty target plane (generalized Dice's weight floor)
    return logits, labels


def test_registry_has_the_jax_entries():
    assert set(LOSS_REGISTRY) == set(JAX_REGISTRY) == set(VARIANTS)


@pytest.mark.parametrize("weight", [None, (1.0, 0.0, 2.5)])
@pytest.mark.parametrize("name,kwargs", CASES)
def test_loss_matches_jax(name, kwargs, weight):
    logits, labels = _batch(len(name) + len(kwargs))
    wj = None if weight is None else jnp.asarray(weight, jnp.float32)
    want, want_g = jax.value_and_grad(lambda lg: JAX_REGISTRY[name](
        lg, jnp.asarray(labels), weight=wj, **kwargs))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = LOSS_REGISTRY[name](lt, torch.from_numpy(labels),
                              weight=None if weight is None else torch.tensor(weight), **kwargs)
    got.backward()
    assert got.ndim == 0
    assert_close(got.item(), float(want), 1e-6, f"{name} {kwargs}")
    assert_close(lt.grad.numpy(), np.asarray(want_g), 1e-6, f"d{name}/dlogits {kwargs}")


def test_make_loss_fn_resolves_every_name():
    """Every registry name, and the JAX package's `_loss`-suffix rule
    ("dice" -> dice_loss, "focal" -> focal_loss), with per-name weights:
    the same total and parts as the JAX `make_loss_fn`; an unknown name
    raises."""
    logits, labels = _batch(7)
    names = {**{n: {} for n in LOSS_REGISTRY}, "dice": {}, "focal": {"gamma": 1.0}}
    weights = {n: 0.5 + i for i, n in enumerate(names)}
    w = np.array([1.0, 0.5, 0.0], np.float32)
    total, parts = make_loss_fn(names, weights)(torch.from_numpy(logits), torch.from_numpy(labels),
                                                weight=torch.from_numpy(w))
    want_total, want_parts = jax_make_loss_fn(names, weights)(
        jnp.asarray(logits), jnp.asarray(labels), weight=jnp.asarray(w))
    assert set(parts) == set(want_parts) == set(names)
    for n in names:
        assert_close(parts[n].item(), float(want_parts[n]), 1e-6, n)
    assert_close(total.item(), float(want_total), 1e-6, "total")
    with pytest.raises(KeyError, match="LOSS_REGISTRY"):
        make_loss_fn({"nope": {}}, {})(torch.from_numpy(logits), torch.from_numpy(labels))
