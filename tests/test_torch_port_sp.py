"""The port's sequence-parallel selective scan (`mm_unet_tpu_torch/
parallel/sp.py`) against the JAX package's `selective_scan_sp` on a `seq`
mesh of the same size (virtual CPU devices), on the CPU: 2 and 4 gloo
ranks (`test_torch_port_ranks.run_ranks`, one process group per size),
with and without grouped B/C and z, the softplus prologue and the D skip
on. Values and every gradient (each rank's tokens of u, delta, B, C, z
put back in order; A, D and delta_bias whole on every rank), loss
sum(y * w). And the plain scan's differentiable last state (the local scan
off the card) against JAX's associative core's.

Tolerances are `tests/test_sp.py`'s: values rtol/atol 2e-5, gradients
rtol 5e-4, atol 5e-5 (the recurrence token by token against JAX's
associative scan, and the boundary exchange's sums in their own order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_unet_tpu.ops.selective_scan import _normalize_BC, _selective_scan_assoc_core
from mm_unet_tpu.parallel import make_mesh
from mm_unet_tpu.parallel import selective_scan_sp as jax_selective_scan_sp
from mm_unet_tpu_torch.parallel.sp import local_scan, selective_scan_sp
from test_torch_port_ranks import _leaf, run_ranks, sp_worker

CASES = [(None, True), (None, False), (2, True), (2, False)]  # (groups, with z)


def _inputs(groups, with_z, batch=2, dim=4, n=4, L=32, seed=0):
    rng = np.random.default_rng(seed + 10 * (groups or 1) + with_z)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    bc = (batch, groups, n, L) if groups else (batch, n, L)
    return (f(batch, dim, L), 0.5 * f(batch, dim, L), -np.exp(0.3 * f(dim, n)), f(*bc), f(*bc),
            f(dim), f(batch, dim, L) if with_z else None, 0.1 * f(dim), f(batch, dim, L))


def _jax(world, case):
    """JAX's value and gradients on a `seq` mesh of `world` devices."""
    mesh = make_mesh(("seq",), devices=jax.devices()[:world])
    *args, w = case
    idx = [i for i, a in enumerate(args) if a is not None]

    def loss(*live):
        full = list(args)
        for i, a in zip(idx, live):
            full[i] = a
        return jnp.sum(jax_selective_scan_sp(*full, delta_softplus=True, mesh=mesh) * w)

    live = [jnp.asarray(args[i]) for i in idx]
    y = jax_selective_scan_sp(*args, delta_softplus=True, mesh=mesh)
    grads = dict(zip(idx, jax.grad(loss, argnums=tuple(range(len(idx))))(*live)))
    return np.asarray(y), {i: np.asarray(g) for i, g in grads.items()}


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    world = request.param
    cases = [_inputs(g, z) for g, z in CASES]
    return world, cases, run_ranks(world, sp_worker, tmp_path_factory.mktemp(f"sp{world}"), cases)


@pytest.mark.parametrize("case", range(len(CASES)), ids=[f"groups{g}-z{z}" for g, z in CASES])
def test_sp_scan_matches_jax(ranks, case):
    world, cases, got = ranks
    want_y, want_g = _jax(world, cases[case])
    res = [r[case] for r in got]
    np.testing.assert_allclose(np.concatenate([r["y"] for r in res], -1), want_y,
                               rtol=2e-5, atol=2e-5)
    names = ("u", "delta", "A", "B", "C", "D", "z", "delta_bias")
    local = dict(zip((0, 1, 3, 4, 6), range(5)))  # argument index -> slot of the local grads
    for i, g in want_g.items():
        if i in local:
            got_g = np.concatenate([r["local"][local[i]] for r in res], -1)
        else:
            got_g = res[0]["whole"][(2, 5, 7).index(i)]
            for r in res[1:]:  # the same whole gradient on every rank
                np.testing.assert_array_equal(r["whole"][(2, 5, 7).index(i)], got_g)
        np.testing.assert_allclose(got_g, g, rtol=5e-4, atol=5e-5,
                                   err_msg=f"d{names[i]} at {world} ranks")


@pytest.mark.parametrize("groups", [None, 2])
def test_local_scan_last_state_gradient_matches_jax_assoc_core(groups):
    """The plain scan's last state is differentiable off the card (the
    public `selective_scan` detaches it) and its gradients are those of
    JAX's associative core."""
    u, delta, A, B, C, *_ = _inputs(groups, False, seed=7)
    wy = np.random.default_rng(8).standard_normal(u.shape).astype(np.float32)
    wh = np.random.default_rng(9).standard_normal((u.shape[0], u.shape[1], A.shape[1])).astype(np.float32)

    def jloss(u, delta, A, B, C):
        Bm, vb = _normalize_BC(B, u.shape[1])
        Cm, vc = _normalize_BC(C, u.shape[1])
        y, h = _selective_scan_assoc_core(u, delta, A, Bm, vb, Cm, vc)
        return jnp.sum(y * wy) + jnp.sum(h * wh)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (u, delta, A, B, C)))
    th = [_leaf(a) for a in (u, delta, A, B, C)]
    B4, C4 = (t if t.ndim == 4 else t[:, None] for t in th[3:])
    y, h = local_scan(th[0], th[1], th[2], B4, C4)
    assert h.requires_grad
    ((y * torch.from_numpy(wy)).sum() + (h * torch.from_numpy(wh)).sum()).backward()
    for name, t, g in zip(("u", "delta", "A", "B", "C"), th, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=5e-4, atol=5e-5,
                                   err_msg=name)


def test_sp_scan_without_process_group_is_the_plain_scan():
    """World size 1 (no process group): the local scan alone."""
    from mm_unet_tpu_torch.ops.selective_scan import selective_scan_ref

    u, delta, A, B, C, D, z, dbias, _ = _inputs(2, True)
    t = [None if a is None else torch.from_numpy(a) for a in (u, delta, A, B, C, D, z, dbias)]
    got = selective_scan_sp(*t, delta_softplus=True)
    want = selective_scan_ref(*t, delta_softplus=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="variable"):
        selective_scan_sp(t[0], t[1], t[2], t[2], t[4])
