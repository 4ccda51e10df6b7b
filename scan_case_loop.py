"""Runs one case of `test_torch_port_scan.py::test_selective_scan_matches_jax_pallas`
([1-6-300-True-False-False]: fused flags, B/C (B, N, L), 6 channels, 300
tokens) in a loop and holds each side's gradients, the port's plain scan and
JAX's `selective_scan_pallas` in interpret mode, to the same fused scan
written out token by token in float64, separately: to learn which side moves
when the case fails under a loaded CPU. JAX's caches are cleared between
iterations, so each one compiles afresh as a new test process would.

    JAX_PLATFORMS=cpu python scan_case_loop.py ITERATIONS TAG

Prints a line for any gradient further than 1e-4 * (1 + max |f64|) from the
float64 one, and at the end the largest such distance of each gradient on
each side. Run several at once to load the CPU.
"""

import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "tests"), str(ROOT)]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_port_scan as t  # noqa: E402


def float64_grads(args, w, batch, dim, L, N):
    """Every input's gradient of sum(out * w) for the fused scan in f64."""
    th = [None if a is None else torch.from_numpy(a).double().requires_grad_(True) for a in args]
    u, delta, A, B, C, D, z, bias = th
    dt = torch.nn.functional.softplus(delta + bias[:, None])
    h = torch.zeros(batch, dim, N, dtype=torch.float64)
    ys = []
    for step in range(L):
        h = (torch.exp(dt[:, :, step, None] * A) * h
             + (dt[:, :, step] * u[:, :, step])[..., None] * B[:, None, :, step])
        ys.append((h * C[:, None, :, step]).sum(-1))
    y = (torch.stack(ys, -1) + D[:, None] * u) * torch.nn.functional.silu(z)
    (y * torch.from_numpy(w).double()).sum().backward()
    return {i: a.grad.numpy() for i, a in enumerate(th) if a is not None}


def main():
    n, tag = int(sys.argv[1]), sys.argv[2]
    bc, dg, L, fused, want_last = 1, 6, 300, True, False
    batch, dim, N = 2, bc * dg, 16
    args = t._inputs(10 * bc + dg + L, batch, dim, L, N, bc, fused)
    w = np.random.default_rng(L).standard_normal((batch, dim, L)).astype(np.float32)
    ref = float64_grads(args, w, batch, dim, L, N)
    worst = {"jax": {}, "port": {}}
    t0 = time.time()
    for it in range(n):
        _, _, jgrads = t._jax_grads(
            lambda *a, **k: t._ps.selective_scan_pallas(*a, **k, chunk=128), args, w, fused,
            want_last, jnp.float32)
        _, _, th = t._port(args, w, fused, want_last, torch.float32)
        sides = {"jax": {i: np.asarray(g, np.float64) for i, g in jgrads.items()},
                 "port": {i: th[i].grad.double().numpy() for i in jgrads}}
        for side, grads in sides.items():
            for i, g in grads.items():
                err = float(np.abs(g - ref[i]).max() / (1 + np.abs(ref[i]).max()))
                name = t.NAMES[i]
                worst[side][name] = max(worst[side].get(name, 0.0), err)
                if err > 1e-4:
                    print(f"{tag} iteration {it} {side} d{name} {err:.3e}", flush=True)
        jax.clear_caches()
    print(tag, "done", n, "iterations", f"{time.time() - t0:.0f} s", json.dumps(worst),
          flush=True)


if __name__ == "__main__":
    main()
