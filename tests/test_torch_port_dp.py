"""The port's data parallelism (`mm_unet_tpu_torch/parallel/{mesh,zero,
comm}.py` and the train step under `TrainState.dp`) against the JAX
package's SPMD step on a `data` mesh, on the CPU: gloo ranks spawned from
the test (`test_torch_port_ranks.run_ranks`), one process group per world
size running all of that size's checks.

- `shard_batch`: this rank's rows and weights are JAX's shards of the
  wrap-padded batch, at batch 5 over 2 and 3 ranks.
- A small BatchNorm conv net (`TinyBNNet`), two steps on a ragged batch of
  5 at 2 and 3 ranks, against JAX's `train_step` on a `data` mesh of that
  size (virtual CPU devices): loss, summed gradients, parameters, BatchNorm
  running statistics and the gathered seg stats. The JAX package's own
  model is held to the same step on a small net because compiling its
  MM_Net step for one mesh size takes about 150 s on this CPU.
- The same net with channel dropout at 0.3 against the port's one-rank
  step on the padded batch: the masks are drawn for the global batch, so
  the step does not depend on the world size.
- A depth-1 MM_Net (BatchNorm), two steps at 2 and 3 ranks, against the
  port's one-rank step on the padded batch, which
  `test_torch_port_train.py` holds to JAX's `train_step`: the first
  step's loss, seg stats and running statistics, and its gradient vector
  by its norm. Element by element MM_Net's gradients do not agree across
  two summation orders: a tap-conv row coordinate within rounding of an
  integer flips floor() and moves the offset path's gradients, and every
  gradient upstream of it (as `chip_smoke.py`'s phase 7 notes): a 1e-6
  relative change of the input moves the one-rank step's gradient vector
  by 0.6% of its norm with dropout on, and one element of the first
  layer's by 0.06% of the largest at 2 ranks with it off. After an AdamW
  step the f32 trajectory is chaotic (the second step's gradients move by
  3% of their largest), so the second step is held by its loss, seg stats
  and the parameters' bound.
- ZeRO-1 at 2 ranks on the small net: each rank keeps about half of the
  moment elements, the losses, gradients, parameters and moments are
  those of the plain AdamW on the same ranks (1e-6), and its gathered
  state loads into a plain AdamW at world size 1.
- `reduce_dict`, `all_gather` and the rank helpers at 2 ranks.

Tolerances, as max |port - ref| <= tol * (1 + max |ref|): loss 1e-5;
gradients 2e-5 (the ranks' partial sums of BatchNorm's moments and of the
gradients are added in another order); MM_Net's gradient vector 1e-2 of
its norm, its second loss 2e-3; running statistics 1e-5 after the first
step, and within 0.1 * 2 lr after the second (the first update may move a
weight whose gradient is ~0 by up to 2 lr more in one run, and the next
batch mean with it), MM_Net's 1e-2; parameters 1e-5 where every step's
gradient is clear of 0 by more than the gradient tolerance, and within
2 lr a step elsewhere (AdamW's first update is about lr * sign(g), so a
gradient within its tolerance of 0 may move the two weights up to 2 lr
apart, as in `test_torch_port_train.py`), MM_Net's within 2 lr a step;
seg stats within one pixel after the first step (a logit at the 0.5
threshold may fall either side), within 0.2% of a plane after the
second, MM_Net's within 1%; weights exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from mm_unet_tpu.parallel import make_mesh, replicate
from mm_unet_tpu.parallel import shard_batch as jax_shard_batch
from mm_unet_tpu.train.optim import build_optimizer as jax_build_optimizer
from mm_unet_tpu.train.optim import warmup_cosine_epoch_schedule as jax_schedule
from mm_unet_tpu.train.trainer import TrainState as JTrainState
from mm_unet_tpu.train.trainer import make_loss_fn as jax_make_loss_fn
from mm_unet_tpu.train.trainer import train_step as jax_train_step
from mm_unet_tpu.utils.torch_convert import bn_pairs, conv_pairs
from mm_unet_tpu_torch.parallel.mesh import shard_batch
from mm_unet_tpu_torch.utils.convert import jax_grads_to_torch, jax_to_torch_state_dict
from test_torch_port_ranks import TRAIN_CFG, TinyBNNet, build_net, dp_steps, dp_worker, run_ranks
from torch_port_harness import assert_close, randomize_batch_stats, record_grads, to_numpy

LR, STEPS = 1e-3, 2
PLANE = {"tiny net": 16 * 16, "MM_Net": 64 * 64, "ZeRO-1 tiny net": 16 * 16}  # pixels a plane
MM_GRAD_NORM_TOL = 1e-2  # MM_Net's first-step gradient vector, relative to its norm
TINY_PAIRS = (conv_pairs(("Conv_0",), "net.0") + bn_pairs(("BatchNorm_0",), "net.1")
              + conv_pairs(("Conv_1",), "net.3") + bn_pairs(("BatchNorm_1",), "net.4")
              + conv_pairs(("Conv_2",), "net.7"))


class FlaxTinyBN(fnn.Module):
    """`TinyBNNet` in flax, NCHW in and out."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        h = jnp.transpose(x, (0, 2, 3, 1))
        for _ in range(2):
            h = fnn.Conv(8, (3, 3), padding="SAME")(h)
            h = fnn.BatchNorm(use_running_average=not train, momentum=0.9, epsilon=1e-5)(h)
            h = fnn.relu(h)
        h = fnn.Conv(1, (1, 1))(h)
        return jnp.transpose(h, (0, 3, 1, 2))


def _batch(seed, size):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((5, 3, size, size)).astype(np.float32)
    y = (rng.random((5, 1, size, size)) < 0.3).astype(np.float32)
    return x, y


@pytest.fixture(scope="module")
def setup():
    x, y = _batch(0, 16)
    xm, ym = _batch(1, 64)
    variables = FlaxTinyBN().init(jax.random.PRNGKey(0), jnp.asarray(x[:2]))
    variables = randomize_batch_stats(variables, np.random.default_rng(2))
    # non-zero conv biases: at init the head's is 0, and a pixel whose ReLUs
    # are all off then has a logit of exactly 0, where the JAX package's
    # BCE has the wrong derivative (test_jax_bce_derivative_at_zero_logit)
    rng = np.random.default_rng(4)
    variables["params"] = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.normal(0.0, 0.1, v.shape).astype(np.float32)
                         if path[-1].key == "bias" and path[0].key.startswith("Conv") else v),
        variables["params"])
    tiny = {k: v.numpy() for k, v in jax_to_torch_state_dict(
        variables, TINY_PAIRS, like=TinyBNNet().state_dict()).items()}
    return {"tiny": (x, y, variables, tiny), "mm": (xm, ym)}


def _jax_tiny(n, variables, x, y):
    """STEPS of JAX's train_step on a `data` mesh of n virtual devices."""
    mesh = make_mesh(devices=jax.devices()[:n])
    sched = jax_schedule(LR, 1, 10, 1)
    tx = record_grads(jax_build_optimizer(variables["params"], lr=sched, weight_decay=0.05))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=replicate(params, mesh),
                        batch_stats=replicate(variables["batch_stats"], mesh),
                        opt_state=replicate(tx.init(params), mesh), tx=tx,
                        apply_fn=FlaxTinyBN().apply)
    sb, w = jax_shard_batch({"image": x, "label": y}, mesh)
    loss_fn = jax_make_loss_fn({"dice_focal_loss": {}}, {"dice_focal_loss": 1.0})
    out = []
    for _ in range(STEPS):
        state, scalars, stats = jax_train_step(state, sb["image"], sb["label"],
                                               jax.random.PRNGKey(1), loss_fn, sample_weight=w)
        out.append({"loss": float(scalars["total_loss"]),
                    "stats": {k: np.asarray(stats[k]) for k in ("inter", "psum", "tsum", "weight")},
                    "grads": {k: v.numpy() for k, v in jax_grads_to_torch(
                        to_numpy(state.opt_state[1]), TINY_PAIRS).items()}})
        out[-1]["buffers"] = {k: v.numpy() for k, v in jax_to_torch_state_dict(
            to_numpy({"params": state.params, "batch_stats": state.batch_stats}),
            TINY_PAIRS).items() if k.endswith(("running_mean", "running_var"))}
    after = to_numpy({"params": state.params, "batch_stats": state.batch_stats})
    return {"steps": out,
            "state": {k: v.numpy() for k, v in jax_to_torch_state_dict(after, TINY_PAIRS).items()}}


def _assert_run(got, want, what, grad_tol=2e-5, chaotic=False):
    """`got` (a port run) against `want` (the reference run), every step;
    `chaotic`: after the first step, the loss, seg stats and the
    parameters' bound alone."""
    settled = {}
    for i, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        loose = chaotic and i > 0
        assert_close(g["loss"], w["loss"], 2e-3 if loose else 1e-5, f"{what} loss, step {i + 1}")
        assert np.array_equal(g["stats"]["weight"], w["stats"]["weight"]), what
        for k in ("inter", "psum", "tsum"):
            # the first step: within one pixel; later ones within 0.2% of a
            # plane, since weights with a ~0 gradient may differ by 2 lr
            lim = 1 if i == 0 else (0.01 if loose else 0.002) * PLANE[what.split(",")[0]]
            assert np.abs(g["stats"][k] - w["stats"][k]).max() <= lim, (what, k, i)
        assert set(g["grads"]) == set(w["grads"])
        if loose:
            continue
        if chaotic:  # MM_Net: the whole gradient vector (see the module docstring)
            diff = np.sqrt(sum(((g["grads"][k] - v) ** 2).sum() for k, v in w["grads"].items()))
            norm = np.sqrt(sum((v ** 2).sum() for v in w["grads"].values()))
            assert diff <= MM_GRAD_NORM_TOL * norm, (what, i, diff / norm)
            continue
        for k, gw in w["grads"].items():
            assert_close(g["grads"][k], gw, grad_tol, f"{what} grad {k}, step {i + 1}")
            clear = np.abs(gw) > grad_tol * (1.0 + np.abs(gw).max())
            settled[k] = clear & settled.get(k, True)
    for k, v in want["steps"][0]["buffers"].items():  # after the first step
        assert_close(got["steps"][0]["buffers"][k], v, 1e-5, f"{what} {k}")
    for k, v in want["state"].items():
        if chaotic and k.endswith(("running_mean", "running_var")):
            # the second batch's statistics, through weights that may differ by 2 lr
            assert_close(got["state"][k], v, 1e-2, f"{what} {k}")
            continue
        if chaotic:
            assert np.abs(got["state"][k] - v).max() <= 2 * LR * STEPS + 1e-5, (what, k)
            continue
        if k.endswith(("running_mean", "running_var")):
            # after the second: the first update may have moved a weight whose
            # gradient is ~0 (a conv bias under BatchNorm) by up to 2 lr more in
            # one package, shifting the next batch mean by as much; the
            # running statistic takes 0.1 of it
            assert np.abs(got["state"][k] - v).max() <= 1e-5 + 0.1 * 2 * LR, (what, k)
        elif k in settled:
            m = settled[k]  # none for a conv bias under BatchNorm: its gradient is ~0
            if m.any():
                assert_close(got["state"][k][m], v[m], 1e-5, f"{what} {k}")
            assert np.abs(got["state"][k] - v).max() <= 2 * LR * STEPS + 1e-5, (what, k)


def _mm_reference(setup, n):
    """The port's one-rank MM_Net steps on the batch padded for n ranks,
    once per padded size (5 rows pad to 6 for both 2 and 3 ranks)."""
    xm, ym = setup["mm"]
    cache = setup.setdefault("mm_refs", {})
    padded = len(xm) + (-len(xm)) % n
    if padded not in cache:
        cache[padded] = dp_steps(build_net("mm"), xm, ym, STEPS, world=n)
    return cache[padded]


@pytest.fixture(scope="module", params=[2, 3])
def ranks(request, setup, tmp_path_factory):
    """(n, every rank's results, the references) for n ranks."""
    n = request.param
    x, y, variables, tiny = setup["tiny"]
    xm, ym = setup["mm"]
    checks = [("tiny", tiny, x, y, STEPS, False, 0.0), ("tiny", tiny, x, y, STEPS, False, 0.3),
              ("mm", None, xm, ym, STEPS, False, 0.0)]
    if n == 2:
        checks.append(("tiny", tiny, x, y, STEPS, True, 0.0))  # ZeRO-1
    got = run_ranks(n, dp_worker, tmp_path_factory.mktemp(f"dp{n}"), checks)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        refs = {"jax_tiny": _jax_tiny(n, variables, x, y),
                "tiny": dp_steps(build_net("tiny", tiny), x, y, STEPS, world=n),
                "tiny_drop": dp_steps(build_net("tiny", tiny, p=0.3), x, y, STEPS, world=n),
                "mm": _mm_reference(setup, n)}
    finally:
        torch.set_num_threads(n_threads)
    return n, got, refs


@pytest.mark.parametrize("n", [2, 3])
def test_shard_batch_matches_jax(n):
    rng = np.random.default_rng(3)
    batch = {"image": rng.standard_normal((5, 3, 4, 4)).astype(np.float32),
             "label": rng.random((5, 1, 4, 4)).astype(np.float32),
             "meta": np.arange(7, dtype=np.float32)}  # another leading size: kept whole
    want, want_w = jax_shard_batch(batch, make_mesh(devices=jax.devices()[:n]))
    parts = [shard_batch(batch, r, n) for r in range(n)]
    for k in ("image", "label"):
        np.testing.assert_array_equal(np.concatenate([p[k] for p, _ in parts]),
                                      np.asarray(want[k]))
    np.testing.assert_array_equal(np.concatenate([w for _, w in parts]), np.asarray(want_w))
    assert all(np.array_equal(p["meta"], batch["meta"]) for p, _ in parts)
    t = torch.from_numpy(batch["image"])  # tensors shard the same way
    np.testing.assert_array_equal(shard_batch({"image": t}, n - 1, n)[0]["image"].numpy(),
                                  parts[n - 1][0]["image"])


def test_dp_step_matches_jax_data_mesh(ranks):
    n, got, refs = ranks
    for r, res in enumerate(got):  # every rank holds the same model and statistics
        _assert_run(res["runs"][0], refs["jax_tiny"], f"tiny net, rank {r} of {n}")
    _assert_run(refs["tiny"], refs["jax_tiny"], f"tiny net, one rank, padded to {n}")


def test_dp_dropout_does_not_depend_on_world_size(ranks):
    n, got, refs = ranks
    for r, res in enumerate(got):
        _assert_run(res["runs"][1], refs["tiny_drop"], f"tiny net, dropout, rank {r} of {n}")


def test_dp_mm_net_matches_one_rank_step(ranks):
    n, got, refs = ranks
    for r, res in enumerate(got):
        _assert_run(res["runs"][2], refs["mm"], f"MM_Net, rank {r} of {n}", chaotic=True)


@pytest.mark.parametrize("ranks", [2], indirect=True)
def test_zero1_shards_moments_and_loads_at_world_one(ranks):
    n, got, refs = ranks
    from mm_unet_tpu_torch.train.trainer import create_train_state

    zero = [res["runs"][3] for res in got]
    model = TinyBNNet()  # the shapes of the ranks' net, for a plain AdamW over it
    sizes = [p.numel() for p in model.parameters()]
    assert sum(z["moments"] for z in zero) == sum(sizes)  # each moment kept once
    assert all(abs(z["moments"] - sum(sizes) / n) <= max(sizes) for z in zero)
    assert all(0 < z["moments"] < sum(sizes) for z in zero)
    for r, z in enumerate(zero):
        # the same arithmetic as the plain AdamW on the same ranks (runs[0])
        _assert_run(z, got[r]["runs"][0], f"ZeRO-1 tiny net, rank {r}", 1e-6)
    # the gathered state has a plain AdamW's layout and values ...
    want = got[0]["runs"][0]["optimizer"]
    assert zero[0]["optimizer"].keys() == want.keys() and len(want) == len(sizes)
    for i, s in want.items():
        for k, v in s.items():
            assert_close(zero[0]["optimizer"][i][k], v, 1e-6, f"optimizer state {i} {k}")
    # ... and loads into one at world size 1
    state = create_train_state(model, TRAIN_CFG)
    groups = state.optimizer.state_dict()["param_groups"]
    state.optimizer.load_state_dict({
        "state": {i: {k: torch.from_numpy(v) for k, v in s.items()}
                  for i, s in zero[0]["optimizer"].items()},
        "param_groups": groups})
    loaded = state.optimizer.state_dict()["state"]
    assert all(torch.equal(loaded[i]["exp_avg"], torch.from_numpy(s["exp_avg"]))
               for i, s in zero[0]["optimizer"].items())


def test_comm_helpers_at_two_ranks(ranks):
    n, got, _ = ranks
    for r, res in enumerate(got):
        assert res["world"] == (n, r, r == 0)
        assert res["reduce_dict"] == pytest.approx(
            {"a": sum(range(1, n + 1)) / n, "b": 2.0 * sum(range(n)) / n})
        assert res["reduce_sum"] == pytest.approx({"a": float(sum(range(1, n + 1)))})
        assert res["all_gather"] == [{"rank": q, "sq": [q] * q} for q in range(n)]


def test_jax_bce_derivative_at_zero_logit():
    """A fault of the JAX package the port does not copy: its BCE,
    max(x, 0) - x t + log1p(exp(-|x|)), takes the subgradients of max and
    |x| at x = 0, so its derivative there is not sigmoid(0) - t = 0.5 - t.
    The port's (`F.binary_cross_entropy_with_logits`) is."""
    from mm_unet_tpu.train.losses import _bce_with_logits
    from mm_unet_tpu_torch.train.losses import focal_loss

    t = np.array([0.0, 1.0], np.float32)
    jg = np.asarray(jax.grad(lambda x: jnp.sum(_bce_with_logits(x, jnp.asarray(t))))(
        jnp.zeros(2, jnp.float32)))
    x = torch.zeros(1, 1, 1, 2, requires_grad=True)
    torch.nn.functional.binary_cross_entropy_with_logits(
        x, torch.from_numpy(t).reshape(1, 1, 1, 2), reduction="sum").backward()
    np.testing.assert_allclose(x.grad.numpy().ravel(), 0.5 - t, atol=1e-7)
    assert np.abs(jg - (0.5 - t)).max() > 0.1  # the JAX package's derivative at 0
    x.grad = None
    focal_loss(x, torch.from_numpy(t).reshape(1, 1, 1, 2)).backward()
    # focal = BCE (1 - p_t)^2 with p_t = 0.5 at x = 0: d/dx = 0.25 (0.5 - t) + BCE d(0.25)/dx
    assert np.isfinite(x.grad.numpy()).all()
