"""Rank launcher and rank workers for the port's multi-process tests, and
the port-only checks of `mm_unet_tpu_torch/parallel/` that need no JAX.

`run_ranks(world, fn, tmp_path, *args)` spawns `world` processes, joins
them in one gloo group through a `file://` store under `tmp_path`, runs
`fn(rank, world, *args)` in each on one intra-op thread and returns their
results in rank order (numpy, through a queue). The workers live here,
in a module that imports neither JAX nor the JAX package, so that a
spawned rank starts in about three seconds; the files that compare the
port with the JAX package (`test_torch_port_{dp,cli_dp,sp,tp,pp,ep}.py`)
call them.
"""

from __future__ import annotations

import datetime
import os
import queue
import traceback
import uuid

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn as nn

from mm_unet_tpu_torch.models.layers import BatchNorm2d, Conv2d, Dropout2d

RANK_TIMEOUT = 240  # seconds a test waits for its ranks


def _rank_main(rank, world, init, fn, args, q, env):
    os.environ.update(env)
    torch.set_num_threads(1)
    try:
        if init is not None:
            dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                                    timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
        out = fn(rank, world, *args)
        q.put((rank, None, out))
    except BaseException:  # noqa: BLE001 — reported to the parent, which fails the test
        q.put((rank, traceback.format_exc(), None))
    finally:
        if init is not None and dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(world: int, fn, tmp_path, *args, init: bool = True, envs=None) -> list:
    """fn(rank, world, *args) in `world` spawned processes (in one gloo
    group unless `init` is False; `envs[rank]` added to a rank's
    environment); their results in rank order. A rank that raises fails
    the caller with its traceback."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = f"file://{tmp_path}/store_{uuid.uuid4().hex}" if init else None
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, fn, args, q, (envs or [{}] * world)[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(world):
            try:
                rank, err, out = q.get(timeout=RANK_TIMEOUT)
            except queue.Empty:
                errors.append(f"no result within {RANK_TIMEOUT} s")
                break
            if err:
                errors.append(f"rank {rank}:\n{err}")
                break
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 1)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert not errors, "\n".join(errors)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [results[r] for r in range(world)]


def numpy_state(module: nn.Module) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in module.state_dict().items()}


def numpy_grads(module: nn.Module) -> dict:
    return {k: p.grad.detach().cpu().numpy().copy() for k, p in module.named_parameters()
            if p.grad is not None}


# --- the data-parallel step ------------------------------------------------

class TinyBNNet(nn.Module):
    """Two 3x3 conv + BatchNorm + ReLU layers, channel dropout and a 1x1
    head: the smallest net that has every part of the data-parallel step
    (BatchNorm's global statistics, dropout rows, the weighted loss)."""

    def __init__(self, width: int = 8, p: float = 0.0):
        super().__init__()
        self.net = nn.Sequential(Conv2d(3, width, 3, padding=1), BatchNorm2d(width), nn.ReLU(),
                                 Conv2d(width, width, 3, padding=1), BatchNorm2d(width),
                                 nn.ReLU(), Dropout2d(p), Conv2d(width, 1, 1))

    def set_dropout_generator(self, generator):
        self.net[6].generator = generator

    def forward(self, x):
        return self.net(x)


TINY_MM = dict(depths=(1, 1, 1, 1), num_slices_list=(4, 4, 4, 4), mamba_dtype=None)
TRAIN_CFG = {"trainer": dict(lr=1e-3, warmup=1, num_epochs=10, weight_decay=0.05,
                             steps_per_epoch=1, optimizer="adamw")}


def build_net(kind: str, state=None, p: float = 0.0):
    """The model of a data-parallel check: "tiny" (TinyBNNet, loaded from
    `state`) or "mm" (a depth-1 MM_Net drawn from seed 8, remat off)."""
    if kind == "tiny":
        model = TinyBNNet(p=p)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
        return model
    from mm_unet_tpu_torch.models import give_model

    return give_model("MM_Net", device="cpu", generator=torch.Generator().manual_seed(8),
                      remat=False, sideout_drop=p, **TINY_MM)


def dp_steps(model, x, y, steps: int, dp=None, zero1: bool = False, rank: int = 0,
             world: int = 1) -> dict:
    """`steps` train steps of `model` on the global batch (x, y): under `dp`
    each rank's rows (`shard_batch`); without it, the whole batch padded
    to a multiple of `world` with its weights (the one-device step of the
    JAX SPMD step). Per step: the global loss, the seg stats of the global
    batch, the summed gradients; then the state and the optimizer's
    whole state dict."""
    from mm_unet_tpu_torch.parallel.mesh import shard_batch
    from mm_unet_tpu_torch.train.trainer import create_train_state, make_loss_fn, train_step

    cfg = {"trainer": dict(TRAIN_CFG["trainer"], zero1=zero1)}
    state = create_train_state(model, cfg, seed=0, dp=dp)
    loss_fn = make_loss_fn({"dice_focal_loss": {}}, {"dice_focal_loss": 1.0})
    if dp is None:
        rows = [shard_batch({"image": x, "label": y}, r, world) for r in range(world)]
        batch = {k: np.concatenate([b[k] for b, _ in rows]) for k in ("image", "label")}
        weight = np.concatenate([w for _, w in rows])
    else:
        batch, weight = shard_batch({"image": x, "label": y}, dp.rank, dp.world)
    out = []
    for _ in range(steps):
        scalars, stats = train_step(state, torch.from_numpy(batch["image"]),
                                    torch.from_numpy(batch["label"]), loss_fn,
                                    sample_weight=torch.from_numpy(weight))
        loss = scalars["total_loss"].item()
        stats = {k: stats[k].numpy() for k in ("inter", "psum", "tsum", "weight")}
        if dp is not None:
            loss = float(dp.host_sum({"l": loss})["l"])
            stats = {k: dp.host_gather(v) for k, v in stats.items()}
        out.append({"loss": loss, "stats": stats, "grads": numpy_grads(model),
                    "buffers": {k: v.detach().numpy().copy() for k, v in model.named_buffers()
                                if k.endswith(("running_mean", "running_var"))}})
    sd = state.optimizer.state_dict()
    groups = getattr(state.optimizer, "optim", state.optimizer).param_groups  # ZeRO: its share
    moments = sum(p.numel() for g in groups for p in g["params"])
    return {"steps": out, "state": numpy_state(model), "moments": moments,
            "optimizer": {i: {k: v.numpy() for k, v in s.items()}
                          for i, s in sd["state"].items()}}


def dp_worker(rank, world, checks):
    """Each (kind, net state, x, y, steps, zero1, p) of `checks` through
    `dp_steps` on this rank; plus at world size 2 the comm helpers."""
    from mm_unet_tpu_torch.parallel import comm
    from mm_unet_tpu_torch.parallel.mesh import DataParallel

    dp = DataParallel()
    out = {"runs": [dp_steps(build_net(kind, st, p), x, y, steps, dp, zero1, rank, world)
                    for kind, st, x, y, steps, zero1, p in checks]}
    out["reduce_dict"] = comm.reduce_dict({"a": rank + 1.0, "b": 2.0 * rank})
    out["reduce_sum"] = comm.reduce_dict({"a": rank + 1.0}, average=False)
    out["all_gather"] = comm.all_gather({"rank": rank, "sq": [rank] * rank})
    out["world"] = (comm.get_world_size(), comm.get_rank(), comm.is_main_process())
    comm.synchronize()
    return out


# --- port-only checks ------------------------------------------------------

def test_comm_without_a_process_group():
    from mm_unet_tpu_torch.parallel import comm

    assert not dist.is_initialized()
    assert (comm.get_world_size(), comm.get_rank(), comm.is_main_process()) == (1, 0, True)
    assert comm.all_gather({"x": 1}) == [{"x": 1}]
    assert comm.reduce_dict({"a": 2}) == {"a": 2.0}
    comm.synchronize()


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_zero_partition_balances_elements(world):
    from mm_unet_tpu_torch.parallel.zero import partition

    sizes = [100, 7, 64, 64, 3, 250, 1, 18]
    owner = partition(sizes, world)
    load = [sum(s for s, o in zip(sizes, owner) if o == r) for r in range(world)]
    assert sorted(set(owner)) == list(range(min(world, len(sizes))))
    assert max(load) - min(load) <= max(sizes)  # greedy by size: within one parameter
    assert partition(sizes, world) == owner  # the same on every rank


def test_data_parallel_init_needs_torchrun(monkeypatch):
    """A plain process is a one-process run; asking for the card without
    one raises, never falling back to the CPU."""
    from mm_unet_tpu_torch.parallel.mesh import init_data_parallel

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert init_data_parallel("cpu") == (None, torch.device("cpu"))
    if not torch.cuda.is_available():
        monkeypatch.setenv("WORLD_SIZE", "1")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_data_parallel("cuda")


# --- the entry point under torchrun's environment ----------------------------

def cli_worker(rank, world, dirs, config_path, sigterm_rank=None):
    """`cli.train` (setup + fit, as its `main`) on the CPU in `dirs[rank]`,
    the rank's environment being torchrun's (set by the caller) or none
    (a one-process run). `sigterm_rank` sends itself a SIGTERM after its
    first optimizer step. Returns fit's code, the steps taken and whether
    the run stopped."""
    import signal

    from mm_unet_tpu_torch.cli import train as cli_train
    from mm_unet_tpu_torch.utils import load_config

    os.chdir(dirs[rank])
    s = cli_train.setup(load_config(config_path), "cpu")
    if rank == sigterm_rank:
        def after_step(*_):
            hook.remove()
            os.kill(os.getpid(), signal.SIGTERM)

        hook = s.state.optimizer.register_step_post_hook(after_step)
    rc = cli_train.fit(s)
    return {"rc": rc, "step": s.state.step, "stopped": s.stop.requested,
            "world": None if s.dp is None else s.dp.world}


# --- sequence, tensor, pipeline and expert parallelism ------------------------

def _leaf(a, grad=True):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def sp_worker(rank, world, cases):
    """Each case (u, delta, A, B, C, D, z, delta_bias, w) through
    `selective_scan_sp` on this rank's tokens, loss sum(y * w): this rank's
    y and the gradients (this rank's tokens of u, delta, B, C, z; A, D,
    delta_bias whole)."""
    from mm_unet_tpu_torch.parallel.sp import selective_scan_sp

    out = []
    for u, delta, A, B, C, D, z, dbias, w in cases:
        per = u.shape[-1] // world
        sl = slice(rank * per, (rank + 1) * per)
        loc = [_leaf(a[..., sl]) if a is not None else None for a in (u, delta, B, C, z)]
        full = [_leaf(a) for a in (A, D, dbias)]
        y = selective_scan_sp(loc[0], loc[1], full[0], loc[2], loc[3], full[1], loc[4], full[2],
                              delta_softplus=True)
        (y * torch.from_numpy(w[..., sl])).sum().backward()
        out.append({"y": y.detach().numpy(),
                    "local": [None if t is None else t.grad.numpy() for t in loc],
                    "whole": [t.grad.numpy() for t in full]})
    return out


class MicroMambaNet(nn.Module):
    """The port of `tests/test_tp.py::MicroMambaNet`: a 4x4 stride-4 conv
    stem, a tri-directional Mamba over the 16 tokens (the grouped-scan
    route, kernels 5/6 on the card), the residual, a nearest 4x upsample
    and a 1x1 head."""

    def __init__(self, dim: int = 16):
        super().__init__()
        from mm_unet_tpu_torch.models.mamba import Mamba

        self.stem = Conv2d(3, dim, 4, stride=4)
        self.mamba = Mamba(d_model=dim, bimamba_type="v3", nslices=4, scan_impl="pallas")
        self.head = Conv2d(dim, 1, 1)

    def forward(self, x):
        h = self.stem(x)
        b, c, hh, ww = h.shape
        t = h.flatten(2).transpose(1, 2)  # (B, tokens, C)
        t = t + self.mamba(t)[0]
        h = t.transpose(1, 2).reshape(b, c, hh, ww)
        return self.head(nn.functional.interpolate(h, scale_factor=4, mode="nearest"))


def grid_groups(data: int, model: int):
    """This rank's (data group, model group) of a data x model grid, rank =
    d * model + m; every rank creates every group, in one order."""
    rank = dist.get_rank()
    mine = {}
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)])
        if rank % model == m:
            mine["data"] = g
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)])
        if rank // model == d:
            mine["model"] = g
    return mine["data"], mine["model"]


def gather_params(model: nn.Module, whole: nn.Module, group=None) -> dict:
    """{name: whole tensor} of a model that `shard_params` split: each split
    parameter gathered from the group's ranks and put back in the whole
    layout of `whole` (the same model before the split). Collective."""
    from mm_unet_tpu_torch.parallel.tp import spec_for

    world = dist.get_world_size(group)
    have = dict(model.named_parameters())
    out = {}
    for name, p in whole.named_parameters():
        t = have[name].detach()
        dim = spec_for(name, p.shape, world)
        if dim is not None and t.shape != p.shape:
            parts = [torch.empty_like(t) for _ in range(world)]
            dist.all_gather(parts, t.contiguous(), group=group)
            if name.startswith("mamba.in_proj."):
                halves = [q.chunk(2, dim=dim) for q in parts]
                t = torch.cat([torch.cat([h[0] for h in halves], dim=dim),
                               torch.cat([h[1] for h in halves], dim=dim)], dim=dim)
            else:
                t = torch.cat(parts, dim=dim)
        out[name] = t
    return out


def tp_worker(rank, world, state, x, y, data, model):
    """One train step of MicroMambaNet with its Mamba split over the model
    group and the batch over the data group (ZeRO-1 when there are more
    than one data rank): the global loss and every parameter, whole."""
    from mm_unet_tpu_torch.parallel.mesh import DataParallel
    from mm_unet_tpu_torch.parallel.mesh import shard_batch
    from mm_unet_tpu_torch.parallel.tp import shard_params
    from mm_unet_tpu_torch.train.trainer import create_train_state, make_loss_fn, train_step

    dgroup, mgroup = grid_groups(data, model)
    whole = MicroMambaNet()
    whole.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    net = MicroMambaNet()
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    shard_params(net, mgroup)
    dp = DataParallel(dgroup) if data > 1 else None
    tcfg = dict(TRAIN_CFG["trainer"])
    st = create_train_state(net, {"trainer": tcfg}, dp=dp)
    batch, w = (shard_batch({"image": x, "label": y}, dp.rank, dp.world) if dp is not None
                else ({"image": x, "label": y}, np.ones(len(x), np.float32)))
    loss_fn = make_loss_fn({"dice_focal_loss": {}}, {"dice_focal_loss": 1.0})
    scalars, _ = train_step(st, torch.from_numpy(batch["image"]), torch.from_numpy(batch["label"]),
                            loss_fn, sample_weight=torch.from_numpy(w))
    loss = scalars["total_loss"].item()
    if dp is not None:
        loss = float(dp.host_sum({"l": loss})["l"])
    return {"loss": loss,
            "params": {k: v.numpy() for k, v in gather_params(net, whole, mgroup).items()},
            "local_in_proj": tuple(net.mamba.in_proj.weight.shape)}


PP_LM = dict(d_model=16, n_layer=4, vocab_size=32, d_state=4)  # `tests/test_pp.py`'s widths


def pp_lm(state=None):
    """The port's MixerModel at PP_LM's widths, loaded from `state`, with
    norm_f at the JAX MixerModel's eps 1e-6 (the port's is 1e-5)."""
    from mm_unet_tpu_torch.models.lm import MixerModel

    model = MixerModel(**PP_LM)
    if state is not None:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    model.norm_f.eps = 1e-6
    return model


def pp_mlp(seed: int = 0) -> nn.ModuleList:
    g = torch.Generator().manual_seed(seed)
    layers = nn.ModuleList(nn.Sequential(nn.Linear(8, 8), nn.Tanh()) for _ in range(4))
    with torch.no_grad():
        for p in layers.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.5)
    return layers


def pp_worker(rank, world, state, ids, w, xs, ws, microbatches):
    """For each M of `microbatches`: `mixer_pipeline_forward` of the port's
    MixerModel (loss sum(out * w)) and `pipeline_apply` of four tanh MLP
    layers on xs (loss sum(out * ws)): the outputs and the gradients this
    stage holds (its layers', the embedding's on stage 0, norm_f's, and the
    MLP input's)."""
    from mm_unet_tpu_torch.parallel.pp import (
        make_stage_fn,
        mixer_pipeline_forward,
        pipeline_apply,
        stage_layers,
    )

    out = []
    for m in microbatches:
        model = pp_lm(state)
        y = mixer_pipeline_forward(model, torch.from_numpy(ids), num_microbatches=m)
        (y * torch.from_numpy(w)).sum().backward()
        mlp = pp_mlp()
        x = _leaf(xs)
        z = pipeline_apply(make_stage_fn(stage_layers(mlp)), x, num_microbatches=m)
        (z * torch.from_numpy(ws)).sum().backward()
        out.append({"y": y.detach().numpy(), "grads": numpy_grads(model), "z": z.detach().numpy(),
                    "mlp_grads": numpy_grads(mlp),
                    "dx": None if x.grad is None else x.grad.numpy()})
    return out


EP = dict(d_model=16, d_ff=32, n_experts=4)


def ep_ffn(state, capacity_factor):
    from mm_unet_tpu_torch.parallel.ep import SwitchFFN

    ffn = SwitchFFN(**EP, capacity_factor=capacity_factor)
    ffn.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return ffn


def ep_worker(rank, world, state, x, w, capacity_factors):
    """SwitchFFN with its experts split over the ranks, for each capacity
    factor: y, aux and the gradients of sum(y * w) + aux (W1/W2 gathered
    whole, the router's and the input's as they are on this rank)."""
    from mm_unet_tpu_torch.parallel.ep import shard_moe_params

    out = []
    for cf in capacity_factors:
        ffn = shard_moe_params(ep_ffn(state, cf))
        xt = _leaf(x)
        y, aux = ffn(xt)
        ((y * torch.from_numpy(w)).sum() + aux).backward()
        grads = numpy_grads(ffn)
        for k in ("W1", "W2"):
            parts = [torch.empty_like(getattr(ffn, k).grad) for _ in range(world)]
            dist.all_gather(parts, getattr(ffn, k).grad)
            grads[k] = torch.cat(parts).numpy()
        out.append({"y": y.detach().numpy(), "aux": aux.item(), "grads": grads,
                    "dx": xt.grad.numpy(), "local_experts": ffn.W1.shape[0]})
    return out


def test_parallel_and_tools_never_import_jax():
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import mm_unet_tpu_torch.parallel, mm_unet_tpu_torch.data.volumetric\n"
        "import mm_unet_tpu_torch.cli.visualize, mm_unet_tpu_torch.cli.weight_test\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'mm_unet_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
