"""The port's backbone warm start (`mm_unet_tpu_torch/utils/torch_convert.py`)
against the JAX package's (`mm_unet_tpu/utils/torch_convert.py`), on the CPU
at tiny sizes: the same synthetic reference-named state_dict, made from a
numpy seed, goes through both packages' loaders, and every tensor and the
count of tensors replaced must agree exactly; the loaded backbones' forwards
agree within TOL in f32. Then the whole slice through a config section's
`model_dir` (CVC_UNETR through both packages' `create_train_state`), the
b2/b3 switch, FCBFormer's flattened backbone, the no-op cases and the
import boundary.
"""

import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from mm_unet_tpu.models.registry import give_model as jax_give_model
from mm_unet_tpu.models.pvtv2 import PVTv2 as JPVTv2
from mm_unet_tpu.models.resnet import Res2Net50Encoder as JRes2Net50Encoder
from mm_unet_tpu.train.trainer import create_train_state as jax_create_train_state
from mm_unet_tpu.utils import torch_convert as jtc
from mm_unet_tpu.utils.config import ConfigDict as JConfigDict
from mm_unet_tpu.utils.torch_convert import cvc_unetr_pairs, pvtv2_pairs, res2net50_pairs
from mm_unet_tpu_torch.models import give_model_from_config
from mm_unet_tpu_torch.models.pvtv2 import PVTv2
from mm_unet_tpu_torch.models.resnet import Res2Net50Encoder
from mm_unet_tpu_torch.train.trainer import create_train_state
from mm_unet_tpu_torch.utils import ConfigDict
from mm_unet_tpu_torch.utils.convert import jax_to_torch_state_dict
from mm_unet_tpu_torch.utils.torch_convert import (load_pvtv2_params, load_res2net_params,
                                                   pvtv2_keys, warm_start)
from test_torch_port_zoo_conv import jax_variables, one_torch_thread  # noqa: F401
from torch_port_harness import assert_close, load_torch

TOL = 1e-5  # f32 forwards, |port - JAX| <= TOL * (1 + max |JAX|)

# ---------------------------------------------------------------- PVTv2
# tests/test_torch_convert.py's tiny PVTv2 and its state_dict

DIMS = (8, 8, 16, 16)
HEADS = (1, 1, 2, 2)
MLPS = (2, 2, 2, 2)
DEPTHS = (1, 1, 1, 1)
SRS = (2, 2, 1, 1)
PVT_PAIRS = pvtv2_pairs((), pe_key=lambda i: f"patch_embed{i + 1}",
                        blk_key=lambda i, j: f"block{i + 1}.{j}",
                        norm_key=lambda i: f"norm{i + 1}", depths=DEPTHS, sr_ratios=SRS)


def _make_pvt_state_dict(rng, dims=DIMS, mlps=MLPS, depths=DEPTHS, srs=SRS):
    """Random tensors under the reference pvt_v2.py names."""
    sd = {}

    def t(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.1

    in_c = 3
    for i in range(4):
        c = dims[i]
        p = 7 if i == 0 else 3
        sd[f"patch_embed{i+1}.proj.weight"] = t(c, in_c, p, p)
        sd[f"patch_embed{i+1}.proj.bias"] = t(c)
        sd[f"patch_embed{i+1}.norm.weight"] = 1.0 + t(c)
        sd[f"patch_embed{i+1}.norm.bias"] = t(c)
        for j in range(depths[i]):
            b = f"block{i+1}.{j}"
            sd[f"{b}.norm1.weight"] = 1.0 + t(c)
            sd[f"{b}.norm1.bias"] = t(c)
            sd[f"{b}.norm2.weight"] = 1.0 + t(c)
            sd[f"{b}.norm2.bias"] = t(c)
            sd[f"{b}.attn.q.weight"] = t(c, c)
            sd[f"{b}.attn.q.bias"] = t(c)
            sd[f"{b}.attn.kv.weight"] = t(2 * c, c)
            sd[f"{b}.attn.kv.bias"] = t(2 * c)
            sd[f"{b}.attn.proj.weight"] = t(c, c)
            sd[f"{b}.attn.proj.bias"] = t(c)
            if srs[i] > 1:
                sd[f"{b}.attn.sr.weight"] = t(c, c, srs[i], srs[i])
                sd[f"{b}.attn.sr.bias"] = t(c)
                sd[f"{b}.attn.norm.weight"] = 1.0 + t(c)
                sd[f"{b}.attn.norm.bias"] = t(c)
            hid = int(c * mlps[i])
            sd[f"{b}.mlp.fc1.weight"] = t(hid, c)
            sd[f"{b}.mlp.fc1.bias"] = t(hid)
            sd[f"{b}.mlp.dwconv.dwconv.weight"] = t(hid, 1, 3, 3)
            sd[f"{b}.mlp.dwconv.dwconv.bias"] = t(hid)
            sd[f"{b}.mlp.fc2.weight"] = t(c, hid)
            sd[f"{b}.mlp.fc2.bias"] = t(c)
        sd[f"norm{i+1}.weight"] = 1.0 + t(c)
        sd[f"norm{i+1}.bias"] = t(c)
        in_c = c
    return sd


# ---------------------------------------------------------------- Res2Net
# tests/test_torch_convert.py's tiny Res2Net and its state_dict, at the four
# stages the port's encoder runs (two blocks in the first: a block that is
# not a stage's first has no downsample)

R2N_BLOCKS = (2, 1, 1, 1)
R2N_WIDTHS = (16, 32, 16, 16)


def _make_r2n_state_dict(rng):
    sd = {}

    def t(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.1

    def bn(prefix, c):
        sd[f"{prefix}.weight"] = (1.0 + t(c)).astype(np.float32)
        sd[f"{prefix}.bias"] = t(c)
        sd[f"{prefix}.running_mean"] = t(c)
        sd[f"{prefix}.running_var"] = (1.0 + np.abs(t(c))).astype(np.float32)
        sd[f"{prefix}.num_batches_tracked"] = np.array(7, np.int64)

    sd["conv1.0.weight"] = t(32, 3, 3, 3)
    bn("conv1.1", 32)
    sd["conv1.3.weight"] = t(32, 32, 3, 3)
    bn("conv1.4", 32)
    sd["conv1.6.weight"] = t(64, 32, 3, 3)
    bn("bn1", 64)
    in_c = 64
    for i, (n, planes) in enumerate(zip(R2N_BLOCKS, R2N_WIDTHS)):
        per = int(planes * 26 / 64)
        width = per * 4
        for j in range(n):
            p = f"layer{i+1}.{j}"
            sd[f"{p}.conv1.weight"] = t(width, in_c, 1, 1)
            bn(f"{p}.bn1", width)
            for s in range(3):
                sd[f"{p}.convs.{s}.weight"] = t(per, per, 3, 3)
                bn(f"{p}.bns.{s}", per)
            sd[f"{p}.conv3.weight"] = t(planes * 4, width, 1, 1)
            bn(f"{p}.bn3", planes * 4)
            if j == 0:
                sd[f"{p}.downsample.1.weight"] = t(planes * 4, in_c, 1, 1)
                bn(f"{p}.downsample.2", planes * 4)
            in_c = planes * 4
    return sd


def _spoil(sd: dict, reshaped: str, removed: str) -> dict:
    """sd with a `head.weight`, `reshaped` one column wider and `removed`
    gone: what both loaders must skip."""
    sd = dict(sd, **{"head.weight": np.ones((10, 16), np.float32)})
    w = sd[reshaped]
    sd[reshaped] = np.concatenate([w, w[:, :1]], axis=1)
    del sd[removed]
    return sd


def _torch_sd(sd: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _jax_count(capsys, loader: str) -> int:
    return int(re.search(rf"{loader}: loaded (\d+) tensors", capsys.readouterr().out).group(1))


def _assert_equal(model: nn.Module, want: dict):
    got = model.state_dict()
    for k, w in want.items():
        assert torch.equal(got[k], w), k


def test_pvtv2_loader_matches_jax(capsys):
    """The same spoilt state_dict through both loaders, from the same
    starting weights: equal tensors, equal counts, the skipped ones as
    built; then the four maps at 32² within TOL."""
    rng = np.random.default_rng(0)
    sd = _spoil(_make_pvt_state_dict(rng), "block2.0.attn.proj.weight",
                "block3.0.mlp.fc1.bias")
    x = rng.standard_normal((1, 3, 32, 32)).astype(np.float32)
    jm = JPVTv2(embed_dims=DIMS, num_heads=HEADS, mlp_ratios=MLPS, depths=DEPTHS, sr_ratios=SRS)
    xh = x.transpose(0, 2, 3, 1)
    v0 = jax_variables(jm, xh, seed=1)
    jparams = jtc.load_pvtv2_params(v0["params"], sd, depths=DEPTHS)
    n_jax = _jax_count(capsys, "load_pvtv2_params")

    tm = PVTv2(3, DIMS, HEADS, MLPS, DEPTHS, SRS, generator=torch.Generator().manual_seed(2))
    load_torch(tm, v0, PVT_PAIRS)
    before = {k: t.clone() for k, t in tm.state_dict().items()}
    n = load_pvtv2_params(tm, _torch_sd(sd), DEPTHS)

    assert n == n_jax == len(before) - 2
    _assert_equal(tm, jax_to_torch_state_dict({"params": jparams}, PVT_PAIRS,
                                              like=tm.state_dict()))
    for k in ("block2.0.attn.proj.weight", "block3.0.mlp.fc1.bias"):
        assert torch.equal(tm.state_dict()[k], before[k]), k
    want = jax.jit(lambda p, x_: jm.apply({"params": p}, x_))(jparams, jnp.asarray(xh))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), TOL, f"map {i}")


def test_res2net_loader_matches_jax(capsys):
    """As the PVTv2 test, for the Res2Net-50 encoder with its running
    statistics (`num_batches_tracked` never copied); the eval-mode maps at
    32² within TOL; and `warm_start` on a model holding the encoder (the
    Res2Net branch) loads the same tensors."""
    rng = np.random.default_rng(3)
    sd = _spoil(_make_r2n_state_dict(rng), "layer2.0.conv1.weight", "layer3.0.bns.1.running_var")
    x = rng.standard_normal((1, 3, 32, 32)).astype(np.float32)
    jm = JRes2Net50Encoder(blocks=R2N_BLOCKS, widths=R2N_WIDTHS)
    xh = x.transpose(0, 2, 3, 1)
    v0 = jax_variables(jm, xh, seed=4)
    loaded = jtc.load_res2net_params(v0, sd, blocks=R2N_BLOCKS)
    n_jax = _jax_count(capsys, "load_res2net_params")

    pairs = res2net50_pairs((), "", blocks=R2N_BLOCKS)
    tm = load_torch(Res2Net50Encoder(blocks=R2N_BLOCKS, widths=R2N_WIDTHS), v0, pairs)
    before = {k: t.clone() for k, t in tm.state_dict().items()}
    n = load_res2net_params(tm, _torch_sd(sd), R2N_BLOCKS)

    tracked = sum(k.endswith("num_batches_tracked") for k in before)
    assert n == n_jax == len(before) - tracked - 2
    _assert_equal(tm, jax_to_torch_state_dict(loaded, pairs, like=tm.state_dict()))
    for k in ("layer2.0.conv1.weight", "layer3.0.bns.1.running_var"):
        assert torch.equal(tm.state_dict()[k], before[k]), k
    for k in before:
        if k.endswith("num_batches_tracked"):
            assert torch.equal(tm.state_dict()[k], before[k]), k
    want = jax.jit(lambda v_, x_: jm.apply(v_, x_))(loaded, jnp.asarray(xh))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), TOL, f"map {i}")


def _config(path: str, name: str = "DuAT", section: str = "duat", **branch) -> dict:
    return dict(finetune=dict(model_choose=name, checkpoint=name),
                trainer=dict(dataset_choose="Kvasir", lr=1e-3, warmup=1, num_epochs=2),
                models={section: dict(branch1=dict(model_dir=path, **branch))})


def test_warm_start_res2net_branch(tmp_path):
    """A model with a Res2Net50Encoder and no PVTv2 (as CFANet) loads the
    file named by its section through `warm_start`, as the loader does."""
    sd = _torch_sd(_make_r2n_state_dict(np.random.default_rng(5)))
    path = tmp_path / "res2net50_v1b.pth"
    torch.save({"state_dict": {**sd, "version": 2}, "epoch": 3}, path)
    model = nn.Sequential(nn.Conv2d(3, 3, 1), Res2Net50Encoder(blocks=R2N_BLOCKS,
                                                               widths=R2N_WIDTHS))
    direct = Res2Net50Encoder(blocks=R2N_BLOCKS, widths=R2N_WIDTHS)
    n = warm_start(model, ConfigDict(_config(str(path), "CFANet", "cfa_net")))
    assert n == load_res2net_params(direct, sd) > 0
    _assert_equal(model[1], direct.state_dict())


def test_fcbformer_sequential_layout_loads_as_the_pvtv2():
    """FCBFormer's backbone, a PVTv2's children flattened into a
    Sequential (child 3i + s is stage i + 1's patch_embed, block, norm),
    takes the same tensors as the PVTv2 itself."""
    sd = _torch_sd(_make_pvt_state_dict(np.random.default_rng(6)))
    pvt = PVTv2(3, DIMS, HEADS, MLPS, DEPTHS, SRS, generator=torch.Generator().manual_seed(7))
    seq = nn.Sequential(*PVTv2(3, DIMS, HEADS, MLPS, DEPTHS, SRS,
                               generator=torch.Generator().manual_seed(8)).children())
    n = load_pvtv2_params(pvt, sd, DEPTHS)
    assert n == load_pvtv2_params(seq, sd, DEPTHS) == len(sd)
    assert [tuple(t.shape) for t in seq.state_dict().values()] == \
        [tuple(t.shape) for t in pvt.state_dict().values()]
    for (ks, a), (kp, b) in zip(seq.state_dict().items(), pvt.state_dict().items()):
        assert torch.equal(a, b), (ks, kp)
        assert torch.equal(b, sd[kp]), kp


@pytest.mark.parametrize("stage3", [7, 8])
def test_block3_7_selects_b3_depths(tmp_path, stage3):
    """A file with a `block3.7.` tensor loads at b3's depths (3, 4, 18, 3):
    every block of a stage-3 depth of 8; without one, at b2's (3, 4, 6, 3):
    stage 3's blocks past the sixth are left as built."""
    depths = (1, 1, stage3, 1)
    sd = _torch_sd(_make_pvt_state_dict(np.random.default_rng(9), depths=depths))
    path = tmp_path / "pvt_v2.pth"
    torch.save(sd, path)
    model = nn.Sequential(PVTv2(3, DIMS, HEADS, MLPS, depths, SRS,
                                generator=torch.Generator().manual_seed(10)))
    before = {k: t.clone() for k, t in model[0].state_dict().items()}
    n = warm_start(model, ConfigDict(_config(str(path))))
    left = [k for k in before if k.startswith(("block3.6.", "block3.7."))]
    if stage3 == 8:
        assert n == len(before)
        assert all(torch.equal(model[0].state_dict()[k], sd[k]) for k in before)
    else:
        assert n == len(before) - len(left) and left
        assert all(torch.equal(model[0].state_dict()[k], before[k]) for k in left)
    assert set(pvtv2_keys((3, 4, 18, 3))) >= set(before)


def test_mismatched_depths_load_by_name(capsys):
    """Where the loader's depths differ from the module's, the JAX loader
    counts blocks across stages (`PVTBlock_k`, k over the loader's depths)
    and so skips or misplaces them; the port copies by name, as the
    reference's `load_state_dict` does, and loads every block the module
    and the file share."""
    depths = (2, 1, 1, 1)
    sd = _make_pvt_state_dict(np.random.default_rng(11))  # depths (1, 1, 1, 1)
    x = np.zeros((1, 32, 32, 3), np.float32)
    jm = JPVTv2(embed_dims=DIMS, num_heads=HEADS, mlp_ratios=MLPS, depths=DEPTHS, sr_ratios=SRS)
    jtc.load_pvtv2_params(jax_variables(jm, x, seed=12)["params"], sd, depths=depths)
    n_jax = _jax_count(capsys, "load_pvtv2_params")
    tm = PVTv2(3, DIMS, HEADS, MLPS, DEPTHS, SRS)
    assert load_pvtv2_params(tm, _torch_sd(sd), depths) == len(sd) > n_jax


# ---------------------------------------------------------------- the slice

CVC_DIMS = (16, 32, 40, 64)  # PVTv2-b2's heads (1, 2, 5, 8) divide them
CVC_SRC = dict(mlps=(8, 8, 4, 4), depths=(3, 4, 6, 3), srs=(8, 4, 2, 1))


def test_cvc_unetr_warm_start_through_config_matches_jax(tmp_path, monkeypatch,
                                                         one_torch_thread):  # noqa: F811
    """CVC_UNETR (b2 depths, narrow dims) with its section's `model_dir`
    naming a pvt_v2_b2-style file: JAX's `create_train_state` on one side;
    on the other, `give_model_from_config` starting from the JAX init
    (taken where JAX's warm start receives it) and the port's
    `create_train_state`. The port's model equals JAX's state exactly, its
    backbone holds the file's tensors, and the eval logits agree within
    TOL."""
    sd = _spoil(_make_pvt_state_dict(np.random.default_rng(13), CVC_DIMS, **CVC_SRC),
                "block4.2.mlp.fc2.weight", "block1.1.attn.sr.bias")
    path = tmp_path / "pvt_v2_b2.pth"
    torch.save(_torch_sd(sd), path)
    cfg = _config(str(path), "CVC_UNETR", "cvc_unetr", out_channels=1, dims=list(CVC_DIMS))
    x = np.random.default_rng(14).standard_normal((2, 3, 32, 32)).astype(np.float32)

    seen = []
    original = jtc.warm_start_variables

    def recorded(variables, config):
        seen.append(jax.device_get(variables))
        return original(variables, config)

    monkeypatch.setattr(jtc, "warm_start_variables", recorded)
    jcfg = JConfigDict(cfg)
    jm = jax_give_model(jcfg)
    state = jax_create_train_state(jm, jcfg, jax.random.key(0), jnp.asarray(x))
    jvars = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
    (v0,) = seen

    pairs = cvc_unetr_pairs()
    model = give_model_from_config(ConfigDict(cfg), "cpu")
    model.load_state_dict(jax_to_torch_state_dict(v0, pairs, like=model.state_dict()))
    create_train_state(model, ConfigDict(cfg))
    _assert_equal(model, jax_to_torch_state_dict(jvars, pairs, like=model.state_dict()))
    backbone = model.backbone.state_dict()
    mapped = [k for k in backbone if k in sd and sd[k].shape == tuple(backbone[k].shape)]
    assert len(mapped) == len(backbone) - 2
    assert all(torch.equal(backbone[k], torch.from_numpy(sd[k])) for k in mapped)

    want = jax.jit(lambda v_, x_: jm.apply(v_, x_))(jvars, jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert_close(got.numpy(), np.asarray(want), TOL, "CVC_UNETR logits")


@pytest.mark.parametrize("model_dir", ["", "missing"])
def test_warm_start_noop_without_file(tmp_path, model_dir):
    """No `model_dir`, or one naming no file: 0 tensors, nothing changed,
    through `warm_start` and `create_train_state` alike (the JAX package's
    `test_warm_start_variables_noop_without_file`); a config with no
    `finetune` section is a no-op too."""
    path = str(tmp_path / model_dir) if model_dir else ""
    cfg = ConfigDict(_config(path))
    model = nn.Sequential(PVTv2(3, DIMS, HEADS, MLPS, DEPTHS, SRS))
    before = {k: t.clone() for k, t in model.state_dict().items()}
    assert warm_start(model, cfg) == 0
    assert warm_start(model, {"trainer": cfg.trainer}) == 0
    create_train_state(model, cfg)
    _assert_equal(model, before)


def test_warm_start_module_never_imports_jax():
    code = (
        "import sys\n"
        "import mm_unet_tpu_torch.utils.torch_convert\n"
        "import mm_unet_tpu_torch.train.trainer\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'orbax', 'mm_unet_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)
