"""The port's Mamba, MMConv, RCG and ResidualBlock against the JAX modules,
with the JAX weights carried across by `utils.convert` and the reference's
pair tables (`mm_net_pairs`, re-rooted at each submodule).

JAX on the CPU runs Mamba's exact associative scan and `_TapConv`'s XLA
path; the port runs its plain versions. f32 throughout; tolerance
max |port - jax| <= 1e-4 * (1 + max |jax|) for a single Mamba (summation
order only) and 2e-4 for the blocks, whose GroupNorms and BatchNorms
rescale the small differences.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_unet_tpu.models.mamba import Mamba as JMamba
from mm_unet_tpu.models.mm_unet import RCG as JRCG
from mm_unet_tpu.models.mm_unet import MMConv as JMMConv
from mm_unet_tpu.models.mm_unet import ResidualBlock as JResidualBlock
from mm_unet_tpu_torch.models.mamba import Mamba
from mm_unet_tpu_torch.models.mm_unet import RCG, MMConv, ResidualBlock
from torch_port_harness import (assert_close, load_torch, randomize_batch_stats, sub_pairs,
                                to_numpy)


def _init(module: fnn.Module, *inputs, seed=0):
    variables = module.init(jax.random.PRNGKey(seed), *(jnp.asarray(x) for x in inputs))
    return randomize_batch_stats(variables, np.random.default_rng(seed))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("d_model,fprefix,tprefix", [
    (3, ("ResidualBlock_0", "MMConv_0", "mamba"), "encoder2.0.block1.0.mamba."),
    (64, ("RCG_0", "mamba"), "rcg4.mamba."),
])
def test_mamba_v3_all_returns_match_jax(d_model, fprefix, tprefix):
    tokens = np.random.default_rng(d_model).standard_normal((2, 32, d_model)).astype(np.float32)
    jm = JMamba(d_model=d_model, bimamba_type="v3", nslices=4)
    v = _init(jm, tokens)
    want = jm.apply(v, jnp.asarray(tokens))
    tm = load_torch(Mamba(d_model=d_model, nslices=4), v, sub_pairs(fprefix, tprefix))
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens))
    assert len(got) == 4
    for name, g, w in zip(("out", "o_fwd", "o_bwd", "o_slice"), got, want):
        assert_close(g.numpy(), np.asarray(w), 1e-4, name)


@pytest.mark.parametrize("k,cin,cout,fprefix,tprefix", [
    (3, 16, 16, ("ResidualBlock_0", "MMConv_0"), "encoder2.0.block1.0."),
    (1, 32, 16, ("MMConv_0",), "down3.0."),
])
def test_mmconv_matches_jax(k, cin, cout, fprefix, tprefix):
    x = np.random.default_rng(k).standard_normal((2, 8, 12, cin)).astype(np.float32)
    jm = JMMConv(out_channels=cout, kernel_size=k, num_slices=4, dtype=None)
    v = _init(jm, x)
    want = jm.apply(v, jnp.asarray(x))
    tm = load_torch(MMConv(cin, cout, k, num_slices=4), v, sub_pairs(fprefix, tprefix))
    with torch.no_grad():
        got = tm(_nchw(x))
    assert_close(_nhwc(got), np.asarray(want), 2e-4, f"MMConv k={k}")


@pytest.mark.parametrize("downsample,cin,cout,fprefix,tprefix", [
    (False, 16, 16, ("ResidualBlock_0",), "encoder2.0."),
    (True, 16, 32, ("ResidualBlock_1",), "encoder3.0."),
])
def test_residual_block_matches_jax(downsample, cin, cout, fprefix, tprefix):
    x = np.random.default_rng(cout).standard_normal((1, 8, 8, cin)).astype(np.float32)
    jm = JResidualBlock(cin, cout, 4, downsample=downsample, dtype=None)
    v = _init(jm, x)
    want = jm.apply(v, jnp.asarray(x))
    tm = load_torch(ResidualBlock(cin, cout, 4, downsample=downsample), v,
                    sub_pairs(fprefix, tprefix))
    with torch.no_grad():
        got = tm(_nchw(x))
    assert_close(_nhwc(got), np.asarray(want), 2e-4, f"ResidualBlock downsample={downsample}")


def test_rcg_matches_jax():
    rng = np.random.default_rng(4)
    pre = rng.standard_normal((1, 8, 8, 1)).astype(np.float32)
    edge = rng.standard_normal((1, 20, 20, 64)).astype(np.float32)
    f = rng.standard_normal((1, 8, 8, 64)).astype(np.float32)
    jm = JRCG(num_slices=4, dtype=None)
    v = _init(jm, pre, edge, f)
    want = jm.apply(v, *(jnp.asarray(a) for a in (pre, edge, f)))
    tm = load_torch(RCG(num_slices=4), v, sub_pairs(("RCG_0",), "rcg4."))
    with torch.no_grad():
        got = tm(_nchw(pre), _nchw(edge), _nchw(f))
    assert_close(_nhwc(got), np.asarray(want), 2e-4, "RCG")


def test_torch_init_follows_flax_distributions():
    """The port's own init matches the flax initialisers in distribution:
    Mamba's A_log, D, dt bias range and dt weight bound, lecun-normal spread."""
    m = Mamba(d_model=64, nslices=4, generator=torch.Generator().manual_seed(0))
    v = to_numpy(JMamba(d_model=64, bimamba_type="v3", nslices=4).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 64))))["params"]
    np.testing.assert_allclose(m.A_b_log.detach().numpy(), v["A_b_log"], rtol=1e-6)
    np.testing.assert_array_equal(m.D_s.detach().numpy(), v["D_s"])
    dt = torch.nn.functional.softplus(m.dt_proj.bias).detach().numpy()
    assert dt.min() >= 1e-3 * 0.999 and dt.max() <= 0.1 * 1.001
    assert m.dt_proj.weight.abs().max() <= 4 ** -0.5
    for name in ("in_proj_weight", "x_proj_weight", "out_proj_weight"):
        t = dict(m.named_parameters())[name.replace("_weight", ".weight")].detach().numpy()
        assert abs(t.std() / v[name].std() - 1.0) < 0.2, name
