"""The port's serving slice against the JAX package: the whole MM_Net, the
sliding-window inferer and the DiceFocal loss; plus the validation loop,
the weight converter's strictness and the import boundary (the port never
imports jax).

MM_Net is the small configuration depths=(1,1,1,1),
num_slices_list=(4,4,4,4) at 1x3x64x64 in eval mode, with the JAX weights
and random BatchNorm running statistics carried across by `utils.convert`.
One JAX init serves the file (module-scoped fixture). Tolerances, as
max |port - jax| <= tol * (1 + max |jax|):
- f32 (mamba_dtype=None): 5e-4 — summation order through ~40 layers;
- bf16 (mamba_dtype="bfloat16"): 0.1 — the feature path rounds to bf16 at
  every layer in both packages, but XLA and PyTorch round some
  intermediates at different points (einsum outputs, interpolation
  weights), and the differences grow through the network;
- inferer and loss: 1e-5 — the same arithmetic on the same logits.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_unet_tpu.models.mm_unet import MM_Net as JMM_Net
from mm_unet_tpu.models.mm_unet import validate_input_size as jax_validate_input_size
from mm_unet_tpu.train.inferers import sliding_window_inference as jax_swi
from mm_unet_tpu.train.losses import dice_focal_loss as jax_dice_focal_loss
from mm_unet_tpu.utils.torch_convert import mm_net_pairs
from mm_unet_tpu_torch.evaluate import val_one_epoch
from mm_unet_tpu_torch.models import give_model
from mm_unet_tpu_torch.models.mm_unet import MM_Net, validate_input_size
from mm_unet_tpu_torch.train.inferers import SlidingWindowInferer, sliding_window_inference
from mm_unet_tpu_torch.train.losses import dice_focal_loss
from mm_unet_tpu_torch.train.predictor import make_predictor
from mm_unet_tpu_torch.utils import spans
from mm_unet_tpu_torch.utils.convert import jax_to_torch_state_dict
from torch_port_harness import assert_close, load_torch, randomize_batch_stats

TINY = dict(depths=(1, 1, 1, 1), num_slices_list=(4, 4, 4, 4))


@pytest.fixture(scope="module")
def tiny():
    """(JAX variables as numpy with random BN stats, input image)."""
    x = np.random.default_rng(0).standard_normal((1, 3, 64, 64)).astype(np.float32)
    jm = JMM_Net(mamba_dtype=None, remat=False, **TINY)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    return randomize_batch_stats(variables, np.random.default_rng(1)), x


def _jax_logits(variables, x, mamba_dtype):
    jm = JMM_Net(mamba_dtype=mamba_dtype, remat=False, **TINY)
    return np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))


def _port(variables, mamba_dtype):
    return load_torch(MM_Net(mamba_dtype=mamba_dtype, **TINY), variables,
                      mm_net_pairs(depths=TINY["depths"]))


def test_mm_net_f32_matches_jax(tiny):
    variables, x = tiny
    want = _jax_logits(variables, x, None)
    model = _port(variables, None)
    got = make_predictor(model)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (1, 1, 64, 64)
    assert_close(got.numpy(), want, 5e-4, "MM_Net f32 logits")


def test_mm_net_bf16_matches_jax(tiny):
    variables, x = tiny
    want = _jax_logits(variables, x, "bfloat16")
    model = _port(variables, "bfloat16")
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32  # logits stay f32
    assert_close(got.numpy(), want, 0.1, "MM_Net bf16 logits")
    # the bf16 predictor (weights and windows cast) stays as close
    got_p = make_predictor(model, torch.bfloat16)(torch.from_numpy(x))
    assert got_p.dtype == torch.float32
    assert_close(got_p.numpy(), want, 0.1, "MM_Net bf16 predictor logits")


def test_sliding_window_matches_jax_and_model():
    """A sliding-window pass over the tiny port MM_Net: padded to the window
    in H, two windows in W, gaussian blend — against the JAX inferer driving
    the same torch predictor."""
    model = give_model("MM_Net", device="cpu", generator=torch.Generator().manual_seed(3),
                       mamba_dtype=None, **TINY)
    predictor = make_predictor(model)
    x = np.random.default_rng(2).standard_normal((2, 3, 40, 96)).astype(np.float32)
    got = SlidingWindowInferer((64, 64), overlap=0.5, sw_batch_size=3, mode="gaussian")(
        torch.from_numpy(x), predictor)
    want = jax_swi(jnp.asarray(x), (64, 64),
                   lambda w: jnp.asarray(predictor(torch.from_numpy(np.asarray(w))).numpy()),
                   overlap=0.5, sw_batch_size=3, mode="gaussian")
    assert got.shape == (2, 1, 40, 96)
    assert_close(got.numpy(), np.asarray(want), 1e-5, "sliding window")


@pytest.mark.parametrize("mode,shape,roi,sw", [
    ("constant", (3, 2, 48, 40), (32, 32), 4),  # 2x2 windows, a ragged last group
    ("gaussian", (2, 2, 20, 44), (32, 32), 2),  # padded H, two windows in W
    ("constant", (1, 2, 32, 32), (32, 32), 4),  # one window
])
def test_sliding_window_inference_matches_jax(mode, shape, roi, sw):
    x = np.random.default_rng(len(shape) + shape[2]).standard_normal(shape).astype(np.float32)
    ramp = np.linspace(-1.0, 1.0, roi[1], dtype=np.float32)

    def pred_np(w):  # non-linear, position-dependent, 2 output channels
        return np.concatenate([np.tanh(w[:, :1] * w[:, 1:2]) + ramp,
                               w.sum(1, keepdims=True) * 0.3], axis=1)

    got = sliding_window_inference(torch.from_numpy(x), roi,
                                   lambda w: torch.from_numpy(pred_np(w.numpy())),
                                   overlap=0.5, sw_batch_size=sw, mode=mode)
    want = jax_swi(jnp.asarray(x), roi, lambda w: jnp.asarray(pred_np(np.asarray(w))),
                   overlap=0.5, sw_batch_size=sw, mode=mode)
    assert_close(got.numpy(), np.asarray(want), 1e-5, f"{mode} {shape}")


@pytest.mark.parametrize("seed", [0, 1])
def test_dice_focal_loss_matches_jax(seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((3, 2, 16, 12)) * 3).astype(np.float32)
    labels = (rng.random((3, 2, 16, 12)) < 0.2).astype(np.float32)
    got = dice_focal_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    want = jax_dice_focal_loss(jnp.asarray(logits), jnp.asarray(labels))
    assert_close(got.item(), float(want), 1e-5, "dice_focal_loss")


@pytest.mark.parametrize("hw,ns", [((512, 512), (64, 32, 16, 8)), ((704, 704), (64, 32, 16, 8)),
                                   ((704, 704), (64, 32, 16, 4)), ((96, 64), (4, 4, 4, 2))])
def test_validate_input_size_matches_jax(hw, ns):
    try:
        want = jax_validate_input_size(*hw, ns)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(":")[0]):
            validate_input_size(*hw, ns)
        return
    assert validate_input_size(*hw, ns) == want


def test_val_one_epoch_matches_its_parts():
    """The validation loop over two batches: its losses are DiceFocal of the
    sliding-window logits, and its metrics, fed `seg_stats`' counts, are the
    JAX package's numpy metrics of the thresholded prediction; no mask is
    read back (no `eval.masks` span). The loss comes in `make_loss_fn`'s
    (total, losses) form, as the JAX loop takes it."""
    from mm_unet_tpu.train.metrics import build_metrics
    from mm_unet_tpu_torch.train.metrics import build_metrics as port_build_metrics
    from mm_unet_tpu_torch.train.trainer import make_loss_fn

    model = give_model("MM_Net", device="cpu", generator=torch.Generator().manual_seed(5),
                       mamba_dtype=None, **TINY)
    rng = np.random.default_rng(6)
    batches = [{"image": rng.standard_normal((n, 3, 64, 64)).astype(np.float32),
                "label": (rng.random((n, 1, 64, 64)) < 0.3).astype(np.float32)} for n in (2, 1)]
    inferer = SlidingWindowInferer((64, 64), overlap=0.5)
    loss_fn = make_loss_fn({"dice_focal_loss": {}}, {"dice_focal_loss": 1.0})
    spans.reset()
    f1, metric, losses = val_one_epoch(model, loss_fn, inferer, batches,
                                       port_build_metrics())
    assert "eval.masks" not in spans.snapshot()  # the seven take the counts alone
    predictor = make_predictor(model)
    want_metrics = build_metrics()
    for i, b in enumerate(batches):
        logits = inferer(torch.from_numpy(b["image"]), predictor)
        assert_close(losses[i], dice_focal_loss(logits, torch.from_numpy(b["label"])).item(),
                     1e-6, "loss")
        preds = (torch.sigmoid(logits) > 0.5).float().numpy()
        for m in want_metrics.values():
            m(y_pred=preds, y=b["label"])
    assert set(metric) == {f"Val/mean {k}" for k in want_metrics}
    for name, m in want_metrics.items():
        np.testing.assert_allclose(metric[f"Val/mean {name}"], np.nanmean(m.aggregate()),
                                   rtol=1e-6)
    assert f1 == metric["Val/mean f1"]


def test_val_one_epoch_feeds_the_counts_and_reads_masks_for_hd95():
    """With HD95 beside the seven metrics: the seven take `seg_stats`'
    counts and their aggregates are those of the same metrics fed the
    thresholded masks of the loop's own logits (`mask_stats`), bit for bit;
    HD95 gets the masks, read back once a call (span `eval.masks`)."""
    from mm_unet_tpu_torch.train.metrics import HausdorffDistanceMetric, build_metrics
    from mm_unet_tpu_torch.train.trainer import make_loss_fn

    model = give_model("MM_Net", device="cpu", generator=torch.Generator().manual_seed(5),
                       mamba_dtype=None, **TINY)
    rng = np.random.default_rng(6)
    batches = [{"image": rng.standard_normal((n, 3, 64, 64)).astype(np.float32),
                "label": (rng.random((n, 1, 64, 64)) < 0.3).astype(np.float32)} for n in (2, 1)]
    inferer = SlidingWindowInferer((64, 64), overlap=0.5)
    logits = []

    def keep(images, predictor):
        logits.append(inferer(images, predictor))
        return logits[-1]

    metrics = {**build_metrics(), "hd95": HausdorffDistanceMetric(percentile=95)}
    got = {}
    for name, m in metrics.items():  # keep each aggregate before the loop resets it
        m.aggregate = lambda name=name, agg=m.aggregate: got.setdefault(name, agg())
    loss_fn = make_loss_fn({"dice_focal_loss": {}}, {"dice_focal_loss": 1.0})
    spans.reset()
    _, metric, _ = val_one_epoch(model, loss_fn, keep, batches, metrics)
    assert spans.snapshot()["eval.masks"][0] == len(batches)
    want = {**build_metrics(), "hd95": HausdorffDistanceMetric(percentile=95)}
    for out, b in zip(logits, batches):
        preds = (torch.sigmoid(out) > 0.5).float().numpy()
        assert 0 < preds.mean() < 1  # neither mask path is trivial
        for m in want.values():
            m(y_pred=preds, y=b["label"])
    assert set(got) == set(want)
    for name, m in want.items():
        agg = m.aggregate()
        np.testing.assert_array_equal(got[name], agg, err_msg=name)
        np.testing.assert_array_equal(metric[f"Val/mean {name}"], np.nanmean(agg))
    assert np.isfinite(got["hd95"]).all()


def test_convert_is_strict_and_inverts_the_tables(tiny):
    variables, _ = tiny
    pairs = mm_net_pairs(depths=TINY["depths"])
    like = MM_Net(mamba_dtype=None, **TINY).state_dict()
    sd = jax_to_torch_state_dict(variables, pairs, like=like)
    p = variables["params"]
    mm = p["ResidualBlock_0"]["MMConv_0"]
    # conv (kH,kW,I,O) -> (O,I,kH,kW); conv1d_dw (D,W) -> (D,1,W); dt shift
    np.testing.assert_array_equal(sd["encoder1.0.weight"].numpy(),
                                  p["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["encoder2.0.block1.0.mamba.conv1d_b.weight"].numpy()[:, 0],
                                  mm["mamba"]["conv1d_b_weight"])
    np.testing.assert_allclose(sd["encoder2.0.block1.0.mamba.dt_proj_s.weight"].numpy(),
                               mm["mamba"]["dt_proj_s_weight"] - 1.0, rtol=1e-6)
    # convT: flax kernel[a, b, i, o] == torch weight[i, o, kH-1-a, kW-1-b]
    kt = p["RCG_0"]["ConvTranspose_0"]["kernel"]
    np.testing.assert_array_equal(sd["rcg4.upsample.weight"].numpy(),
                                  kt[::-1, ::-1].transpose(2, 3, 0, 1))
    np.testing.assert_array_equal(sd["encoder1.1.running_var"].numpy(),
                                  variables["batch_stats"]["BatchNorm_0"]["var"])
    with pytest.raises(ValueError, match="missing"):
        jax_to_torch_state_dict(variables, pairs + [(("nope", "kernel"), "nope.weight", "conv")])
    with pytest.raises(ValueError, match="unused"):
        jax_to_torch_state_dict(variables, pairs[1:])
    with pytest.raises(ValueError, match="mismatch"):
        jax_to_torch_state_dict(variables, pairs, like=MM_Net(mamba_dtype=None).state_dict())


def test_give_model_names_roadmap_for_unported_models():
    """FRUNet, which the JAX registry's `_BRANCH1_ONLY` names, is built by
    neither package."""
    with pytest.raises(NotImplementedError, match="JAX package's registry lacks it.*ROADMAP"):
        give_model("FRUNet")


def test_kernel_launch_counts_per_forward():
    """The full MM_Net holds 50 v3 Mambas (47 MMConvs and 3 RCGs)."""
    assert MM_Net().kernel_launches_per_forward() == {"mamba_fused_scan": 150, "tap_conv": 47}


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import mm_unet_tpu_torch, mm_unet_tpu_torch._build, mm_unet_tpu_torch.evaluate\n"
        "import mm_unet_tpu_torch.models.mm_unet, mm_unet_tpu_torch.train.inferers\n"
        "import mm_unet_tpu_torch.train.losses, mm_unet_tpu_torch.train.predictor\n"
        "import mm_unet_tpu_torch.utils.convert, mm_unet_tpu_torch.ops.mamba_fused\n"
        "import mm_unet_tpu_torch.ops.tap_conv\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'orbax')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)
