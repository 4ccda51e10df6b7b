"""The port's copy of the reference's top-level mini pipeline against the
repository's root modules (`data.py`, `loss.py`, `model.py`, loaded by
path), on the CPU.

Tolerances:
- `RetinaDataset`: exact (the same PIL reads and the same arithmetic);
- `dice_coeff` and `DICE_BCE_Loss`: f32, |port - root| <= 1e-6 * (1 +
  |root|) (sums over the batch in other orders);
- `Unet`: the eval logits at 2x3x64x64 with the root model's weights
  carried across by `unet_pairs(False)`, max |port - root| <= 1e-5 * (1 +
  max |root|), the zoo tests' limit (convolutions summed in other orders).
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from mm_unet_tpu.utils.torch_convert import unet_pairs
from mm_unet_tpu_torch.data import RetinaDataset
from mm_unet_tpu_torch.models.unet import Unet
from mm_unet_tpu_torch.train.losses import DICE_BCE_Loss, dice_bce_loss, dice_coeff
from test_torch_port_zoo_conv import LOGITS_TOL, check_eval, jax_variables

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-6


def _root_module(name: str):
    """The repository's top-level `name`.py, loaded by path (a plain
    `import` could find another module of that name first)."""
    spec = importlib.util.spec_from_file_location(f"_repo_root_{name}", ROOT / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _write_pairs(tmp_path):
    """Three RGB images, a palette-mode one and a grey one (read as RGB),
    masks for all but one, and a mask without an image."""
    from PIL import Image

    rng = np.random.default_rng(0)
    img_dir, mask_dir = tmp_path / "images", tmp_path / "masks"
    img_dir.mkdir()
    mask_dir.mkdir()
    for i, mode in enumerate(["RGB", "RGB", "P", "L", "RGB"]):
        shape = (12 + i, 9 + 2 * i) + ((3,) if mode == "RGB" else ())
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).convert(mode).save(
            img_dir / f"{i:02d}.png")
        if i != 1:
            Image.fromarray(rng.integers(0, 256, shape[:2], dtype=np.uint8)).save(
                mask_dir / f"{i:02d}.png")
    Image.fromarray(np.zeros((4, 4), np.uint8)).save(mask_dir / "99.png")
    return str(img_dir), str(mask_dir)


def test_retina_dataset_matches_the_root_one(tmp_path):
    img_dir, mask_dir = _write_pairs(tmp_path)
    want = _root_module("data").RetinaDataset(img_dir, mask_dir)
    got = RetinaDataset(img_dir, mask_dir)
    assert len(got) == len(want) == 4
    for i in range(len(want)):
        for g, w in zip(got[i], want[i]):
            assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    assert got[0][0].shape == (3, 12, 9) and got[0][1].shape == (1, 12, 9)
    assert len(RetinaDataset(str(tmp_path / "none"), mask_dir)) == 0


@pytest.mark.parametrize("kind", ["probabilities", "masks"])
def test_dice_coeff_and_dice_bce_match_the_root_loss(kind):
    root = _root_module("loss")
    rng = np.random.default_rng(1)
    target = (rng.random((2, 1, 16, 16)) < 0.3).astype(np.float32)
    logits = rng.standard_normal((2, 1, 16, 16)).astype(np.float32)
    pred = (1 / (1 + np.exp(-logits)) if kind == "probabilities"
            else (logits > 0)).astype(np.float32)
    got = dice_coeff(torch.from_numpy(pred), torch.from_numpy(target)).item()
    want = float(root.dice_coeff(pred, target))
    assert abs(got - want) <= LOSS_TOL * (1 + abs(want)), (got, want)
    assert DICE_BCE_Loss is dice_bce_loss
    got = DICE_BCE_Loss(torch.from_numpy(logits), torch.from_numpy(target)).item()
    want = float(root.DICE_BCE_Loss(logits, target))
    assert abs(got - want) <= LOSS_TOL * (1 + abs(want)), (got, want)


def test_unet_matches_the_root_model():
    """The root `Unet()` (the JAX UNet with transposed-conv ups) and the
    port's with its weights: eval logits at 2x3x64x64; the port's model is
    built on the CPU because the test asks for it, and raises without a
    card otherwise."""
    jm = _root_module("model").Unet()
    assert not jm.bilinear and jm.num_classes == 1
    x = np.random.default_rng(2).standard_normal((2, 3, 64, 64)).astype(np.float32)
    tm = Unet(device="cpu")
    assert not tm.up1.bilinear
    check_eval(jm, tm, jax_variables(jm, x, seed=3), unet_pairs(False), x, LOGITS_TOL,
               "mini Unet")


def test_unet_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Unet()
