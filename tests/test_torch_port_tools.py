"""The port's last tools against the JAX package's, on the CPU:

- `data/volumetric.py` (its numpy copy): the NIfTI-1 reader on files the
  test writes (plain and gzipped, float32 and int16), the BraTS label
  conversion, the intensity normalisation, the pos/neg crops (padding a
  small volume), the flips and the intensity transforms under the same
  seeded generator, and a BraTS case directory, all equal to JAX's.
- `cli/visualize.py`: the error map and the contour overlay equal
  `visualization.py`'s; PNG files written with zlib read back byte for
  byte (grayscale and RGB, with the chunks' CRCs checked); `main` on a
  tiny synthetic run writes the three PNGs of each validation image.
- `cli/weight_test.py`: the parameter counts of UNet, CFPNet and
  ConvUNeXt equal the JAX models' (`jax.eval_shape` of their init; MM_Net's
  are held by `test_torch_port_checkpoint.py`'s manifest);
  FLOPs are counted differently (ROADMAP.md) and are not compared. One
  model's line on the CPU.
"""

import gzip
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mm_unet_tpu.models.cfpnet  # noqa: F401 (each module registers its JAX models)
import mm_unet_tpu.models.convunext  # noqa: F401
import mm_unet_tpu.models.unet  # noqa: F401
import visualization as jax_vis
from mm_unet_tpu.data import volumetric as JV
from mm_unet_tpu.models.registry import MODEL_REGISTRY
from mm_unet_tpu_torch.cli import visualize, weight_test
from mm_unet_tpu_torch.data import volumetric as V


def _write_nifti(path, data, datatype=16, dtype=np.float32):
    header = bytearray(352)
    struct.pack_into("<i", header, 0, 348)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", header, 40, *dim)
    struct.pack_into("<h", header, 70, datatype)
    struct.pack_into("<h", header, 72, 8 * np.dtype(dtype).itemsize)
    struct.pack_into("<f", header, 108, 352.0)
    payload = bytes(header) + np.asfortranarray(data.astype(dtype)).tobytes(order="F")
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(payload)


@pytest.mark.parametrize("name,datatype,dtype", [("a.nii.gz", 16, np.float32),
                                                 ("b.nii", 4, np.int16)])
def test_read_nifti_matches_jax(tmp_path, name, datatype, dtype):
    vol = (np.random.default_rng(0).standard_normal((5, 6, 7)) * 50).astype(dtype)
    _write_nifti(tmp_path / name, vol, datatype, dtype)
    got, want = V.read_nifti(str(tmp_path / name)), JV.read_nifti(str(tmp_path / name))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, vol.astype(np.float32))


def test_volumetric_transforms_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    lbl = rng.choice([0, 1, 2, 4], size=(12, 12, 12), p=[0.7, 0.1, 0.1, 0.1]).astype(np.float32)
    np.testing.assert_array_equal(V.convert_brats_labels(lbl), JV.convert_brats_labels(lbl))
    img = rng.standard_normal((4, 12, 12, 12)).astype(np.float32)
    img[:, :3] = 0
    for nonzero in (True, False):
        np.testing.assert_array_equal(V.normalize_intensity(img, nonzero),
                                      JV.normalize_intensity(img, nonzero))
    onehot = JV.convert_brats_labels(lbl)
    for roi in ((8, 8, 8), (16, 8, 8)):  # the second pads the volume
        got = V.rand_crop_pos_neg(np.random.default_rng(3), img, onehot, roi, num_samples=3)
        want = JV.rand_crop_pos_neg(np.random.default_rng(3), img, onehot, roi, num_samples=3)
        for (gi, gl), (wi, wl) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
    for fn, args in ((V.rand_flips_3d, (img, onehot)), (V.rand_intensity, (img,))):
        got = fn(np.random.default_rng(4), *args)
        want = getattr(JV, fn.__name__)(np.random.default_rng(4), *args)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(g, w)


def test_brats_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    case = tmp_path / "BraTS_001"
    case.mkdir()
    for m in V.BraTSDataset.MODALITIES:
        _write_nifti(case / f"BraTS_001_{m}.nii.gz", rng.standard_normal((6, 6, 6)))
    _write_nifti(case / "BraTS_001_seg.nii", rng.choice([0, 1, 2, 4], (6, 6, 6)).astype(np.float32))
    (tmp_path / "notes.txt").write_text("not a case")
    got, want = V.BraTSDataset(str(tmp_path)), JV.BraTSDataset(str(tmp_path))
    assert len(got) == len(want) == 1
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)


def test_error_map_and_contour_match_visualization():
    rng = np.random.default_rng(6)
    pred = (rng.random((20, 24)) < 0.4).astype(np.uint8)
    gt = (rng.random((20, 24)) < 0.4).astype(np.float32)
    np.testing.assert_array_equal(visualize.error_map(pred, gt), jax_vis.error_map(pred, gt))
    image = rng.random((20, 24, 3))
    np.testing.assert_array_equal(visualize.contour_overlay(image, pred),
                                  jax_vis.contour_overlay(image, pred))


def test_png_round_trip(tmp_path):
    rng = np.random.default_rng(7)
    for shape in ((9, 13), (9, 13, 3)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        path = str(tmp_path / f"{len(shape)}.png")
        visualize.write_png(path, img)
        np.testing.assert_array_equal(visualize.read_png(path), img)
    with open(path, "rb") as f:
        data = bytearray(f.read())
    data[40] ^= 0xFF  # inside the IDAT chunk
    with open(path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        visualize.read_png(path)
    with pytest.raises(ValueError):
        visualize.write_png(path, np.zeros((4, 4, 2), np.uint8))


def test_visualize_main_writes_pngs(tmp_path, monkeypatch):
    from mm_unet_tpu_torch.utils import ConfigDict

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    config = ConfigDict(
        trainer=dict(num_epochs=1, warmup=1, lr=1e-3, optimizer="adamw", weight_decay=0.05,
                     seed=50, dataset_choose="DRIVE"),
        dataset=dict(DRIVE=dict(data_root="", batch_size=2, image_size=64)),
        finetune=dict(checkpoint="vis", model_choose="MM_Net"),
        models=dict(MM_Net=dict(branch1=dict(num_classes=1, depths=[1, 1, 1, 1],
                                             num_slices_list=[4, 4, 4, 4], mamba_dtype=None))),
        visualization=dict(save_dir="vis_out"))
    assert visualize.main(config, "cpu") == 0
    for i in range(2):  # the synthetic validation set's two images
        for kind in ("mask", "error", "contour"):
            img = visualize.read_png(str(tmp_path / "vis_out" / f"{i}_{kind}.png"))
            assert img.shape[:2] == (64, 64)
            if kind == "mask":
                assert set(np.unique(img)) <= {0, 255}


def _jax_params(name, kwargs):
    kwargs = dict(kwargs)
    size = kwargs.pop("_size", 64)
    model = MODEL_REGISTRY[name](**kwargs)
    x = jnp.zeros((1, 3, size, size), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init({"params": jax.random.key(0),
                                                "dropout": jax.random.key(1)}, x))
    return sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(shapes["params"]))


@pytest.mark.parametrize("name", ["UNet", "CFPNet", "ConvUNeXt"])
def test_weight_test_parameter_counts_match_jax(name):
    kwargs = dict(weight_test.ZOO[name])
    port = weight_test.n_params(weight_test.give_model(
        name, device="cpu", **{k: v for k, v in kwargs.items() if k != "_size"}))
    assert port == _jax_params(name, kwargs)


def test_weight_test_profiles_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(weight_test, "SIZE", 64)
    out = weight_test.profile("CFPNet", {"classes": 1}, "cpu", reps=1)
    assert out["params"] > 0 and out["flops"] > 0 and out["images_per_sec"] > 0
    assert "CFPNet" in capsys.readouterr().out
    assert weight_test.main("cpu", ["nope"]) == 1  # an unknown model: its line says FAILED
