"""The port's data pipeline against the JAX package's, on the CPU.

`mm_unet_tpu_torch.data.get_dataloader` must give exactly the batches of
`mm_unet_tpu.data.get_dataloader` for the same config and seed (images,
labels and paths, over two epochs, train and val), on the native C++
pipeline and on the numpy one (each package's `runtime.get_lib` patched to
None): on `tests/fixtures/drive_mini` (the file path, CLAHE off and on),
on the synthetic set, and on the polyp sets' branch (synthetic, and a
directory of files, with the colour exchange). Each transform equals its
JAX counterpart on the same inputs and generator state, the port's native
library equals the JAX package's, and its batches equal the numpy
pipeline's where the two compute the same thing (eval batches; the JAX
package's `tests/test_runtime.py` tolerance, 1e-5).
"""

import shutil
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from mm_unet_tpu import runtime as jax_runtime
from mm_unet_tpu.data import get_dataloader as jax_get_dataloader
from mm_unet_tpu.data import transforms as JT
from mm_unet_tpu.data.loaders import pair_directory as jax_pair_directory
from mm_unet_tpu_torch import runtime
from mm_unet_tpu_torch.data import get_dataloader
from mm_unet_tpu_torch.data import transforms as T
from mm_unet_tpu_torch.data.loaders import pair_directory
from mm_unet_tpu_torch.utils import ConfigDict

DRIVE_MINI = Path(__file__).resolve().parent / "fixtures" / "drive_mini"


def _config(name, root, size=64, batch=2, **extra):
    return ConfigDict(
        trainer=dict(seed=50, dataset_choose=name, train_ratio=0.5),
        dataset={name: dict(data_root=str(root), batch_size=batch, image_size=size,
                            image_mean=[0.485, 0.456, 0.406],
                            image_std=[0.229, 0.224, 0.225], **extra)},
    )


@pytest.fixture(params=["native", "numpy"])
def pipeline(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(runtime, "get_lib", lambda: None)
        monkeypatch.setattr(jax_runtime, "get_lib", lambda: None)
    elif runtime.get_lib() is None or jax_runtime.get_lib() is None:
        pytest.skip("no C++ toolchain here")
    return request.param


def _polyp_dir(tmp_path):
    """A CVC-ClinicDB-style directory: images/ and masks/ of the same names,
    from drive_mini's files."""
    for sub in ("images", "masks"):
        (tmp_path / sub).mkdir()
    for phase, pattern in (("train", "{}.png"), ("val", "{}_manual1.png")):
        for img in sorted((DRIVE_MINI / phase / "input").iterdir()):
            mask = DRIVE_MINI / phase / "label" / pattern.format(img.stem)
            if mask.exists():
                shutil.copy(img, tmp_path / "images" / img.name)
                shutil.copy(mask, tmp_path / "masks" / img.name)
    return tmp_path


CASES = {
    "drive_mini": lambda tmp: _config("DRIVE", DRIVE_MINI),
    "drive_mini_clahe": lambda tmp: _config("DRIVE", DRIVE_MINI, clahe=True),
    "drive_mini_augmented": lambda tmp: _config("DRIVE", DRIVE_MINI, cut_mix=True,
                                                color_jitter=True, resized_crop=True),
    "synthetic": lambda tmp: _config("DRIVE", "", size=32, batch=4),
    "polyp_synthetic": lambda tmp: _config("Kvasir_SEG", "", size=32, batch=4),
    "polyp_files": lambda tmp: _config("CVC_ClinicDB", _polyp_dir(tmp), batch=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_loaders_give_the_jax_batches(case, pipeline, tmp_path):
    config = CASES[case](tmp_path)
    got, want = get_dataloader(config), jax_get_dataloader(config)
    for loader, ref in zip(got, want):
        assert len(loader) == len(ref) and len(loader.ds) == len(ref.ds) > 0
        for epoch in range(2):
            batches, ref_batches = list(loader), list(ref)
            assert len(batches) == len(ref_batches) == len(ref)
            for b, r in zip(batches, ref_batches):
                for k in ("image", "label"):
                    assert b[k].dtype == r[k].dtype == np.float32
                    np.testing.assert_array_equal(b[k], r[k], err_msg=f"{case} epoch {epoch} {k}")
                assert b["paths"] == r["paths"]
        # the colour exchange and EDD masks always take the numpy pipeline
        numpy_only = case.startswith("polyp") and loader.train
        assert loader.pipeline == ("numpy" if numpy_only else pipeline)


def test_pair_directory_matches_jax():
    for phase, pattern in (("train", "{base_name}.png"), ("val", "{base_name}_manual1.png"),
                           ("val", "{base_name}.png")):
        args = (str(DRIVE_MINI / phase), "input", "label", pattern)
        assert pair_directory(*args) == jax_pair_directory(*args)


def _img(rng, h=24, w=20):
    return rng.random((h, w, 3)).astype(np.float32)


def _lbl(rng, h=24, w=20):
    return (rng.random((h, w)) > 0.7).astype(np.float32)


# name -> fn(module, rng) applying the transform to seeded inputs
TRANSFORMS = {
    "resize_image": lambda M, rng: M.resize_image(_img(rng), (17, 31)),
    "resize_image_nearest": lambda M, rng: M.resize_image(_lbl(rng), (40, 9), nearest=True),
    "center_padding": lambda M, rng: M.center_padding(_img(rng), 33, 29),
    "random_flips": lambda M, rng: M.random_flips(rng, _img(rng), _lbl(rng)),
    "cut_mix": lambda M, rng: M.cut_mix(rng, _img(rng), _lbl(rng), _img(rng), _lbl(rng)),
    "lab_color_exchange": lambda M, rng: M.lab_color_exchange(rng, _img(rng), _img(rng)),
    "normalize": lambda M, rng: M.normalize(_img(rng), [0.4, 0.5, 0.6], [0.2, 0.3, 0.1]),
    "to_nchw": lambda M, rng: M.to_nchw(_img(rng)),
    "clahe": lambda M, rng: M.clahe(_img(rng, 40, 36)),
    "random_resized_crop": lambda M, rng: M.random_resized_crop(rng, _img(rng), _lbl(rng), 16),
    "color_jitter": lambda M, rng: M.color_jitter(rng, _img(rng)),
    "gaussian_blur": lambda M, rng: M.gaussian_blur(rng, _img(rng)),
    "random_patch": lambda M, rng: M.random_patch(rng, _img(rng), _lbl(rng), 12),
    "random_patch_padded": lambda M, rng: M.random_patch(rng, _img(rng, 8, 10),
                                                         _lbl(rng, 8, 10), 12),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transform_matches_jax(name):
    got = TRANSFORMS[name](T, np.random.default_rng(3))
    want = TRANSFORMS[name](JT, np.random.default_rng(3))
    got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def lib():
    if runtime.get_lib() is None or jax_runtime.get_lib() is None:
        pytest.skip("no C++ toolchain here")
    return runtime.get_lib()


def test_native_library_builds_outside_the_package(lib):
    path = runtime.library_path()
    assert path.exists() and path.parent.name == "runtime" and path.parent.parent.name == "build"
    assert not list(Path(runtime.__file__).parent.glob("*.so"))


@pytest.mark.parametrize("train", [False, True])
def test_native_batches_match_the_jax_library(lib, train):
    rng = np.random.default_rng(4)
    images = [_img(rng, 40, 48) for _ in range(3)]
    labels = [_lbl(rng, 40, 48) for _ in range(3)]
    kwargs = dict(seed=5, epoch=1, train=train, color_jitter=train, gaussian_blur=train,
                  resized_crop=train, patch=24 if train else 0,
                  cutmix_donor_images=images[::-1] if train else None,
                  cutmix_donor_labels=labels[::-1] if train else None)
    got = runtime.prepare_batch(images, labels, np.arange(3), 32, [0.4] * 3, [0.2] * 3, **kwargs)
    want = jax_runtime.prepare_batch(images, labels, np.arange(3), 32, [0.4] * 3, [0.2] * 3,
                                     **kwargs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for fn in ("resize_bilinear", "resize_nearest"):
        np.testing.assert_array_equal(getattr(runtime, fn)(images[0], 17, 53),
                                      getattr(jax_runtime, fn)(images[0], 17, 53))


def test_native_eval_batch_matches_numpy(lib):
    """Eval batches (no resize): normalisation and layout, native vs numpy."""
    rng = np.random.default_rng(2)
    images = [_img(rng, 16, 16) for _ in range(3)]
    labels = [_lbl(rng, 16, 16) for _ in range(3)]
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    out_img, out_lbl = runtime.prepare_batch(images, labels, np.arange(3), 16, mean, std,
                                             seed=0, epoch=0, train=False)
    for i in range(3):
        want = T.to_nchw(T.normalize(images[i], mean, std))
        np.testing.assert_allclose(out_img[i], want, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(out_lbl[i, 0], labels[i])


def test_prefetch_thread_stops_when_the_consumer_does():
    """A preemption breaks the epoch after one batch: the loader's thread
    must end, not block on its queue."""
    train, _ = get_dataloader(_config("DRIVE", "", size=32, batch=1))
    before = threading.active_count()
    it = iter(train)
    next(it)
    assert threading.active_count() == before + 1
    it.close()
    assert threading.active_count() == before
    assert len(list(train)) == len(train) == 8  # the next epoch runs whole


def test_data_modules_never_import_jax_yaml_or_pil():
    code = (
        "import sys\n"
        "import mm_unet_tpu_torch.data, mm_unet_tpu_torch.runtime\n"
        "import mm_unet_tpu_torch.data.loaders, mm_unet_tpu_torch.data.transforms\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'flax', 'optax', 'mm_unet_tpu', 'yaml', 'PIL')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300,
                   cwd=Path(__file__).resolve().parent.parent)
