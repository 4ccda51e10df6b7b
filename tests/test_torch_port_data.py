"""The port's synthetic data and numpy metrics against the JAX package's.

`mm_unet_tpu_torch.data.make_synthetic` must give the same images and
labels as `mm_unet_tpu.data.loaders.make_synthetic` for the same seed (exact
equality), and `synthetic_batch` their config.yml:25-26 normalisation.
`mm_unet_tpu_torch.train.metrics` must aggregate to what
`mm_unet_tpu.train.metrics` gives for the same masks, through `update` and
through `update_stats` (tolerance 1e-12 relative: the same float64 sums,
computed from different intermediate counts). Neither they nor
`chip_smoke.py` import JAX or the JAX package.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mm_unet_tpu.data.loaders import make_synthetic as jax_make_synthetic
from mm_unet_tpu.train.metrics import build_metrics as jax_build_metrics
from mm_unet_tpu_torch.data import make_synthetic, synthetic_batch
from mm_unet_tpu_torch.train.metrics import build_metrics
from mm_unet_tpu_torch.train.trainer import seg_stats


@pytest.mark.parametrize("n,hw,seed", [(2, 32, 0), (3, 48, 7)])
def test_make_synthetic_matches_jax(n, hw, seed):
    images, labels = make_synthetic(n, hw, seed)
    want = jax_make_synthetic(n, hw, seed=seed)
    assert len(images) == len(labels) == n
    for got, ref in zip(images + labels, want.images + want.labels):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def test_synthetic_batch_normalises_like_config():
    batch = synthetic_batch(2, 32, seed=3)
    want = jax_make_synthetic(2, 32, seed=3)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    img = ((np.stack(want.images) - mean) / std).transpose(0, 3, 1, 2)
    assert batch["image"].dtype == batch["label"].dtype == np.float32
    assert batch["image"].shape == (2, 3, 32, 32) and batch["label"].shape == (2, 1, 32, 32)
    np.testing.assert_array_equal(batch["image"], img)
    np.testing.assert_array_equal(batch["label"][:, 0], np.stack(want.labels))


def _masks(seed, n_batches, B, C, hw):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        p = (rng.random((B, C, hw, hw)) < 0.3).astype(np.float32)
        t = (rng.random((B, C, hw, hw)) < 0.2).astype(np.float32)
        if i == 0:
            p[0], t[0] = 0.0, 0.0  # an empty sample: Dice and IoU 0/0
        out.append((p, t))
    return out


def _assert_same(got_metrics, want_metrics):
    assert set(got_metrics) == set(want_metrics)
    for name, m in want_metrics.items():
        want = np.asarray(m.aggregate())
        got = np.asarray(got_metrics[name].aggregate())
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, equal_nan=True, err_msg=name)


@pytest.mark.parametrize("C", [1, 2])
def test_metrics_update_match_jax(C):
    got, want = build_metrics(), jax_build_metrics()
    for p, t in _masks(1, 3, 2, C, 16):
        for m in (*got.values(), *want.values()):
            m(y_pred=p, y=t)
    _assert_same(got, want)
    for m in got.values():  # reset empties the epoch
        m.reset()
        assert not m.rows


def test_metrics_update_stats_match_jax():
    """From `seg_stats` of logits, with a per-sample weight that drops a
    padded sample, as the training loop feeds them."""
    got, want = build_metrics(), jax_build_metrics()
    rng = np.random.default_rng(2)
    for i in range(3):
        logits = torch.from_numpy(rng.standard_normal((3, 1, 16, 16)).astype(np.float32))
        labels = torch.from_numpy((rng.random((3, 1, 16, 16)) < 0.3).astype(np.float32))
        weight = torch.tensor([1.0, 1.0, 0.0 if i == 1 else 1.0])
        stats = {k: v.numpy() if isinstance(v, torch.Tensor) else v
                 for k, v in seg_stats(logits, labels, weight).items()}
        for m in (*got.values(), *want.values()):
            m.update_stats(stats)
    _assert_same(got, want)


def test_data_and_metrics_never_import_the_jax_package():
    code = (
        "import sys\n"
        "import mm_unet_tpu_torch.data, mm_unet_tpu_torch.train.metrics\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'flax', 'optax', 'mm_unet_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)


def test_chip_smoke_imports_nothing_of_jax_or_the_jax_package():
    """Every import statement of chip_smoke.py, at any depth (its phases
    import inside functions)."""
    tree = ast.parse((Path(__file__).resolve().parent.parent / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "mm_unet_tpu_torch.data" in names
    bad = [n for n in names if n.split(".")[0] in ("jax", "flax", "optax", "mm_unet_tpu")]
    assert not bad, bad
