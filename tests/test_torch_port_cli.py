"""The port's config-driven entry points and their utilities, on the CPU.

Against the JAX package: `ConfigDict` / `load_config` on config.yml, the
scalar tracker's `scalars.jsonl` and `tb_export` bytes, HD95 (random and
empty masks) and the metrics' `include_background`, and the config-driven
model kwargs. On their own: `GracefulShutdown`, the log tee,
`val_one_epoch`'s per-class entries, and a round trip of the three mains
(`device="cpu"`, a tiny MM_Net at 64² on `tests/fixtures/drive_mini`, the
test's directory as the working directory): train 2 epochs, resume to 3,
a SIGTERM stop of a fresh run, test and verify; then `python -m` with
`--device cpu`, and without it on a machine with no card.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn as nn

from mm_unet_tpu.models.registry import _model_kwargs as jax_model_kwargs
from mm_unet_tpu.train.metrics import HausdorffDistanceMetric as JHausdorffDistanceMetric
from mm_unet_tpu.train.metrics import build_metrics as jax_build_metrics
from mm_unet_tpu.utils import tracker as jax_tracker
from mm_unet_tpu.utils.config import load_config as jax_load_config
from mm_unet_tpu_torch.cli import test as cli_test
from mm_unet_tpu_torch.cli import train as cli_train
from mm_unet_tpu_torch.cli import verify as cli_verify
from mm_unet_tpu_torch.evaluate import val_one_epoch
from mm_unet_tpu_torch.models import give_model_from_config
from mm_unet_tpu_torch.models.registry import _model_kwargs
from mm_unet_tpu_torch.train.metrics import HausdorffDistanceMetric, build_metrics
from mm_unet_tpu_torch.train.trainer import make_loss_fn, seg_stats
from mm_unet_tpu_torch.utils import ConfigDict, GracefulShutdown, Logger, load_config
from mm_unet_tpu_torch.utils import tracker

ROOT = Path(__file__).resolve().parent.parent
DRIVE_MINI = ROOT / "tests" / "fixtures" / "drive_mini"
TINY_YAML = f"""
trainer:
  num_epochs: {{epochs}}
  warmup: 1
  lr: 0.001
  optimizer: adamw
  weight_decay: 0.05
  seed: 50
  resume: {{resume}}
  dataset_choose: DRIVE
dataset:
  DRIVE:
    data_root: {DRIVE_MINI}
    batch_size: 2
    image_size: 64
    image_mean: [0.485, 0.456, 0.406]
    image_std: [0.229, 0.224, 0.225]
finetune:
  checkpoint: {{name}}
  model_choose: MM_Net
models:
  MM_Net:
    branch1:
      num_classes: 1
      depths: [1, 1, 1, 1]
      num_slices_list: [4, 4, 4, 4]
      mamba_dtype: null
      sideout_drop: 0.0
"""


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads: these small CPU ops gain little from more, and
    the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny(path: Path, name="tiny", epochs=2, resume=False) -> Path:
    path.write_text(TINY_YAML.format(name=name, epochs=epochs, resume=str(resume).lower()))
    return path


# --- config, tracker, preemption, log tee -----------------------------------

def test_config_yml_loads_as_jax_does():
    got, want = load_config(str(ROOT / "config.yml")), jax_load_config(str(ROOT / "config.yml"))
    assert got == want and isinstance(got, ConfigDict)
    assert got.trainer.dataset_choose == want.trainer.dataset_choose == "DRIVE"
    assert got.dataset.DRIVE.image_mean == [0.485, 0.456, 0.406]
    c = ConfigDict({"a": [{"b": 1}], "t": ({"u": 2},)}, x={"y": 3})
    assert c.a[0].b == 1 and c.t[0].u == 2 and c.x.y == 3 and isinstance(c.t, tuple)
    c.z = {"w": 4}
    assert c.z.w == 4
    with pytest.raises(AttributeError):
        c.missing


def test_tracker_files_match_jax(tmp_path, monkeypatch):
    """The same scalars at the same clock give the same scalars.jsonl and
    TensorBoard events file, byte for byte."""
    events = [({"Train/total_loss": np.float32(0.5), "Train/dice_focal_loss": 0.25}, 0),
              ({"Val/mean f1": float("nan"), "note": "text"}, 1),
              ({"Train/images_per_sec": torch.tensor(3.5)}, 2**20)]
    paths = []
    for module, sub in ((tracker, "port"), (jax_tracker, "jax")):
        clock = iter(np.arange(1000.0, 2000.0, 0.25))
        monkeypatch.setattr(time, "time", lambda: float(next(clock)))
        tr = module.ScalarTracker(str(tmp_path / sub))
        for scalars, step in events:
            tr.log(scalars, step)
        tr.close()
        tb = module.tb_export(tr.path, str(tmp_path / sub / "tb"))
        paths.append((Path(tr.path), Path(tb)))
    (jsonl, tb), (jjsonl, jtb) = paths
    assert jsonl.read_bytes() == jjsonl.read_bytes()
    assert tb.read_bytes() == jtb.read_bytes() and tb.stat().st_size > 0
    assert tracker.read_scalars(str(jsonl))[2]["step"] == 2**20


def test_graceful_shutdown_flag():
    before = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    g = GracefulShutdown().install()
    try:
        assert not g.requested
        os.kill(os.getpid(), signal.SIGTERM)  # delivered before the next bytecode
        assert g.requested
        os.kill(os.getpid(), signal.SIGTERM)  # idempotent
        assert g.requested
        # a SIGINT after the first signal forces the stop: called directly, so
        # that the KeyboardInterrupt cannot land in a garbage-collector callback
        with pytest.raises(KeyboardInterrupt):
            g._handle(signal.SIGINT, None)
        assert signal.getsignal(signal.SIGINT) is before[signal.SIGINT]
    finally:
        g.uninstall()
    assert {s: signal.getsignal(s) for s in before} == before


def test_logger_tees_and_puts_back_the_streams(tmp_path, capsys):
    outer = Logger("outer", root=str(tmp_path))
    inner = Logger("inner", root=str(tmp_path))
    print("both")
    inner.close()
    print("outer only")
    outer.close()
    print("neither")
    assert capsys.readouterr().out == "both\nouter only\nneither\n"
    assert (Path(inner.dir) / "log.txt").read_text() == "both\n"
    assert (Path(outer.dir) / "log.txt").read_text() == "both\nouter only\n"


# --- metrics ------------------------------------------------------------------

def _masks(seed, shape, empty=()):
    rng = np.random.default_rng(seed)
    p = (rng.random(shape) < 0.3).astype(np.float32)
    t = (rng.random(shape) < 0.2).astype(np.float32)
    for which, n, c in empty:
        (p if which == "pred" else t)[n, c] = 0.0
    return p, t


@pytest.mark.parametrize("include_background", [True, False])
@pytest.mark.parametrize("empty", [(), (("pred", 0, 1),), (("label", 1, 1), ("pred", 1, 1))],
                         ids=["random", "empty_pred", "both_empty"])
def test_hd95_matches_jax(include_background, empty):
    got = HausdorffDistanceMetric(include_background, percentile=95)
    want = JHausdorffDistanceMetric(include_background, percentile=95)
    for i in range(2):
        p, t = _masks(i, (2, 2, 24, 20), empty if i == 0 else ())
        got(y_pred=p, y=t)
        want(y_pred=p, y=t)
    np.testing.assert_array_equal(np.asarray(got.vals), np.asarray(want.vals))
    np.testing.assert_array_equal(got.aggregate(), want.aggregate())
    if empty:
        assert np.isnan(got.vals).any()
    got.reset()
    assert got.vals == []


def test_hd95_of_all_empty_masks_is_nan():
    got, want = HausdorffDistanceMetric(), JHausdorffDistanceMetric()
    z = np.zeros((1, 1, 8, 8), np.float32)
    for m in (got, want):
        m(y_pred=z, y=z)
    with pytest.warns(RuntimeWarning):
        assert np.isnan(got.aggregate()).all() and np.isnan(want.aggregate()).all()


@pytest.mark.parametrize("feed", ["update", "update_stats"])
def test_metrics_without_background_match_jax(feed):
    """include_background=False drops channel 0 of multi-channel masks."""
    got, want = build_metrics(include_background=False), jax_build_metrics(False)
    for i in range(3):
        p, t = _masks(10 + i, (2, 3, 16, 16))
        if feed == "update_stats":
            logits = torch.from_numpy(np.where(p > 0, 1.0, -1.0).astype(np.float32))
            stats = {k: v.numpy() if isinstance(v, torch.Tensor) else v
                     for k, v in seg_stats(logits, torch.from_numpy(t)).items()}
        for m in (*got.values(), *want.values()):
            m(y_pred=p, y=t) if feed == "update" else m.update_stats(stats)
    for name, m in want.items():
        np.testing.assert_allclose(got[name].aggregate(), m.aggregate(), rtol=1e-12,
                                   equal_nan=True, err_msg=name)
        assert np.size(got[name].aggregate()) == (1 if name == "miou_metric" else 2)


def test_val_one_epoch_reports_each_edd_class():
    """`make_loss_fn`'s (total, losses) form, and with the EDD set's class
    names one entry per class beside the mean (`train.py:110-112`)."""
    classes = ("BE", "cancer", "HGD", "polyp", "suspicious")
    model = nn.Conv2d(3, 5, 1)
    torch.nn.init.normal_(model.weight, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    batches = [{"image": rng.standard_normal((2, 3, 16, 16)).astype(np.float32),
                "label": (rng.random((2, 5, 16, 16)) < 0.3).astype(np.float32)}]
    loss_fn = make_loss_fn({"dice_focal_loss": {}}, {"dice_focal_loss": 1.0})
    f1, metric, losses = val_one_epoch(model, loss_fn, lambda x, pred: pred(x), batches,
                                       build_metrics(), class_names=classes)
    want = build_metrics()
    logits = model(torch.from_numpy(batches[0]["image"]))
    preds = (torch.sigmoid(logits) > 0.5).float().detach().numpy()
    for m in want.values():
        m(y_pred=preds, y=batches[0]["label"])
    for name, m in want.items():
        agg = m.aggregate()
        assert metric[f"Val/mean {name}"] == pytest.approx(float(np.nanmean(agg)), nan_ok=True)
        if np.size(agg) == 5:
            for cls, v in zip(classes, agg):
                assert metric[f"Val/{cls} {name}"] == pytest.approx(float(v), nan_ok=True)
    assert "Val/polyp f1" in metric and f1 == metric["Val/mean f1"]
    want_loss = loss_fn(logits.detach(), torch.from_numpy(batches[0]["label"]))[0]
    assert losses == [pytest.approx(want_loss.item())]


# --- the config-driven model --------------------------------------------------

@pytest.mark.parametrize("dataset", ["DRIVE", "EDD_seg"])
def test_model_kwargs_match_jax(dataset):
    config, jconfig = (load(str(ROOT / "config.yml")) for load in (load_config, jax_load_config))
    config.trainer.dataset_choose = jconfig.trainer.dataset_choose = dataset
    for name in ("MM_Net", "UM_Net", "UNet", "dkDualNet", "UNETR", "TransUNet"):
        assert _model_kwargs(config, name) == jax_model_kwargs(jconfig, name), name


def test_give_model_from_config():
    config = load_config(str(ROOT / "config.yml"))
    config.models.MM_Net.branch1.update(depths=[1, 1, 1, 1], num_slices_list=[4, 4, 4, 4],
                                        out_indices=[0, 1, 2, 3])
    model = give_model_from_config(config, "cpu", torch.Generator().manual_seed(0))
    assert type(model).__name__ == "MM_Net" and not model.training
    assert len(model.encoder2) == 1 and model.num_slices_list == (4, 4, 4, 4)
    config.finetune.model_choose = "FRUNet"  # in neither package's registry
    with pytest.raises(NotImplementedError, match="not ported.*JAX package's registry lacks"):
        give_model_from_config(config, "cpu")
    if not torch.cuda.is_available():
        config.finetune.model_choose = "MM_Net"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            give_model_from_config(config)


def test_load_config_reads_config_yml_without_pyyaml(monkeypatch):
    """Where PyYAML is missing (the GPU machine), `load_config` reads
    config.yml and the tests' tiny config as `yaml.safe_load` does, and
    refuses YAML outside its subset."""
    import yaml

    from mm_unet_tpu_torch.utils.config import load_yaml_subset

    tiny = TINY_YAML.format(name="t", epochs=2, resume="false")
    for text in ((ROOT / "config.yml").read_text(), tiny, "a:\n  b: [1, 'x', 2.5, true, null, On, no, nO]\n  c:\n  d: 1e-3\n"):
        assert load_yaml_subset(text) == yaml.safe_load(text)
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml raises ImportError
    assert load_config(str(ROOT / "config.yml")) == yaml.safe_load((ROOT / "config.yml").read_text())
    for bad in ("a:\n  - 1\n", "a: {b: 1}\n", "a: |\n  text\n"):
        with pytest.raises(ValueError, match="not in the YAML subset"):
            load_yaml_subset(bad)


# the output head of each of config.yml's models
CONFIG_HEADS = {"MM_Net": "side2.conv2", "UM_Net": "final.4", "UNet": "outc.conv",
                "TransUNet": "decoder.conv1", "UNETR": "out", "SWINUNETR": "out",
                "FCBFormer": "PH.2", "ConvUNeXt": "out_conv.0", "CFPNet": "classifier.0.conv"}


@pytest.mark.parametrize("name", sorted(CONFIG_HEADS))
def test_give_model_from_config_builds_every_model_of_config_yml(name):
    """config.yml unchanged (DRIVE): each model of its `models:` builds and
    its head gives the section's `num_classes`, renamed to the model's own
    keyword; TransUNet takes the dataset's 512² (UNETR's section says 512
    itself). Build only: no forward."""
    config = load_config(str(ROOT / "config.yml"))
    assert set(config.models) == set(CONFIG_HEADS)
    config.finetune.model_choose = name
    model = give_model_from_config(config, "cpu", torch.Generator().manual_seed(0))
    head = dict(model.named_modules())[CONFIG_HEADS[name]]
    assert head.out_channels == config.models[name].branch1.num_classes == 1
    if name == "TransUNet":
        assert model.img_dim == 512
    if name == "UNETR":
        assert model.img_size == 512


def test_constructor_kwargs_rename_the_class_count_once():
    from mm_unet_tpu_torch.models.registry import _constructor_kwargs

    config = load_config(str(ROOT / "config.yml"))
    assert _constructor_kwargs(config, "CFPNet", {"num_classes": 3}) == {"classes": 3}
    assert _constructor_kwargs(config, "UNet", {"num_classes": 3}) == {"num_classes": 3}
    # a section that gives the model's own keyword is left alone
    assert (_constructor_kwargs(config, "FCBFormer", {"num_classes": 3, "num_class": 2})
            == {"num_classes": 3, "num_class": 2})
    assert _constructor_kwargs(config, "TransUNet", {"img_dim": 64}) == {"img_dim": 64}
    assert _constructor_kwargs(config, "DuAT", {"num_classes": 3}) == {"out_channels": 3}
    # each model's own class-count keyword, never an input count or a width
    for name, own in (("PVT_CASCADE", "o_class"), ("BMANet", "out_channel"),
                      ("CFANet", "out_class"), ("HWAUNETR", "out_chans"),
                      ("CVC_UNETR", "out_channels"), ("VANet", "num_class")):
        assert _constructor_kwargs(config, name, {"num_classes": 3}) == {own: 3}, name
    assert (_constructor_kwargs(config, "FRUNet", {"num_classes": 3}) == {"num_classes": 3})


@pytest.mark.parametrize("name, inputs", [("PVT_CASCADE", "n_class"), ("CFANet", "in_class"),
                                          ("HWAUNETR", "in_chans"), ("BMANet", "channel")])
def test_constructor_kwargs_leave_input_counts_and_widths(name, inputs):
    """PVT_CASCADE's `n_class`, CFANet's `in_class` and HWAUNETR's
    `in_chans` count input channels, BMANet's `channel` is its width: a
    section's values for them pass through, and `num_classes` goes to the
    class count alone."""
    from mm_unet_tpu_torch.models.registry import _CLASS_COUNT_KEYS, _constructor_kwargs

    config = load_config(str(ROOT / "config.yml"))
    assert inputs not in _CLASS_COUNT_KEYS
    got = _constructor_kwargs(config, name, {"num_classes": 2, inputs: 5})
    assert got[inputs] == 5 and 2 in got.values() and "num_classes" not in got


def test_constructors_cover_the_jax_registry():
    """The port builds every name the JAX package's registry holds (its 18,
    with ConvUNetXt beside ConvUNeXt and CVC_UNETR for the class
    CVC_Unetr)."""
    from mm_unet_tpu.models.registry import MODEL_REGISTRY, give_model as jax_give_model
    from mm_unet_tpu_torch.models.registry import _constructors

    jconfig = jax_load_config(str(ROOT / "config.yml"))
    jconfig.finetune.model_choose = "UNet"
    jax_give_model(jconfig)  # imports every model module, which registers it
    assert len(MODEL_REGISTRY) == 18
    assert sorted(_constructors()) == sorted(MODEL_REGISTRY)
    assert _constructors()["CVC_UNETR"].__name__ == "CVC_Unetr"


# --- the entry points ---------------------------------------------------------

def _events(prefix: str) -> list:
    (path,) = Path("logs").glob(f"{prefix}2*/scalars.jsonl")
    return tracker.read_scalars(str(path))


def _meta(name: str, tag: str) -> dict:
    return json.loads((Path("model_store") / name / f"{tag}_meta.json").read_text())


def test_entry_points_round_trip(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("MMU_SYNTH_N", raising=False)
    monkeypatch.setenv("MMU_CONFIG", str(_tiny(tmp_path / "tiny.yml")))

    # train 2 epochs (the config from MMU_CONFIG)
    assert cli_train.main(device="cpu") == 0
    out = capsys.readouterr().out
    assert out.count("Training [") == 4 and out.count("Validation [") == 4
    store = Path("model_store") / "tiny"
    assert sorted(p.name for p in store.iterdir()) == [
        "best", "best_meta.json", "checkpoint", "checkpoint_meta.json"]
    assert _meta("tiny", "checkpoint")["epoch"] == 2
    best = _meta("tiny", "best")
    assert set(best) == {"epoch", "best_acc", "best_class"}
    assert best["best_acc"] == best["best_class"]["Val/mean f1"] > 0
    events = _events("tiny")
    assert [e["step"] for e in events if "Train/total_loss" in e] == [0, 1, 2, 3]
    assert all(np.isfinite(e["Train/total_loss"]) for e in events if "Train/total_loss" in e)

    # resume to 3 epochs: epoch 3 only, from step 4, at the schedule's lr for it
    s = cli_train.setup(load_config(str(_tiny(tmp_path / "resume.yml", epochs=3, resume=True))),
                        "cpu")
    assert (s.starting_epoch, s.state.step) == (2, 4)
    saved = s.manager.read("checkpoint")
    assert all(torch.equal(v, saved["model"][k]) for k, v in s.state.model.state_dict().items())
    lrs = []
    s.state.optimizer.register_step_pre_hook(lambda o, a, k: lrs.append(o.param_groups[0]["lr"]))
    assert cli_train.fit(s) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("Epoch [")]
    assert lines and all(ln.startswith("Epoch [3/3]") for ln in lines)
    assert lrs == [s.state.schedule(4)] * 2 and s.state.step == 6
    assert _meta("tiny", "checkpoint")["epoch"] == 3

    # a SIGTERM after the first step of a fresh run: checkpoint of epoch 0, exit 0
    handlers = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}
    train_fn = cli_train.train_one_epoch

    def signalled(state, *args, **kwargs):
        def after_step(*_):
            hook.remove()
            threading.Timer(0.0, os.kill, (os.getpid(), signal.SIGTERM)).start()

        hook = state.optimizer.register_step_post_hook(after_step)
        monkeypatch.setattr(cli_train, "train_one_epoch", train_fn)
        return train_fn(state, *args, **kwargs)

    monkeypatch.setattr(cli_train, "train_one_epoch", signalled)
    config = load_config(str(_tiny(tmp_path / "stop.yml", name="stopped")))
    assert cli_train.main(config, "cpu") == 0
    out = capsys.readouterr().out
    assert "[preempt] checkpoint saved at epoch 0" in out and "Validation" not in out
    assert {sig: signal.getsignal(sig) for sig in handlers} == handlers
    assert _meta("stopped", "checkpoint") == {"epoch": 0, "best_acc": 0.0, "best_class": {}}
    assert not (Path("model_store") / "stopped" / "best").exists()
    assert 1 <= len([e for e in _events("stopped") if "Train/total_loss" in e]) <= 2

    # test: the best checkpoint's metrics as stored with it, and HD95
    assert cli_test.main(device="cpu") == 0
    out = capsys.readouterr().out
    assert "loaded best checkpoint for tiny" in out and "test: dice" in out
    got, best = _events("test_tiny")[-1], _meta("tiny", "best")["best_class"]
    for k, v in best.items():
        assert got[k] == pytest.approx(v, abs=1e-6), k
    assert "Val/mean hd95" in got

    # verify: one warm-up epoch from the best checkpoint, then validation
    assert cli_verify.main(device="cpu") == 0
    out = capsys.readouterr().out
    assert "loaded best checkpoint for tiny" in out and "verify: best dice" in out
    events = _events("verify_tiny")
    assert len([e for e in events if "Train/total_loss" in e]) == 2
    assert "Val/mean hd95" in events[-1]


def test_entry_points_run_as_modules(tmp_path):
    """`python -m mm_unet_tpu_torch.cli.test --device cpu` on a tiny
    MMU_CONFIG (no best checkpoint: it evaluates at init); without
    `--device cpu` and without a card it raises."""
    env = {**os.environ, "MMU_CONFIG": str(_tiny(tmp_path / "tiny.yml")),
           "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "2"}
    run = subprocess.run([sys.executable, "-m", "mm_unet_tpu_torch.cli.test", "--device", "cpu"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    assert "evaluating at init" in run.stdout and "test: dice" in run.stdout
    if not torch.cuda.is_available():
        (tmp_path / "no_card").mkdir()
        run = subprocess.run([sys.executable, "-m", "mm_unet_tpu_torch.cli.train"],
                             cwd=tmp_path / "no_card", env=env, capture_output=True, text=True,
                             timeout=600)
        assert run.returncode != 0 and "no CUDA device" in run.stderr
        assert not list((tmp_path / "no_card").iterdir())  # no model_store/, no logs/


def test_entry_points_import_no_jax_yaml_or_pil():
    code = (
        "import sys\n"
        "import mm_unet_tpu_torch.cli.train, mm_unet_tpu_torch.cli.test\n"
        "import mm_unet_tpu_torch.cli.verify, mm_unet_tpu_torch.train.checkpoint\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'flax', 'optax', 'orbax', 'mm_unet_tpu', 'yaml',\n"
        "                              'PIL')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300, cwd=ROOT)
