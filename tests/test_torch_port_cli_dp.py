"""The training entry point under data parallelism, on the CPU: each rank
runs `cli.train` in a process of its own with the environment torchrun
gives it (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and
`--device cpu`, so it joins a gloo group through `parallel.mesh.
init_data_parallel`; each rank works in a directory of its own. A tiny
MM_Net at 64², batch 2, on a synthetic set of 4 images (one epoch of two
steps, then validation over two images).

- Two ranks log the one-process run's step losses: the first within 1e-5,
  the second within 2e-3 (after an AdamW step MM_Net's f32 trajectory is
  chaotic, `test_torch_port_dp.py`); rank 0 alone writes `logs/` (the tee
  and `scalars.jsonl`) and `model_store/`, with ZeRO-1 on (the default at
  more than one rank).
- A SIGTERM that reaches rank 1 after its first step stops both ranks at
  the next step boundary: both return 0 after one step, and rank 0 saves
  the preemption checkpoint of epoch 0.
"""

import json
import socket
from pathlib import Path

import pytest

from test_torch_port_ranks import cli_worker, run_ranks

YAML = """
trainer:
  num_epochs: 1
  warmup: 1
  lr: 0.001
  optimizer: adamw
  weight_decay: 0.05
  seed: 50
  dataset_choose: DRIVE
dataset:
  DRIVE:
    data_root: ""
    batch_size: 2
    image_size: 64
    image_mean: [0.485, 0.456, 0.406]
    image_std: [0.229, 0.224, 0.225]
finetune:
  checkpoint: {name}
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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(tmp_path, name, world, sigterm_rank=None):
    """(each rank's result, each rank's directory) of a run at `world`
    ranks (0: one process without torchrun's environment)."""
    cfg = tmp_path / f"{name}.yml"
    cfg.write_text(YAML.format(name=name))
    n = max(world, 1)
    dirs = [tmp_path / f"{name}_rank{r}" for r in range(n)]
    for d in dirs:
        d.mkdir()
    port = str(_free_port())
    envs = [{"MMU_SYNTH_N": "4"} if world == 0 else
            {"MMU_SYNTH_N": "4", "RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": str(world),
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port} for r in range(n)]
    out = run_ranks(n, cli_worker, tmp_path, [str(d) for d in dirs], str(cfg), sigterm_rank,
                    init=False, envs=envs)
    return out, dirs


def _scalars(d: Path) -> list:
    (run,) = (d / "logs").iterdir()
    return [json.loads(line) for line in (run / "scalars.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    out, dirs = _run(tmp_path_factory.mktemp("one"), "dp_cli", 0)
    assert out[0]["rc"] == 0 and out[0]["world"] is None and out[0]["step"] == 2
    return [e["Train/total_loss"] for e in _scalars(dirs[0]) if "Train/total_loss" in e]


def test_cli_train_two_ranks_match_one_process(tmp_path, one_process):
    out, dirs = _run(tmp_path, "dp_cli", 2)
    assert [(o["rc"], o["world"], o["step"], o["stopped"]) for o in out] == [(0, 2, 2, False)] * 2
    losses = [e["Train/total_loss"] for e in _scalars(dirs[0]) if "Train/total_loss" in e]
    assert len(losses) == len(one_process) == 2
    assert losses[0] == pytest.approx(one_process[0], rel=1e-5)
    assert losses[1] == pytest.approx(one_process[1], rel=2e-3)
    store = dirs[0] / "model_store" / "dp_cli"
    assert (store / "checkpoint").is_file() and (store / "checkpoint_meta.json").is_file()
    assert json.loads((store / "checkpoint_meta.json").read_text())["epoch"] == 1
    assert not (dirs[1] / "logs").exists() and not (dirs[1] / "model_store").exists()


def test_cli_train_sigterm_to_one_rank_stops_both(tmp_path):
    out, dirs = _run(tmp_path, "dp_preempt", 2, sigterm_rank=1)
    assert [(o["rc"], o["step"], o["stopped"]) for o in out] == [(0, 1, True)] * 2
    store = dirs[0] / "model_store" / "dp_preempt"
    assert json.loads((store / "checkpoint_meta.json").read_text())["epoch"] == 0
    assert not (store / "best").exists()
    steps = [e for e in _scalars(dirs[0]) if "Train/total_loss" in e]
    assert len(steps) == 1
    assert not (dirs[1] / "logs").exists() and not (dirs[1] / "model_store").exists()
