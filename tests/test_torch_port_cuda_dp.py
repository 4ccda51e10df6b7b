"""The training entry point data parallel over every card of the machine,
through torchrun, against one process on one card. Marked `cuda`: it
decides inside itself whether there are at least two cards and skips
otherwise (one card holds one NCCL rank). No JAX here:

    python -m pytest --noconftest -q -s tests/test_torch_port_cuda_dp.py

MM_Net at full width in f32 (remat on), 512², a global batch of 2 per
card on a synthetic set of two batches, one epoch: `python -m
torch.distributed.run --standalone --nproc_per_node=N -m
mm_unet_tpu_torch.cli.train` (NCCL, ZeRO-1) against `python -m
mm_unet_tpu_torch.cli.train` with one card visible, both with TF32 off
(`NVIDIA_TF32_OVERRIDE=0`): cuDNN picks its convolution algorithms by the
batch each process sees, and in bf16 or TF32 two algorithms round apart
(the bf16 model's first loss read 1.4e-3 apart at 4 cards). The first
step's loss within 1e-4 (the same arithmetic but BatchNorm's moments
summed over the ranks and the convolutions' algorithms), the second
within 2e-2 (after an AdamW step the trajectory is chaotic:
`chip_smoke.py`'s DP_LOSS_TOL); rank 0 alone writes `logs/` and
`model_store/`. It prints both runs' losses and train images/s.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
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
    batch_size: {batch}
    image_size: 512
finetune:
  checkpoint: dp_cards
  model_choose: MM_Net
models:
  MM_Net:
    branch1:
      num_classes: 1
      mamba_dtype: null
"""


def _run(cmd, cwd: Path, env: dict) -> list:
    cwd.mkdir()
    out = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    (run,) = (cwd / "logs").iterdir()  # one run directory: rank 0's alone
    assert (cwd / "model_store" / "dp_cards" / "checkpoint").is_file()
    return [json.loads(line) for line in (run / "scalars.jsonl").read_text().splitlines()]


@pytest.mark.cuda
def test_entry_point_data_parallel_on_every_card(tmp_path):
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two or more CUDA devices (one card holds one NCCL rank)")
    cfg = tmp_path / "dp.yml"
    cfg.write_text(YAML.format(batch=2 * n))
    env = {**os.environ, "MMU_CONFIG": str(cfg), "MMU_SYNTH_N": str(4 * n),
           "PYTHONPATH": str(ROOT), "NVIDIA_TF32_OVERRIDE": "0"}
    env.pop("WORLD_SIZE", None)
    one = _run([sys.executable, "-m", "mm_unet_tpu_torch.cli.train"], tmp_path / "one",
               {**env, "CUDA_VISIBLE_DEVICES": "0"})
    multi = _run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                  f"--nproc_per_node={n}", "-m", "mm_unet_tpu_torch.cli.train"],
                 tmp_path / "multi", env)
    losses = [[e["Train/total_loss"] for e in r if "Train/total_loss" in e] for r in (one, multi)]
    rates = [[e["Train/images_per_sec"] for e in r if "Train/images_per_sec" in e]
             for r in (one, multi)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print("cuda_dp " + json.dumps({"cards": n, "card": smi.strip().splitlines(),
                                   "losses": losses, "train_images_per_sec": rates}))
    assert len(losses[0]) == len(losses[1]) == 2
    assert losses[1][0] == pytest.approx(losses[0][0], rel=1e-4)
    assert losses[1][1] == pytest.approx(losses[0][1], rel=2e-2)
