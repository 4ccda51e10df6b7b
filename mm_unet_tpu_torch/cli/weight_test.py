"""Parameters, FLOPs and throughput of the registry's models (counterpart of
the JAX package's root `weight_test.py`, the reference's
`weight_test.py:23-78`):

    python -m mm_unet_tpu_torch.cli.weight_test [--device cuda|cpu] [--models A B ...]

One line per model: its parameter count, the FLOPs of one forward at
batch 2, 3 x 352² (MM_Net at 384², `weight_test.py:22-23`), and the
images per second of six forwards in inference mode after one warm-up.
FLOPs are counted by `torch.utils.flop_counter.FlopCounterMode`, which
counts the matrix products and convolutions PyTorch runs (two per
multiply-add) and not the hand-written kernels, and so differs from the
JAX tool's XLA cost analysis: compare parameter counts with the JAX
package, not FLOPs. On the card the time is taken between synchronises.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

import torch
from torch.utils.flop_counter import FlopCounterMode

from mm_unet_tpu_torch.models import give_model

SIZE = 352
BATCH = 2
REPS = 6

# constructor arguments per model (`weight_test.py:25-42`); `_size` is the
# input size where 352 does not fit the model
ZOO = {
    "UNet": dict(num_classes=1),
    # MM_Net's slice scan needs (S/32)² % 8 == 0; 352 breaks it, as in the reference
    "MM_Net": dict(num_classes=1, remat=False, _size=384),
    "UM_Net": dict(num_classes=1),
    "TransUNet": dict(img_dim=SIZE, class_num=1),
    "CFPNet": dict(classes=1),
    "ConvUNeXt": dict(num_classes=1),
    "UNETR": dict(out_channels=1, img_size=SIZE),
    "SWINUNETR": dict(out_channels=1, use_checkpoint=False),
    "FCBFormer": dict(size=SIZE, num_class=1),
    "DuAT": dict(out_channels=1),
    "CFANet": dict(out_class=1),
    "PVT_CASCADE": dict(o_class=1),
    "CVC_UNETR": dict(out_channels=1),
    "BMANet": dict(out_channel=1),
}


def n_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def profile(name: str, kwargs: dict, device: torch.device | str = "cuda",
            reps: int = REPS) -> dict:
    """{"params", "flops", "images_per_sec", "size"} of one model, printed
    as one line."""
    kwargs = dict(kwargs)
    size = kwargs.pop("_size", SIZE)
    device = torch.device(device)
    model = give_model(name, device=device, generator=torch.Generator().manual_seed(0), **kwargs)
    x = torch.zeros(BATCH, 3, size, size, device=device)
    with torch.inference_mode():
        counter = FlopCounterMode(display=False)
        with counter:
            model(x)
        flops = counter.get_total_flops()
        model(x)  # warm-up
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            model(x)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rate = BATCH * reps / (time.perf_counter() - t0)
    out = {"params": n_params(model), "flops": flops, "images_per_sec": rate, "size": size}
    print(f"{name:14s} params {out['params'] / 1e6:8.2f}M  flops {flops / 1e9:10.2f}G  "
          f"throughput {rate:8.2f} img/s", flush=True)
    return out


def main(device: str = "cuda", names: Optional[Sequence[str]] = None) -> int:
    """Profile `names` (all of ZOO by default). A model that fails prints
    its error and the run goes on, as the JAX tool does; returns 1 if any
    failed."""
    failed = 0
    for name in names or ZOO:
        try:
            profile(name, ZOO[name], device)
        except Exception as e:  # noqa: BLE001 — one line per model, as the JAX tool
            print(f"{name:14s} FAILED: {e}", flush=True)
            failed += 1
    return int(failed > 0)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="Parameters, FLOPs and images/s of the registry's "
                                             "models at batch 2, 352².")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--models", nargs="*", help=f"a subset of {list(ZOO)}")
    args = ap.parse_args()
    sys.exit(main(args.device, args.models))
