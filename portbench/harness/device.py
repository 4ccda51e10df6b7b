"""The card a run uses: the check that it is there, its name and power
limit, the caches kept inside the checkout, and the check that nothing of
the JAX package was loaded."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

from harness.spec import ROOT

# top-level module names the port's runs must never load
FORBIDDEN = ("jax", "jaxlib", "flax", "mm_unet_tpu")
CACHE_DIR = ROOT / "build" / "portbench"


class NoCard(SystemExit):
    pass


def fix_caches() -> None:
    """Kernel caches at fixed paths inside the checkout. The port builds its
    kernels into build/kernels/ itself; these cover what PyTorch would
    build or compile on its own."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE_DIR / sub)


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoCard("portbench: no CUDA device; the benchmark runs on the card only")
    if torch.cuda.device_count() < n:
        raise NoCard(f"portbench: the cell needs {n} cards, {torch.cuda.device_count()} found")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (mm_unet_tpu_torch is not mm_unet_tpu)."""
    return sorted(m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN)


def card(count: int = 1) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}
    smi = shutil.which("nvidia-smi")
    if smi:
        out = subprocess.run([smi, "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        info["power_limit"] = out.stdout.strip().splitlines()[0] if out.stdout.strip() else None
    return info
