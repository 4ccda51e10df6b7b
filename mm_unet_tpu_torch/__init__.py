"""MM-UNet in PyTorch for NVIDIA Hopper (H100, sm_90a).

A port of `mm_unet_tpu` (JAX/Flax/Pallas), which stays beside it as the
reference. The package mirrors the reference's module paths:

- ``mm_unet_tpu_torch.ops``    — plain PyTorch ops and the hand-written
  CUDA kernels, forward and backward, of the fused Mamba scan
  (`mamba_fused`) and the morph-0 tap-conv (`tap_conv`), whose sources live
  in ``csrc/`` and are built by ``_build`` at first use.
- ``mm_unet_tpu_torch.models`` — `MM_Net`, `dkDualNet` and `UM_Net` (eval
  and train mode) and their blocks, with the reference's torch module and
  parameter names.
- ``mm_unet_tpu_torch.train``  — the loss registry, AdamW and its schedule,
  the train step and epoch, sliding-window inference, the predictor, the
  metrics (HD95 among them) and checkpoints.
- ``mm_unet_tpu_torch.evaluate`` — the validation loop.
- ``mm_unet_tpu_torch.data`` and ``mm_unet_tpu_torch.runtime`` — the
  dataset loaders and transforms (numpy), the synthetic set, and the native
  C++ batch prep (g++, ``ctypes``).
- ``mm_unet_tpu_torch.cli`` — the config-driven entry points ``train``,
  ``test`` and ``verify`` (``python -m mm_unet_tpu_torch.cli.<name>``).
- ``mm_unet_tpu_torch.utils`` — the config, seeding, the log tee,
  preemption, the scalar tracker, and JAX variables (and gradients) ->
  torch names and layouts (``convert``).

Importing the package imports nothing but the standard library; the
submodules import torch and never jax.
"""

__version__ = "0.1.0"
