"""Parallelism over `torch.distributed` (counterpart of
`mm_unet_tpu/parallel/`): data parallelism with ZeRO-1 (`mesh`, `zero`),
and the extensions beyond the reference: the sequence-parallel scan
(`sp`), Megatron tensor parallelism of the Mamba mixer (`tp`), GPipe
pipelining (`pp`) and Switch expert parallelism (`ep`).

The JAX package's names and their counterparts here: `make_mesh` ->
`init_data_parallel` (a process per card, under torchrun) and
`DataParallel`; `shard_batch`; `replicate` -> `DataParallel.replicate`;
`shard_params`, `tp_param_specs`, `MAMBA_TP_RULES`; `shard_opt_state` ->
`ZeroAdamW` (`is_flat_adamw_state` belongs to the flat AdamW layout, which
the port does not have); `selective_scan_sp`; `pipeline_apply`,
`stack_layer_params` -> `stage_layers`, `make_stage_fn`,
`mixer_pipeline_forward`; `SwitchFFN`, `shard_moe_params`,
`ep_param_specs`.
"""

from mm_unet_tpu_torch.parallel.ep import SwitchFFN, ep_param_specs, shard_moe_params
from mm_unet_tpu_torch.parallel.mesh import DataParallel, init_data_parallel, shard_batch
from mm_unet_tpu_torch.parallel.pp import (
    make_stage_fn,
    mixer_pipeline_forward,
    pipeline_apply,
    stage_layers,
)
from mm_unet_tpu_torch.parallel.sp import selective_scan_sp
from mm_unet_tpu_torch.parallel.tp import MAMBA_TP_RULES, shard_params, tp_param_specs
from mm_unet_tpu_torch.parallel.zero import ZeroAdamW

__all__ = [
    "init_data_parallel", "DataParallel", "shard_batch",
    "shard_params", "tp_param_specs", "MAMBA_TP_RULES",
    "ZeroAdamW",
    "selective_scan_sp",
    "pipeline_apply", "stage_layers", "make_stage_fn", "mixer_pipeline_forward",
    "SwitchFFN", "shard_moe_params", "ep_param_specs",
]
