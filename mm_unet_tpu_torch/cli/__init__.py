"""The config-driven entry points (counterparts of the JAX package's root
`train.py`, `test.py` and `verify.py`), each a module run as

    python -m mm_unet_tpu_torch.cli.<train|test|verify> [--device cuda|cpu]

They read `config.yml`, or the file named by `MMU_CONFIG`, or take a
`ConfigDict` when called as `main(config, device)`, and write
`model_store/<finetune.checkpoint>/` and `logs/` under the working
directory. They run on the card unless asked for the CPU.
"""
