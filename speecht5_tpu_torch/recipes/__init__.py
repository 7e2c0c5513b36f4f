"""The sibling families' recipes (the port's copies of the JAX package's
``recipes/speechlm_ctc_finetune.py``, ``recipes/speechut_joint_pretrain.py``
and ``recipes/speech2c_pretrain.py``): each runs as ``python -m
speecht5_tpu_torch.recipes.<name> [--steps N] [--device cuda|cpu]`` and
has a ``run(cfg, ...)`` that ``chip_smoke.py`` calls at Base width."""
