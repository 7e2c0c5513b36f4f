"""The sibling families' recipes (the port's copies of the JAX package's
``recipes/speechlm_ctc_finetune.py``, ``recipes/speechut_joint_pretrain.py``,
``recipes/speech2c_pretrain.py``, ``recipes/yitrans_pretrain_finetune.py``,
``recipes/vatlm_pretrain.py``, ``recipes/wavllm_sft.py``,
``recipes/speech2s_s2st.py``, ``recipes/vallex_tts.py``,
``recipes/viola_multitask.py`` and ``recipes/prosody_tts.py``): each runs
as ``python -m
speecht5_tpu_torch.recipes.<name> [--device cuda|cpu]`` with its step
flags and has a ``run(cfg, ...)`` that ``chip_smoke.py`` calls at Base
width (YiTrans' also its stages: ``pretrain``, ``finetune``,
``decoder_for``; the S2ST chain also ``decode_units``)."""
