"""DreamerV2 utilities (counterpart of ``sheeprl_tpu/algos/dreamer_v2/utils.py``)."""

#: the sub-models of a snapshot that ``cli.registration`` registers
MODELS_TO_REGISTER = {"world_model", "actor", "critic", "target_critic"}
