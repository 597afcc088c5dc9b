"""DreamerV1 utilities (counterpart of ``sheeprl_tpu/algos/dreamer_v1/utils.py``)."""

#: the sub-models of a snapshot that ``cli.registration`` registers
MODELS_TO_REGISTER = {"world_model", "actor", "critic"}
