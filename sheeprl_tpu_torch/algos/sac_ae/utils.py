"""SAC-AE support utilities (counterparts of ``sheeprl_tpu/algos/sac_ae/utils.py``)."""

from __future__ import annotations

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/alpha_loss",
    "Loss/reconstruction_loss",
}
MODELS_TO_REGISTER = {"encoder", "decoder", "agent"}
