"""A2C support utilities (counterparts of ``sheeprl_tpu/algos/a2c/utils.py``):
the observation and test machinery is PPO's."""

from sheeprl_tpu_torch.algos.ppo.utils import (  # noqa: F401
    AGGREGATOR_KEYS,
    actions_for_env,
    prepare_obs,
    spaces_to_dims,
    test,
)
