#!/usr/bin/env python3
"""How far one ulp of the starting weights moves a PPO train phase, under
SGD and under the recipe's Adam, on the CPU alone.

The phase is the one ``chip_smoke.py`` phase 17 holds the card to the CPU
with: ``exp=ppo_atari`` on 84x84 rgb frame-stacked 4 times, a rollout of
1024 steps x 1 env drawn from ``default_rng(17)``, 3 epochs of 4 minibatch
steps of 256, from the port's initial weights.  Each optimizer runs the
phase three times: twice from the same weights (the control, which must
agree exactly) and once with every floating weight moved up one ulp
(``torch.nextafter``).  Printed for each: the relative L2 difference of the
parameters' changes, and the largest element difference as a share of the
largest change.

    JAX_PLATFORMS=cpu python tools/ulp_sensitivity.py   # about 70 s
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PPO_ATARI = ("exp=ppo_atari", "env=dummy", "env.id=discrete_dummy", "fabric.accelerator=cpu",
             "env.screen_size=84", "env.wrapper.image_size=[84,84,3]", "env.frame_stack=4", "env.num_envs=1")
SGD = {"name": "sgd", "lr": 0.01, "momentum": 0.0}


def main() -> int:
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.ppo import PPOTrainer, epoch_permutation, rollout_to_device
    from sheeprl_tpu_torch.algos.ppo.utils import prepare_obs, spaces_to_dims
    from sheeprl_tpu_torch.config.compose import compose
    from sheeprl_tpu_torch.fabric import build_fabric
    from sheeprl_tpu_torch.serve.loader import probe_spaces
    from sheeprl_tpu_torch.utils.optim import build_optimizer

    torch.manual_seed(0)
    cfg = compose(list(PPO_ATARI))
    fabric = build_fabric(cfg)
    obs_space, act_space = probe_spaces(cfg)
    dims, cont = spaces_to_dims(act_space)
    initial = {k: v.clone() for k, v in build_agent(fabric, dims, cont, cfg, obs_space).state_dict().items()}
    T, B = int(cfg.algo.rollout_steps), int(cfg.env.num_envs)
    rng = np.random.default_rng(17)  # phase 17's rollout
    host = {"rgb": rng.integers(0, 256, (T, B, *obs_space["rgb"].shape), dtype=np.uint8),
            "actions": rng.integers(0, dims[0], (T, B, 1)).astype(np.float32),
            "logprobs": (np.log(1.0 / dims[0]) + 0.3 * rng.standard_normal((T, B, 1))).astype(np.float32),
            "rewards": rng.standard_normal((T, B, 1)).astype(np.float32),
            "dones": (rng.random((T, B, 1)) < 0.01).astype(np.float32)}
    last = {"rgb": rng.integers(0, 256, (B, *obs_space["rgb"].shape), dtype=np.uint8)}

    def phase(start, optim):
        agent = build_agent(fabric, dims, cont, cfg, obs_space, {k: v.clone() for k, v in start.items()})
        trainer = PPOTrainer(cfg, agent, build_optimizer(agent.parameters(), optim, cfg.algo.max_grad_norm),
                             ("rgb",), dims, cont, T, B)
        perms = [epoch_permutation(torch.Generator().manual_seed(e), T, B, trainer.batch_size,
                                   trainer.num_minibatches) for e in range(trainer.update_epochs)]
        trainer.train_phase(rollout_to_device(host, ("rgb",), (), "cpu"), prepare_obs(last, ("rgb",), (), "cpu"),
                            perms, 0.1, 0.01)
        return {k: v.detach().clone() for k, v in agent.state_dict().items()}

    def compare(a, b, start_a, start_b):
        d_ref = torch.cat([(a[k] - start_a[k]).flatten() for k in a])
        d = torch.cat([(b[k] - start_b[k]).flatten() for k in a]) - d_ref
        return float(d.norm() / d_ref.norm()), float(d.abs().max() / d_ref.abs().max())

    moved = {k: torch.nextafter(v, torch.full_like(v, float("inf"))) if v.is_floating_point() else v
             for k, v in initial.items()}
    for name, optim in (("SGD lr 0.01", SGD), ("the recipe's Adam", dict(cfg.algo.optimizer))):
        t0 = time.perf_counter()
        base, again, shifted = phase(initial, optim), phase(initial, optim), phase(moved, optim)
        l2, worst = compare(base, shifted, initial, moved)
        c_l2, c_worst = compare(base, again, initial, initial)
        print(f"{name}: one ulp -> parameter changes rel L2 diff {l2:.3g}, largest element diff {worst:.3g} of the "
              f"largest change; same inputs twice -> {c_l2:.3g} and {c_worst:.3g} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
