#!/usr/bin/env python3
"""How far a 1e-7 perturbation of the starting weights moves the Sebulba PPO
learner phase, by epoch count, on the CPU alone.

The phase is the one ``chip_smoke.py`` phase 70 holds the card to the CPU
with: ``exp=ppo_decoupled topology=sebulba`` at phase 68's recipe (4 envs x
128 steps on the dummy env's ``state``, 2 env workers), run on the CPU
through ``cli.run`` until its first learner phase, whose consumed segments
and starting weights are kept.  The learner phase is then stepped with SGD
(the gate's optimizer, the recipe's gradient clip and coefficients) from
those weights and from the weights plus 1e-7 of a fixed normal draw, for
10, 4, 2 and 1 epochs of the recipe's 8 minibatches.  Printed for each:
the relative L2 difference of the parameters' changes.  A gate is only as
tight as the phase is well conditioned: where this difference is large, a
card-vs-CPU comparison of the same phase measures the phase, not the port.

    JAX_PLATFORMS=cpu python tools/sebulba_sensitivity.py   # about 15 s
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> None:
    import chip_smoke as cs
    from sheeprl_tpu_torch.algos.ppo.ppo import epoch_permutation
    from sheeprl_tpu_torch.sebulba import ppo as sppo
    from sheeprl_tpu_torch.utils.optim import build_optimizer

    torch.cuda.synchronize = lambda *a, **k: None  # the run helper synchronises the card
    torch.cuda.empty_cache = lambda *a, **k: None
    recipe = tuple("fabric.accelerator=cpu" if o == "fabric.accelerator=gpu" else o for o in cs.SEBULBA_PPO)
    seen = cs._sebulba_run(torch, sppo, recipe, ROOT / "build" / "sebulba_sensitivity", spy_learner=True)
    src, cfg = seen["trainer"], seen["cfg"]
    segs = [{k: v.detach().clone() for k, v in s.items()} for s in seen["segs"]]
    print(f"the first consumed segments: state in [{float(segs[0]['state'].min()):.1f}, "
          f"{float(segs[0]['state'].max()):.1f}], mean reward {float(segs[0]['rewards'].mean()):.3f}")

    def phase(eps: float, epochs: int):
        noise = torch.Generator().manual_seed(1)
        agent = copy.deepcopy(src.agent)
        agent.load_state_dict({k: v + eps * torch.randn(v.shape, generator=noise) for k, v in seen["start"].items()})
        trainer = copy.copy(src)
        trainer.agent, trainer.update_epochs = agent, epochs
        trainer.optimizer = build_optimizer(agent.named_parameters(), dict(cs.CARD_PARITY_SGD), cfg.algo.max_grad_norm)
        orders = torch.Generator().manual_seed(70)
        perms = [epoch_permutation(orders, src.T, src.B, src.batch_size, src.num_minibatches) for _ in range(epochs)]
        losses = sppo.make_learner_phase(trainer, src.obs_keys)(segs, perms, float(cfg.algo.clip_coef),
                                                                float(cfg.algo.ent_coef))
        return {k: v.detach().clone() for k, v in agent.state_dict().items()}, np.array([float(x) for x in losses])

    for epochs in (10, 4, 2, 1):
        ref = phase(0.0, epochs)
        again = phase(0.0, epochs)
        moved = phase(1e-7, epochs)
        control = cs.change_diffs(torch, seen["start"], *again, *ref)["param_l2"]
        print(f"{epochs:2d} epochs: parameter changes rel L2 diff {cs.change_diffs(torch, seen['start'], *moved, *ref)['param_l2']:.3g} "
              f"after a 1e-7 perturbation (control {control:.3g})")


if __name__ == "__main__":
    main()
