"""MineDojo-style masked sampling of the port's DreamerV3 actor against the
JAX package's (``tests/test_algos/test_masked_actor.py``'s four cases, then
``Actor.sample_masked`` given JAX's draws), and the player of a run with
``algo.actor.action_masks=True``.

The JAX ``sample_masked`` splits its key into one key per action branch and
draws ``argmax(logits + gumbel(key_i))``; the port is handed those Gumbels
(``sample_masked_from_noise``) on the same head output, so the one-hot
samples must be equal exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3.agent import Actor as JaxActor
from sheeprl_tpu_torch.algos.dreamer_v3.agent import Actor
from sheeprl_tpu_torch.envs.minedojo import FN_CRAFT, FN_DESTROY, FN_EQUIP, MASK_KEYS, N_MOVEMENT_ACTIONS

N_CRAFT, N_ITEMS = 5, 7
ACTIONS_DIM = (19, N_CRAFT, N_ITEMS)


def _actor():
    torch.manual_seed(0)
    return Actor(8, ACTIONS_DIM, False, dense_units=16, mlp_layers=1, layer_norm=False, unimix=0.01)


def _head(batch=64, seed=0):
    """A head output with logits far from uniform (every branch)."""
    return torch.from_numpy(np.random.default_rng(seed).normal(0, 3, (batch, sum(ACTIONS_DIM))).astype(np.float32))


def _masks(batch, action=None, craft=None, equip=None, destroy=None):
    def m(x, n):
        return torch.ones(batch, n) if x is None else torch.as_tensor(x, dtype=torch.float32)

    return {"mask_action_type": m(action, 19), "mask_craft_smelt": m(craft, N_CRAFT),
            "mask_equip_place": m(equip, N_ITEMS), "mask_destroy": m(destroy, N_ITEMS)}


def _split(sample):
    s = sample.numpy()
    return s[..., :19], s[..., 19:19 + N_CRAFT], s[..., 19 + N_CRAFT:]


def test_action_type_mask_zeroes_excluded():
    actor, head = _actor(), _head()
    mask_action = np.ones((64, 19), np.float32)
    mask_action[:, 12:] = 0.0
    for seed in range(5):
        a0, _, _ = _split(actor.sample_masked(head, torch.Generator().manual_seed(seed), _masks(64, mask_action)))
        assert a0[:, 12:].sum() == 0.0


def test_craft_mask_applies_only_on_craft_action():
    actor, head = _actor(), _head()
    craft = N_MOVEMENT_ACTIONS + FN_CRAFT - 1
    mask_action = np.zeros((64, 19), np.float32)
    mask_action[:, craft] = 1.0
    craft_mask = np.zeros((64, N_CRAFT), np.float32)
    craft_mask[:, 2] = 1.0
    a0, a1, _ = _split(actor.sample_masked(head, torch.Generator().manual_seed(1),
                                           _masks(64, mask_action, craft=craft_mask)))
    assert (a0.argmax(-1) == craft).all() and (a1.argmax(-1) == 2).all()
    mask_action = np.zeros((64, 19), np.float32)
    mask_action[:, 1] = 1.0  # forward only: the craft argument is free
    _, a1, _ = _split(actor.sample_masked(head, torch.Generator().manual_seed(2),
                                          _masks(64, mask_action, craft=craft_mask)))
    assert len(np.unique(a1.argmax(-1))) > 1


def test_destroy_mask_constrains_inventory_arg():
    actor, head = _actor(), _head()
    destroy = N_MOVEMENT_ACTIONS + FN_DESTROY - 1
    mask_action = np.zeros((64, 19), np.float32)
    mask_action[:, destroy] = 1.0
    destroy_mask = np.zeros((64, N_ITEMS), np.float32)
    destroy_mask[:, 4] = 1.0
    _, _, a2 = _split(actor.sample_masked(head, torch.Generator().manual_seed(3),
                                          _masks(64, mask_action, equip=np.zeros((64, N_ITEMS)),
                                                 destroy=destroy_mask)))
    assert (a2.argmax(-1) == 4).all()


def test_greedy_masked_mode():
    actor, head = _actor(), _head(4)
    s1 = actor.sample_masked(head, torch.Generator().manual_seed(0), _masks(4), greedy=True)
    s2 = actor.sample_masked(head, torch.Generator().manual_seed(9), _masks(4), greedy=True)
    assert torch.equal(s1, s2)


def _random_masks(rng, batch):
    """Masks drawn per row, each with at least one allowed entry, and an
    action-type mask that favours the compound actions with arguments."""
    out = {}
    for key, n in zip(MASK_KEYS, (19, N_CRAFT, N_ITEMS, N_ITEMS)):
        m = (rng.random((batch, n)) < 0.5).astype(np.float32)
        m[np.arange(batch), rng.integers(0, n, batch)] = 1.0
        out[key] = m
    fn = N_MOVEMENT_ACTIONS + np.array([FN_CRAFT, FN_EQUIP, FN_DESTROY]) - 1
    out["mask_action_type"][:, :N_MOVEMENT_ACTIONS] = 0.0
    out["mask_action_type"][:, fn] = 1.0
    return out


@pytest.mark.parametrize("greedy", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_masked_matches_jax_given_its_draws(seed, greedy):
    """The port's masked sample equals JAX's on the same head output, masks
    and Gumbel draws (JAX's ``split(key, 3)``, one ``gumbel`` per branch)."""
    B = 256
    rng = np.random.default_rng(seed)
    head = rng.normal(0, 3, (B, sum(ACTIONS_DIM))).astype(np.float32)
    masks = _random_masks(rng, B)
    jax_actor = JaxActor(actions_dim=ACTIONS_DIM, is_continuous=False, dense_units=16, mlp_layers=1, act="silu",
                         layer_norm=False, unimix=0.01, min_std=0.1, max_std=1.0, init_std=0.0, action_clip=1.0,
                         dtype=jnp.float32)
    key = jax.random.PRNGKey(seed)
    expected = np.asarray(jax_actor.sample_masked(jnp.asarray(head), key, {k: jnp.asarray(v) for k, v in masks.items()},
                                                  greedy=greedy))
    keys = jax.random.split(key, len(ACTIONS_DIM))
    noise = () if greedy else [torch.from_numpy(np.asarray(jax.random.gumbel(k, (B, d), jnp.float32)))
                               for k, d in zip(keys, ACTIONS_DIM)]
    got = _actor().sample_masked_from_noise(torch.from_numpy(head), {k: torch.from_numpy(v) for k, v in masks.items()},
                                            noise, greedy=greedy)
    np.testing.assert_array_equal(got.numpy(), expected)
    a0, a1, a2 = _split(got)
    assert (a0 * (1 - masks["mask_action_type"])).sum() == 0.0
    crafted = a0.argmax(-1) == N_MOVEMENT_ACTIONS + FN_CRAFT - 1
    assert crafted.any() and (a1[crafted] * (1 - masks["mask_craft_smelt"][crafted])).sum() == 0.0


def test_the_player_samples_no_excluded_action():
    """``latent_player_step`` with ``action_masks`` (the training and the
    greedy test player) never samples what the masks exclude."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import latent_player_step
    from sheeprl_tpu_torch.config.compose import compose
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.fabric import build_fabric

    cfg = compose(["exp=dreamer_v3", "algo=dreamer_v3_XS", "env=dummy", "fabric.accelerator=cpu",
                   "algo.cnn_keys.encoder=[]", f"algo.mlp_keys.encoder=[state,{','.join(MASK_KEYS)}]",
                   "algo.actor.action_masks=True", "algo.dense_units=16",
                   "algo.world_model.recurrent_model.recurrent_state_size=16",
                   "algo.world_model.transition_model.hidden_size=16",
                   "algo.world_model.representation_model.hidden_size=16"])
    obs_space = spaces.Dict({"state": spaces.Box(-1, 1, (4,), np.float32),
                             **{k: spaces.Box(0, 1, (n,), np.float32)
                                for k, n in zip(MASK_KEYS, (19, N_CRAFT, N_ITEMS, N_ITEMS))}})
    modules = build_agent(build_fabric(cfg), ACTIONS_DIM, False, cfg, obs_space)
    wm, actor = modules["world_model"], modules["actor"]
    rng = np.random.default_rng(0)
    B, gen = 32, torch.Generator().manual_seed(0)
    carry = (torch.zeros(B, wm.recurrent_size), torch.zeros(B, wm.stoch_flat), torch.zeros(B, sum(ACTIONS_DIM)))
    for step in range(8):
        masks = _random_masks(rng, B)
        obs = {"state": torch.randn(B, 4, generator=gen), **{k: torch.from_numpy(v) for k, v in masks.items()}}
        with torch.no_grad():
            carry, action = latent_player_step(wm, actor, carry, obs, gen, greedy=step % 2 == 1, action_masks=True)
        a0, a1, a2 = _split(action)
        assert (a0 * (1 - masks["mask_action_type"])).sum() == 0.0
        craft = a0.argmax(-1) == N_MOVEMENT_ACTIONS + FN_CRAFT - 1
        assert (a1[craft] * (1 - masks["mask_craft_smelt"][craft])).sum() == 0.0
        destroy = a0.argmax(-1) == N_MOVEMENT_ACTIONS + FN_DESTROY - 1
        assert (a2[destroy] * (1 - masks["mask_destroy"][destroy])).sum() == 0.0
        equip = a0.argmax(-1) == N_MOVEMENT_ACTIONS + FN_EQUIP - 1
        assert (a2[equip] * (1 - masks["mask_equip_place"][equip])).sum() == 0.0


def test_action_masks_need_the_mask_observations():
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import use_action_masks
    from sheeprl_tpu_torch.config.compose import compose

    cfg = compose(["exp=dreamer_v3", "env=dummy", "algo.actor.action_masks=True"])
    with pytest.raises(ValueError, match="mask_action_type"):
        use_action_masks(cfg)
    assert not use_action_masks(compose(["exp=dreamer_v3", "env=dummy"]))
