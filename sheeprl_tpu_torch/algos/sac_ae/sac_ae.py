"""SAC-AE on one device (counterpart of ``sheeprl_tpu/algos/sac_ae/sac_ae.py``,
its host-ring path), on the off-policy loop of ``algos/sac/sac.py``.

:class:`SACAETrainer` is the JAX ``one_update``, in this order:

* the critic and the encoder, from one backward pass of the critic loss and
  two optimizers; the target runs ``target_encoder`` → actor →
  ``target_critic``;
* every ``actor.per_rank_update_freq`` updates, the actor and the
  temperature, on the (updated) encoder's features detached;
* every ``decoder.per_rank_update_freq`` updates, the encoder and the
  decoder on the reconstruction loss: per key ``mean((recon − target)²)``
  plus ``0.5·λ·mean(‖h‖²)``, where an image's target is its 5-bit
  quantisation ``floor(round(x·255) / 8) / 32`` plus a ``U[0, 1) / 32``
  dither, minus 0.5;
* every ``critic.per_rank_target_network_update_freq`` updates, the EMA of
  the critic (``tau``) and of the encoder (``encoder.tau``).

Images are stored as uint8 with explicit ``next_<key>`` rows (on the device
ring too, as in JAX: no row is derived from its successor), scaled by 1/255
on the device, frame stacks merged into channels.  A long window is sampled
and run in power-of-two chunks, as the JAX package dispatches it.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v3.utils import normalize_obs_block
from sheeprl_tpu_torch.algos.sac.agent import ema_update, sample_action
from sheeprl_tpu_torch.algos.sac.loss import critic_loss
from sheeprl_tpu_torch.algos.sac.sac import Batch, SACTrainer, UpdateNoise, _optimizer, off_policy_loop
from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent
from sheeprl_tpu_torch.utils.distribution import Normal
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.utils import merge_framestack


def pixel_target(x: torch.Tensor, dither: torch.Tensor) -> torch.Tensor:
    """The decoder's target for an image ``x`` in [0, 1]: its 5-bit
    quantisation (rounded back to the uint8 grid first) plus ``dither``
    (``U[0, 1)``) / 32, minus 0.5."""
    return torch.floor(torch.round(x * 255.0) / 8.0) / 32.0 + dither / 32.0 - 0.5


class SACAETrainer(SACTrainer):
    """The SAC-AE update of one replay window.

    ``batches`` hold ``(U, B, ...)`` tensors: each observation key and its
    ``next_<key>`` (images uint8 NHWC, vectors float32 flat), ``actions``,
    ``rewards`` and ``terminated``.  An update's noise adds ``dither``: one
    ``U[0, 1)`` tensor per image key, shaped like the image batch."""

    LOSS_NAMES = (*SACTrainer.LOSS_NAMES, "Loss/reconstruction_loss")
    CHUNKED = True
    HEALTH = False  # the JAX SAC-AE loop runs no health sentinel

    def __init__(self, cfg: Any, agent: torch.nn.Module, optimizers: Dict[str, Any], act_dim: int):
        super().__init__(cfg, agent, optimizers, act_dim)
        a = cfg.algo
        self.encoder, self.decoder, self.target_encoder = agent.encoder, agent.decoder, agent.target_encoder
        self.cnn_keys, self.mlp_keys = self.encoder.cnn_keys, self.encoder.mlp_keys
        self.obs_keys = self.cnn_keys + self.mlp_keys
        self.encoder_tau = float(a.encoder.tau)
        self.target_freq = int(a.critic.per_rank_target_network_update_freq)
        self.actor_freq = int(a.actor.per_rank_update_freq)
        self.decoder_freq = int(a.decoder.per_rank_update_freq)
        self.l2_lambda = float(a.decoder.l2_lambda)

    @staticmethod
    def build_optimizers(cfg: Any, agent: torch.nn.Module, saved=None):
        """SAC's three, plus the encoder's and the decoder's.  The decoder's
        ``weight_decay`` sits under ``name: adam`` and is not read, as the JAX
        ``build_optimizer`` does not read it."""
        opts = SACTrainer.build_optimizers(cfg, agent, saved)
        for name in ("encoder", "decoder"):
            opts[name] = _optimizer(getattr(agent, name).parameters(), cfg.algo[name])
            if saved and name in saved:
                opts[name].load_state_dict(saved[name])
        return opts

    @staticmethod
    def player_modules(agent: torch.nn.Module) -> Dict[str, torch.nn.Module]:
        return {"encoder": agent.encoder, "actor": agent.actor}

    @staticmethod
    def act(modules: Dict[str, torch.nn.Module], obs: Dict[str, torch.Tensor], generator: torch.Generator,
            greedy: bool = False) -> torch.Tensor:
        return sample_action(modules["actor"], modules["encoder"](obs), generator, greedy=greedy)[0]

    def draw_noise(self, batch_size: int, generator: torch.Generator) -> UpdateNoise:
        dev = generator.device
        shape = (batch_size, self.act_dim)
        return {"next": Normal.sample_noise(shape, generator, dev), "pi": Normal.sample_noise(shape, generator, dev),
                "dither": {k: torch.rand((batch_size, *self.decoder.cnn_shapes[k]), generator=generator, device=dev)
                           for k in self.cnn_keys}}

    def reconstruction_loss(self, obs: Dict[str, torch.Tensor], dither: Dict[str, torch.Tensor]) -> torch.Tensor:
        feats = self.encoder(obs)
        recon = self.decoder(feats)
        # the L2 penalty on the features counts once per key, as in the reference
        l2 = 0.5 * self.l2_lambda * torch.mean(torch.sum(feats**2, dim=-1))
        loss = 0.0
        for k in self.obs_keys:
            target = pixel_target(obs[k], dither[k]) if k in self.cnn_keys else obs[k]
            loss = loss + torch.mean((recon[k] - target) ** 2) + l2
        return loss

    def update(self, batch: Batch, noise: UpdateNoise, step_idx: int) -> Tuple[torch.Tensor, ...]:
        alpha = torch.exp(self.agent.log_alpha.detach())
        obs = normalize_obs_block(batch, self.cnn_keys, self.obs_keys, offset=0.0)
        next_obs = normalize_obs_block({k: batch[f"next_{k}"] for k in self.obs_keys}, self.cnn_keys,
                                       self.obs_keys, offset=0.0)

        # -- the critic and the encoder
        with torch.no_grad():
            next_feats = self.target_encoder(next_obs)
        y = self.target(batch, next_feats, noise, alpha)
        vl = critic_loss(self.critic(self.encoder(obs), batch["actions"]), y)
        self._step(vl, "critic", "encoder")

        # -- the actor and the temperature, on detached features
        zero = torch.zeros((), device=vl.device)
        pl = al = zero
        if step_idx % self.actor_freq == 0:
            with torch.no_grad():
                feats = self.encoder(obs)
            pl, lp = self.actor_step(feats, noise, alpha, self.critic)
            al = self.alpha_step(lp)

        # -- the autoencoder
        dl = zero
        if step_idx % self.decoder_freq == 0:
            dl = self.reconstruction_loss(obs, noise["dither"])
            self._step(dl, "encoder", "decoder")

        if step_idx % self.target_freq == 0:
            ema_update(self.target_critic, self.critic, self.tau)
            ema_update(self.target_encoder, self.encoder, self.encoder_tau)
        return vl.detach(), pl.detach(), al.detach(), dl.detach()


class PixelLayout:
    """How SAC-AE reads observations: each key stored with its ``next_<key>``
    row; images uint8 (frame stacks merged into channels on the way out),
    vectors flattened to float32."""

    def __init__(self, cfg: Any, obs_space: Any):
        self.cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
        self.mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
        self.obs_keys = self.cnn_keys + self.mlp_keys
        missing = [k for k in self.obs_keys if k not in obs_space.spaces]
        if missing:
            raise ValueError(f"encoder keys {missing} not in observation space {list(obs_space.spaces)}")
        self.agent_input = obs_space

    def player_obs(self, obs: Dict[str, np.ndarray], device: Any) -> Dict[str, torch.Tensor]:
        out = {}
        for k in self.cnn_keys:
            x = np.asarray(obs[k])
            if x.ndim == 5:  # (B, S, H, W, C) frame stack → channels
                x = merge_framestack(x)
            out[k] = torch.from_numpy(np.ascontiguousarray(x)).to(device).float() / 255.0
        for k in self.mlp_keys:
            x = np.asarray(obs[k], np.float32)
            out[k] = torch.from_numpy(x.reshape(x.shape[0], -1)).to(device)
        return out

    def rows(self, obs: Dict[str, np.ndarray], real_next: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = {k: np.asarray(obs[k])[None] for k in self.obs_keys}
        out.update({f"next_{k}": real_next[k][None] for k in self.obs_keys})
        return out

    def batches(self, sample: Dict[str, np.ndarray], device: Any) -> Batch:
        out = {"actions": torch.from_numpy(np.ascontiguousarray(sample["actions"])).to(device)}
        for k in ("rewards", "terminated"):
            out[k] = torch.from_numpy(np.ascontiguousarray(sample[k][..., 0])).to(device)
        for k in self.cnn_keys:
            for src in (k, f"next_{k}"):
                x = np.asarray(sample[src])
                if x.ndim >= 6:  # (U, B, S, H, W, C) frame stack → channels
                    x = merge_framestack(x)
                out[src] = torch.from_numpy(np.ascontiguousarray(x)).to(device)  # uint8; scaled in the update
        for k in self.mlp_keys:
            for src in (k, f"next_{k}"):
                x = np.asarray(sample[src], np.float32)
                out[src] = torch.from_numpy(np.ascontiguousarray(x.reshape(*x.shape[:2], -1))).to(device)
        return out

    def prep(self, b: Batch) -> Batch:
        """A batch gathered from the device ring, as :meth:`batches` lays out a host sample."""
        out = {"actions": b["actions"], "rewards": b["rewards"][..., 0], "terminated": b["terminated"][..., 0]}
        for k in self.cnn_keys:
            for src in (k, f"next_{k}"):
                out[src] = merge_framestack(b[src]) if b[src].ndim >= 6 else b[src]
        for k in self.mlp_keys:
            for src in (k, f"next_{k}"):
                x = b[src].to(torch.float32)
                out[src] = x.reshape(*x.shape[:2], -1)
        return out


@register_algorithm()
def main(fabric: Any, cfg: Any) -> None:
    off_policy_loop(fabric, cfg, build_agent, SACAETrainer, PixelLayout)
