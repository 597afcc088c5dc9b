"""A snapshot's replay tail, against the JAX package's ``CheckpointCallback``.

JAX's ``_consistent_tail`` (``sheeprl_tpu/utils/callback.py``) marks the
step at each host ring's write head ``truncated`` / ``dones`` = 1 for the
save only.  The port's :func:`~sheeprl_tpu_torch.utils.callback.replay_state`
patches the saved copy instead.  On equal rings the two saved tails are
equal, every other row and key (``terminated`` among them) is the ring's
own, and the port's live ring is unchanged after the save.  A DreamerV3 run
with ``buffer.checkpoint=True`` commits such a tail.
"""

import glob

import numpy as np
import pytest
import torch

from sheeprl_tpu.data.buffers import EnvIndependentReplayBuffer as JaxEnvIndependent
from sheeprl_tpu.data.buffers import ReplayBuffer as JaxReplayBuffer
from sheeprl_tpu.data.buffers import SequentialReplayBuffer as JaxSequential
from sheeprl_tpu.utils.callback import _buffer_state, _consistent_tail
from sheeprl_tpu_torch.checkpoint.protocol import load_step_dir
from sheeprl_tpu_torch.cli import run
from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, EpisodeBuffer, ReplayBuffer
from sheeprl_tpu_torch.data.buffers import SequentialReplayBuffer
from sheeprl_tpu_torch.utils.callback import replay_state
from tests.test_torch_train_cli import TINY

N_ENVS = 3


def _rows(rng, steps, n_envs, keys):
    return {k: (rng.random((steps, n_envs, 1)) < 0.3).astype(np.float32) if k != "obs"
            else rng.standard_normal((steps, n_envs, 2)).astype(np.float32) for k in keys}


def _pair(layout, seed=0):
    """The same ring in both packages: ``(jax ring, port ring)``."""
    rng = np.random.default_rng(seed)
    keys = ("obs", "terminated", "truncated", "dones")
    if layout == "next_obs":
        keys = (*keys, "next_obs")
    if layout == "env_independent":
        rings = (JaxEnvIndependent(8, n_envs=N_ENVS, buffer_cls=JaxSequential),
                 EnvIndependentReplayBuffer(8, n_envs=N_ENVS, buffer_cls=SequentialReplayBuffer))
        # the streams advance at their own rates; stream 2 stays empty, stream 1 wraps
        for env, steps in ((0, 3), (1, 11)):
            data = _rows(rng, steps, 1, keys)
            for rb in rings:
                rb.add(data, indices=[env])
        return rings
    rings = (JaxReplayBuffer(8, n_envs=N_ENVS), ReplayBuffer(8, n_envs=N_ENVS))
    steps = {"empty": 0, "replay": 5, "wrapped": 13, "next_obs": 5}[layout]
    if steps:
        data = _rows(rng, steps, N_ENVS, keys)
        for rb in rings:
            rb.add(data)
    return rings


def _subs(state):
    return state["buffers"] if "buffers" in state else [state]


def _host(x):
    return np.array(np.asarray(x), copy=True)


@pytest.mark.parametrize("layout", ["replay", "wrapped", "env_independent", "next_obs", "empty"])
def test_the_saved_tail_is_jaxs_and_the_live_ring_is_unchanged(layout):
    jax_rb, port_rb = _pair(layout)
    with _consistent_tail(jax_rb):
        want = [{k: _host(v) for k, v in sub["buffer"].items()} for sub in _subs(_buffer_state(jax_rb))]
    live = [{k: _host(v) for k, v in sub["buffer"].items()} for sub in _subs(port_rb.state_dict())]
    got = _subs(replay_state(port_rb))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g["buffer"]) == set(w)
        for k, v in w.items():
            np.testing.assert_array_equal(np.asarray(g["buffer"][k]), v, err_msg=k)
    after = [{k: _host(v) for k, v in sub["buffer"].items()} for sub in _subs(port_rb.state_dict())]
    for a, b in zip(after, live):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"live {k}")
    patched = sum(int(np.any(np.asarray(g["buffer"][k]) != live_sub[k]))
                  for g, live_sub in zip(got, live) for k in ("truncated", "dones") if k in live_sub)
    # a ring with rows and no next_* key is patched; the others save as they are
    assert (patched > 0) == (layout in ("replay", "wrapped", "env_independent"))


def test_an_episode_buffer_saves_as_it_is():
    rb = EpisodeBuffer(64, sequence_length=2, n_envs=1)
    step = {"obs": np.zeros((1, 1, 2), np.float32), "terminated": np.zeros((1, 1, 1), np.float32),
            "truncated": np.zeros((1, 1, 1), np.float32)}
    for t in range(4):
        rb.add({**step, "terminated": np.full((1, 1, 1), float(t == 3), np.float32)})
    assert replay_state(rb).keys() == rb.state_dict().keys()


def test_a_dreamer_v3_snapshot_commits_a_truncated_tail(tmp_path):
    """A tiny DreamerV3 dry run (2 envs, a host ring, ``buffer.checkpoint=True``)
    with episodes longer than the run: no env truncated, yet each env's
    write-head row of the committed ring reads as truncated, and no other row
    does; ``terminated`` is untouched."""
    run([*TINY, "dry_run=True", "algo.run_test=False", "buffer.device=False", "env.max_episode_steps=32",
         f"log_dir={tmp_path}"])
    (snapshot,) = glob.glob(f"{tmp_path}/**/checkpoint/step_*", recursive=True)
    subs = load_step_dir(snapshot)["rb"]["buffers"]
    assert len(subs) == 2
    for sub in subs:
        pos, truncated = int(sub["pos"]), sub["buffer"]["truncated"]
        assert pos == 20 and truncated[pos - 1].item() == 1.0  # one row per iteration
        assert torch.count_nonzero(truncated).item() == 1
        assert torch.count_nonzero(sub["buffer"]["terminated"]).item() == 0
