"""The port's ``EpisodeBuffer`` against the JAX package's: the same adds and
the same numpy seed give the same samples, with uniform and end-prioritised
starts, eviction of old episodes, episodes dropped by the tail repair of a
broken stream, truncations, and a state round trip."""

import numpy as np
import pytest

from sheeprl_tpu.data.buffers import EpisodeBuffer as JaxEpisodeBuffer
from sheeprl_tpu_torch.data.buffers import EpisodeBuffer


def _stream(rng, steps, n_envs):
    """Per-step rows of ``n_envs`` streams with random episode ends."""
    for t in range(steps):
        yield {
            "obs": rng.standard_normal((1, n_envs, 3)).astype(np.float32),
            "rgb": rng.integers(0, 256, (1, n_envs, 4, 4, 1), dtype=np.uint8),
            "rewards": np.full((1, n_envs, 1), t, np.float32),
            "terminated": (rng.random((1, n_envs, 1)) < 0.06).astype(np.float32),
            "truncated": (rng.random((1, n_envs, 1)) < 0.03).astype(np.float32),
        }


def _fill(buffers, seed, steps=300, n_envs=3, repair_at=(), row_adds=()):
    rng = np.random.default_rng(seed)
    for t, row in enumerate(_stream(rng, steps, n_envs)):
        for rb in buffers:
            rb.add({k: v.copy() for k, v in row.items()})
            if t in repair_at:
                rb.repair_tail(1)
            if t in row_adds:
                # a final row for env 2 alone, as the loop adds for finished episodes
                rb.add({k: v[:, 2:3].copy() for k, v in row.items()}, indices=[2])


@pytest.mark.parametrize("prioritize_ends", [False, True])
@pytest.mark.parametrize("size", [10_000, 120])
def test_same_adds_and_seed_give_the_same_samples(prioritize_ends, size):
    L = 6
    port = EpisodeBuffer(size, L, n_envs=3, prioritize_ends=prioritize_ends)
    ref = JaxEpisodeBuffer(size, L, n_envs=3, prioritize_ends=prioritize_ends)
    _fill([port, ref], seed=1, repair_at=(40, 41, 150), row_adds=(77, 200))
    assert len(port) == len(ref) > L and len(port.buffer) == len(ref.buffer)
    if size < 10_000:
        assert len(port) <= size  # old episodes were evicted
    for seed in (0, 1):
        np.random.seed(seed)
        a = port.sample(4, n_samples=3)
        np.random.seed(seed)
        b = ref.sample(4, n_samples=3)
        assert set(a) == set(b)
        for k in a:
            assert a[k].shape == b[k].shape == (3, L, 4, *b[k].shape[3:])
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_tail_repair_drops_the_open_episode():
    port = EpisodeBuffer(1000, 2, n_envs=1)
    ref = JaxEpisodeBuffer(1000, 2, n_envs=1)
    for rb in (port, ref):
        for t in range(5):
            rb.add({"obs": np.full((1, 1, 1), t, np.float32), "terminated": np.zeros((1, 1, 1), np.float32)})
        rb.repair_tail(0)  # the stream broke: the 5 open steps can never be finished
        for t in range(3):
            done = np.full((1, 1, 1), float(t == 2), np.float32)
            rb.add({"obs": np.full((1, 1, 1), 10 + t, np.float32), "terminated": done})
    assert len(port) == len(ref) == 3
    np.testing.assert_array_equal(port.buffer[0]["obs"][:, 0], ref.buffer[0]["obs"][:, 0])
    np.testing.assert_array_equal(port.buffer[0]["obs"][:, 0], [10, 11, 12])


def test_state_round_trip_keeps_committed_episodes(tmp_path):
    port = EpisodeBuffer(10_000, 4, n_envs=3, memmap=True, memmap_dir=tmp_path)
    _fill([port], seed=2, steps=120)
    restored = EpisodeBuffer(10_000, 4, n_envs=3).load_state_dict(
        {k: ([{kk: np.asarray(vv) for kk, vv in ep.items()} for ep in v] if k == "episodes" else v)
         for k, v in port.state_dict().items()})
    assert len(restored) == len(port) and len(restored.buffer) == len(port.buffer)
    np.random.seed(3)
    a = port.sample(2, n_samples=2)
    np.random.seed(3)
    b = restored.sample(2, n_samples=2)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
