"""The port's device-resident replay against the JAX package's, on the CPU.

The same numpy-seeded adds go into ``sheeprl_tpu.data.device_replay.
DeviceReplay`` (run as its own tests run it: ``JAX_PLATFORMS=cpu``, no mesh)
and into ``sheeprl_tpu_torch.data.device_replay.DeviceReplay`` on the CPU.

Everything here is held exactly (integers and gathered rows are copies, so
there is nothing to round): the ring's contents and cursors after subset
adds, wrap-around, ``repair_tail`` and ``write_at``; the uniform and
sequence indices the port derives from the draws JAX's keys make (the keys
split as JAX's ``uniform_indices`` and ``sequence_indices`` split them) and
the batches gathered at them; the sizing helpers over a grid; the
checkpoint state, its tail patch and its refusals.  The port's own draws are
held to the laws: never beyond ``filled``, never across a write head, envs
weighted by occupancy (a loose chi-square on a seeded stream).  The spill
tier shadows the full capacity and round-trips a checkpoint.

``steady_guard`` does nothing on the CPU; its CPU stand-in here
(:func:`refuse_host_syncs`, the Anakin tests' technique) makes every call
that would wait on the device raise, and the fused windows run inside it.
"""

import contextlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.data import device_replay as jdr
from sheeprl_tpu.data.buffers import ReplayBuffer as JaxReplayBuffer
from sheeprl_tpu_torch.data import device_replay as pdr
from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer
from sheeprl_tpu_torch.envs import spaces

TENSOR_CALLS = ("item", "tolist", "numpy", "cpu", "nonzero", "__bool__", "__int__", "__float__")
TORCH_CALLS = ("tensor", "as_tensor", "from_numpy", "nonzero", "masked_select")
# Adam keeps its step counter as a host tensor and reads it there: on the card
# that read waits on nothing, so calls from torch.optim pass
_OPTIM = os.sep + os.path.join("torch", "optim") + os.sep
_MISSING = object()


@contextlib.contextmanager
def refuse_host_syncs():
    """Every call that would make the host wait for the device (a tensor
    read back, tested for truth, or made from host data) raises inside."""
    saved = []

    def refuse(name, orig):
        def raiser(*args, **kwargs):
            if _OPTIM in sys._getframe(1).f_code.co_filename:
                return orig(*args, **kwargs)
            raise AssertionError(f"{name} inside a guarded window")
        return raiser

    for owner, names in ((torch.Tensor, TENSOR_CALLS), (torch, TORCH_CALLS)):
        for name in names:
            saved.append((owner, name, owner.__dict__.get(name, _MISSING)))
            setattr(owner, name, refuse(f"{owner.__name__}.{name}", getattr(owner, name)))
    try:
        yield
    finally:
        for owner, name, orig in reversed(saved):
            if orig is _MISSING:
                delattr(owner, name)
            else:
                setattr(owner, name, orig)


def guard_spy(armed):
    """A ``steady_guard`` for the CPU: records each window's flag in
    ``armed`` and refuses host syncs inside the armed ones."""
    @contextlib.contextmanager
    def guard(enabled):
        armed.append(bool(enabled))
        if not enabled:
            yield
            return
        with refuse_host_syncs():
            yield
    return guard


# -- filling both rings ----------------------------------------------------------
def _rows(rng, n_envs, keys=("obs", "rgb", "truncated", "terminated", "is_first")):
    out = {}
    for k in keys:
        if k == "rgb":
            out[k] = rng.integers(0, 256, (1, n_envs, 3, 2, 2), dtype=np.uint8)
        elif k in ("obs", "next_obs"):
            out[k] = rng.standard_normal((1, n_envs, 4)).astype(np.float32)
        else:
            out[k] = (rng.random((1, n_envs, 1)) < 0.3).astype(np.float32)
    return out


def fill_both(cap=16, n_envs=3, steps=23, seed=0, subset_every=4, keys=("obs", "rgb", "truncated", "terminated",
                                                                          "is_first")):
    """A JAX ring and a port ring fed the same adds: every step for all envs,
    and every ``subset_every`` steps an extra row for the last env alone."""
    rng = np.random.default_rng(seed)
    j, p = jdr.DeviceReplay(cap, n_envs), pdr.DeviceReplay(cap, n_envs)
    for t in range(steps):
        data = _rows(rng, n_envs, keys)
        j.add(data)
        p.add(data)
        if subset_every and t % subset_every == 0:
            extra = {k: v[:, :1] for k, v in _rows(rng, n_envs, keys).items()}
            j.add(extra, indices=[n_envs - 1])
            p.add(extra, indices=[n_envs - 1])
    return j, p


def assert_rings_equal(j, p):
    assert j.keys() == p.keys()
    for k in j.keys():
        want = np.asarray(j.buffers[k])
        got = p.buffers[k].numpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    for c in ("pos", "filled"):
        np.testing.assert_array_equal(p.cursor[c].numpy(), np.asarray(j.cursor[c]), err_msg=c)
    np.testing.assert_array_equal(p._pos_h, j._pos_h)
    np.testing.assert_array_equal(p._filled_h, j._filled_h)
    assert len(p) == len(j) and p.full == j.full


# -- the ring ----------------------------------------------------------------------
@pytest.mark.parametrize("steps,subset_every", [(5, 0), (23, 4), (40, 3)], ids=["partial", "wrap-subset", "wrap-twice"])
def test_ring_contents_and_cursors_match_jax(steps, subset_every):
    j, p = fill_both(steps=steps, subset_every=subset_every)
    assert_rings_equal(j, p)


def test_repair_tail_and_write_at_match_jax():
    j, p = fill_both(steps=19)
    for env in (0, 2):
        j.repair_tail(env)
        p.repair_tail(env)
    rows = np.random.default_rng(5).standard_normal((2, 2, 4)).astype(np.float32)
    slots = np.array([[3, 7], [4, 8]])
    j.write_at("obs", rows, slots, [0, 2])
    p.write_at("obs", rows, slots, [0, 2])
    assert_rings_equal(j, p)
    np.testing.assert_array_equal(p.gather_at("obs", slots, np.array([[0, 2]])).numpy(),
                                  np.asarray(j.gather_at("obs", slots, np.array([[0, 2]]))))


def test_adds_longer_than_the_window_keep_the_newest_steps_as_jax_does():
    rng = np.random.default_rng(2)
    j, p = jdr.DeviceReplay(8, 2), pdr.DeviceReplay(8, 2)
    block = {"x": rng.standard_normal((13, 2, 3)), "f": rng.integers(0, 9, (13, 2, 1))}  # float64 / int64
    j.add(block)
    p.add(block)
    assert_rings_equal(j, p)
    assert p.buffers["x"].dtype == torch.float32 and p.buffers["f"].dtype == torch.int32


def test_geometry_and_eligibility():
    p = pdr.DeviceReplay(16, 2)
    assert not p.can_sample() and p.empty
    p.add({"x": np.zeros((1, 2, 3), np.float32), "r": np.zeros((1, 2, 1), np.float32)})
    assert p.can_sample() and not p.can_sample_sequences(4)
    for _ in range(5):
        p.add({"x": np.zeros((1, 2, 3), np.float32), "r": np.zeros((1, 2, 1), np.float32)})
    assert p.can_sample_sequences(4) and len(p) == 12 and "x" in p
    assert p.hbm_bytes == 16 * 2 * 4 * 4
    assert p.sampled_bytes_per_update(8, 5) == 8 * 5 * (12 + 4)
    assert p.sampled_bytes_per_update(8, derive_next=("x",)) == 8 * (24 + 4)


# -- index laws against JAX's draws ------------------------------------------------
def jax_uniform_draws(j, key, total, sample_next_obs):
    """JAX's uniform draws, split as ``uniform_indices`` splits its key."""
    filled = int(np.asarray(j.cursor["filled"])[0])
    cap = j.capacity
    trim = 1 if sample_next_obs else 0
    valid = cap - trim if filled >= cap else max(filled - trim, 0)
    k_step, k_env = jax.random.split(key)
    r = jax.random.randint(k_step, (total,), 0, max(valid, 1))
    env = jax.random.randint(k_env, (total,), 0, j.n_envs)
    return torch.from_numpy(np.array(r, np.int64)), torch.from_numpy(np.array(env, np.int64))


def jax_sequence_draws(j, key, total, L):
    """JAX's sequence draws, split as ``sequence_indices`` splits its key:
    the categorical's Gumbels and the start drawn below each env's range."""
    k_env, k_start = jax.random.split(key)
    gumbel = jax.random.gumbel(k_env, (total, j.n_envs))
    _, env = j.sequence_indices(j.cursor, key, total, L)
    filled = np.asarray(j.cursor["filled"])
    max_start = np.where(filled >= j.capacity, j.capacity - L, filled - L)
    valid = np.maximum(max_start[np.asarray(env)] + 1, 1)
    start = jax.random.randint(k_start, (total,), 0, jnp.asarray(valid))
    return torch.from_numpy(np.array(gumbel)), torch.from_numpy(np.array(start, np.int64))


@pytest.mark.parametrize("steps,derive", [(5, False), (10, True), (23, False), (37, True)],
                         ids=["partial", "partial-derive_next", "full", "full-derive_next"])
def test_uniform_indices_and_batches_match_jax_draws(steps, derive):
    keys = ("obs", "rgb", "terminated") if derive else ("obs", "next_obs", "rgb", "terminated")
    j, p = fill_both(steps=steps, subset_every=0, keys=keys)
    key = jax.random.PRNGKey(steps)
    B, n = 5, 4
    derive_next = ("obs", "rgb") if derive else ()
    want = j.sample_uniform(j.buffers, j.cursor, key, B, n, derive_next=derive_next)
    step, env = j.uniform_indices(j.cursor, key, B * n, sample_next_obs=derive)
    # sample_uniform draws from the first half of its key's split chain, as uniform_indices does
    got_step, got_env = p.uniform_indices_from(*jax_uniform_draws(j, key, B * n, derive), sample_next_obs=derive)
    np.testing.assert_array_equal(got_step.numpy(), np.asarray(step))
    np.testing.assert_array_equal(got_env.numpy(), np.asarray(env))
    got = p.sample_uniform(None, B, n, derive_next=derive_next, indices=(got_step, got_env))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("steps,subset_every,L", [(12, 0, 4), (23, 4, 5), (40, 3, 8)],
                         ids=["partial", "wrap-subset", "wrap-twice-L8"])
def test_sequence_indices_and_blocks_match_jax_draws(steps, subset_every, L):
    j, p = fill_both(steps=steps, subset_every=subset_every)
    key = jax.random.PRNGKey(100 + steps)
    B, n = 4, 3
    t_idx, env = j.sequence_indices(j.cursor, key, B * n, L)
    got_t, got_env = p.sequence_indices_from(*jax_sequence_draws(j, key, B * n, L), L)
    np.testing.assert_array_equal(got_env.numpy(), np.asarray(env))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(t_idx))
    want = j.sample_sequences(j.buffers, j.cursor, key, B, L, n)
    got = p.sample_sequences(None, B, L, n, indices=(got_t, got_env))
    for k in want:
        assert got[k].is_contiguous()
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


# -- the port's own draws ------------------------------------------------------------
@pytest.mark.parametrize("steps", [3, 16, 29])
def test_own_uniform_draws_stay_inside_filled_and_behind_the_head(steps):
    p = pdr.DeviceReplay(16, 2)
    for t in range(steps):
        p.add({"x": np.full((1, 2, 1), t, np.float32)})
    gen = torch.Generator().manual_seed(steps)
    step, env = p.uniform_indices(gen, 4096)
    assert int(step.min()) >= 0 and int(step.max()) < min(steps, 16)
    assert set(env.tolist()) == {0, 1}
    nstep, _ = p.uniform_indices(gen, 4096, sample_next_obs=True)
    head = int(p._pos_h[0])
    if steps >= 16:  # full: the slot before the write head has no successor
        assert (head - 1) % 16 not in set(nstep.tolist()) and len(set(nstep.tolist())) == 15
    else:
        assert int(nstep.max()) < steps - 1
    # derived next rows are the successor steps
    batch = p.sample_uniform(gen, 64, 2, derive_next=("x",))
    assert torch.equal((batch["x"] + 1) % 29 if steps == 29 else batch["x"] + 1, batch["next_x"])


def test_own_sequence_draws_never_cross_a_write_head():
    L, cap = 5, 16
    p = pdr.DeviceReplay(cap, 3)
    history = {e: [] for e in range(3)}
    counter = 0
    for t in range(40):
        envs = [0, 1, 2] if t % 3 else [1]
        rows = []
        for e in envs:
            rows.append(counter)
            history[e].append(counter)
            counter += 1
        p.add({"x": np.array(rows, np.float32).reshape(1, len(envs), 1)}, indices=envs)
    blocks = p.sample_sequences(torch.Generator().manual_seed(0), 64, L, 8)["x"][..., 0]  # (8, L, 64)
    seqs = blocks.permute(0, 2, 1).reshape(-1, L).numpy().astype(np.int64)
    for seq in seqs:
        env = next(e for e in range(3) if seq[0] in history[e])
        h = history[env][-min(len(history[env]), cap):]
        i = h.index(seq[0])
        assert list(seq) == h[i:i + L], (env, seq)


def test_own_sequence_draws_weight_envs_by_occupancy():
    """Env e holding f_e >= L steps is drawn with probability f_e / sum f;
    an env below L never."""
    cap, L = 64, 4
    p = pdr.DeviceReplay(cap, 4)
    for e, n in enumerate((40, 10, 2, 64)):
        p.add({"x": np.zeros((n, 1, 1), np.float32)}, indices=[e])
    _, env = p.sequence_indices(torch.Generator().manual_seed(1), 20000, L)
    counts = np.bincount(env.numpy(), minlength=4)
    assert counts[2] == 0
    expected = np.array([40, 10, 64]) / 114 * 20000
    chi2 = float((((counts[[0, 1, 3]] - expected) ** 2) / expected).sum())
    assert chi2 < 20.0, (counts, chi2)  # 2 degrees of freedom: p < 5e-5 above 20


# -- sizing helpers ----------------------------------------------------------------
def test_estimate_step_bytes_matches_jax():
    space = spaces.Dict({"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8),
                         "state": spaces.Box(-1, 1, (4,), np.float32),
                         "wide": spaces.Box(-1, 1, (3, 5), np.float64)})
    for keys in (("rgb",), ("state",), ("rgb", "state", "wide")):
        for extra, copies in ((64, 1), (4 * 8, 1), (4 * 4, 2)):
            assert pdr.estimate_step_bytes(space, keys, extra, copies) == jdr.estimate_step_bytes(
                space, keys, extra, copies)


@pytest.mark.parametrize("budget", [None, 4000, 12336 * 10])
def test_fit_hbm_window_matches_jax(budget, monkeypatch):
    if budget is not None:
        monkeypatch.setenv("SHEEPRL_REPLAY_BUDGET_BYTES", str(budget))
    for capacity, n_envs, step_bytes, requested in ((10_000, 2, 4, None), (100, 2, 4, None), (1_000_000, 1, 12336, None),
                                                    (500, 4, 64, 64), (50, 1, 12336, 900)):
        assert pdr.fit_hbm_window(capacity, n_envs, step_bytes, requested) == jdr.fit_hbm_window(
            capacity, n_envs, step_bytes, requested)


@pytest.mark.parametrize("env", [{}, {"SHEEPRL_MAX_WINDOW_UPDATES": "64"}, {"SHEEPRL_MAX_HBM_WINDOW_BYTES": "100000"}])
def test_update_chunks_match_jax(env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for n in (1, 7, 8, 65, 1023, 1300, 4097):
        for cap in (None, 64, 100):
            for per_update in (0.0, 1e3, 12.6e6):
                assert pdr.update_chunks(n, cap, per_update) == jdr.update_chunks(n, cap, per_update)
    assert pdr.update_chunks(1300, cap=64) == [64] * 20 + [16, 4]


# -- the spill tier ----------------------------------------------------------------
def test_spill_shadows_the_full_capacity():
    spill = pdr.HostSpill(32, 2)
    rb = pdr.DeviceReplay(8, 2, spill=spill)
    for t in range(20):
        rb.add({"x": np.full((1, 2, 1), t, np.float32)})
    assert spill.flush(30.0) and spill.backlog == 0
    assert len(spill.buffer) == 20
    np.testing.assert_array_equal(spill.buffer.buffer["x"][:20, 0, 0], np.arange(20, dtype=np.float32))
    np.testing.assert_array_equal(rb.buffers["x"][:, 0, 0].numpy(), np.r_[16:20, 12:16].astype(np.float32))
    assert rb.state_dict()["device_replay"]["from_spill"]
    spill.close()


def test_sequential_spill_tracks_per_env_subset_adds_and_restores():
    spill = pdr.HostSpill(64, 2, sequential=True)
    rb = pdr.DeviceReplay(16, 2, spill=spill)
    for t in range(10):
        rb.add({"x": np.full((1, 2, 1), t, np.float32)})
        if t % 3 == 0:
            rb.add({"x": np.full((1, 1, 1), 100 + t, np.float32)}, indices=[1])
    spill.flush(30.0)
    assert isinstance(spill.buffer, EnvIndependentReplayBuffer)
    for env in range(2):
        n = int(rb._filled_h[env])
        np.testing.assert_array_equal(np.asarray(spill.buffer.buffer[env]["x"])[:n, 0, 0],
                                      rb.buffers["x"][:n, env, 0].numpy())
    assert len(spill.buffer.buffer[0]) != len(spill.buffer.buffer[1])
    state = rb.state_dict()
    rb2 = pdr.DeviceReplay(16, 2, spill=pdr.HostSpill(64, 2, sequential=True)).load_state_dict(state)
    mask = torch.from_numpy(np.arange(16)[:, None] < rb._filled_h[None, :])
    assert torch.equal(rb2.buffers["x"][..., 0] * mask, rb.buffers["x"][..., 0] * mask)
    assert torch.equal(rb2.cursor["pos"], rb.cursor["pos"]) and torch.equal(rb2.cursor["filled"], rb.cursor["filled"])
    rb2.spill.close()
    spill.close()


def test_spill_checkpoint_round_trips_into_a_fresh_ring_as_jax_does():
    rng = np.random.default_rng(3)
    j, p = jdr.DeviceReplay(8, 2, spill=jdr.HostSpill(32, 2)), pdr.DeviceReplay(8, 2, spill=pdr.HostSpill(32, 2))
    for _ in range(20):
        data = {"x": rng.standard_normal((1, 2, 3)).astype(np.float32), "truncated": np.zeros((1, 2, 1), np.float32)}
        j.add(data)
        p.add(data)
    j_state, p_state = j.state_dict(), p.state_dict()
    assert p_state["device_replay"]["from_spill"]
    for k in ("x", "truncated"):  # the tail patch on the copy, as JAX's
        np.testing.assert_array_equal(np.asarray(p_state["buffer"][k]), np.asarray(j_state["buffer"][k]))
    tail = (int(p_state["pos"]) - 1) % 32
    assert np.all(np.asarray(p_state["buffer"]["truncated"])[tail] == 1.0)
    assert np.all(np.asarray(p.spill.buffer["truncated"])[tail] == 0.0)  # the live spill is untouched
    fresh = pdr.DeviceReplay(8, 2, spill=pdr.HostSpill(32, 2)).load_state_dict(p_state)
    assert torch.equal(fresh.buffers["x"], p.buffers["x"])
    np.testing.assert_array_equal(fresh._filled_h, p._filled_h)
    fresh.spill.flush(30.0)
    assert len(fresh.spill.buffer) == 20
    with pytest.raises(ValueError, match="no spill armed"):
        pdr.DeviceReplay(8, 2).load_state_dict(p_state)
    for rb in (j, p, fresh):
        rb.spill.close()


@pytest.mark.parametrize("sequential", [False, True])
def test_repair_tail_reaches_the_spill(sequential):
    """The port carries the truncation mark into the spill's shadow, behind
    the appends before it (the JAX module marks the device ring alone)."""
    spill = pdr.HostSpill(32, 2, sequential=sequential)
    rb = pdr.DeviceReplay(8, 2, spill=spill)
    flags = {k: np.zeros((1, 2, 1), np.float32) for k in ("truncated", "terminated", "is_first")}
    for t in range(5):
        rb.add({"x": np.full((1, 2, 1), t, np.float32), **flags})
    rb.repair_tail(1)
    rb.add({"x": np.full((1, 2, 1), 5, np.float32), **flags})
    spill.flush(30.0)
    host = spill.buffer.buffer[1]["truncated"][:, 0, 0] if sequential else spill.buffer.buffer["truncated"][:, 1, 0]
    np.testing.assert_array_equal(np.asarray(host)[:6], [0, 0, 0, 0, 1, 0])
    np.testing.assert_array_equal(rb.buffers["truncated"][:6, 1, 0].numpy(), [0, 0, 0, 0, 1, 0])
    spill.close()


def test_a_failing_spill_degrades_and_the_checkpoint_falls_back_to_the_ring():
    spill = pdr.HostSpill(64, 2)
    calls = []

    def fault(rows):  # the replay.spill site: the third write fails
        calls.append(1)
        if len(calls) == 3:
            raise OSError("spill disk gone")
        return rows

    spill.fault = fault
    rb = pdr.DeviceReplay(8, 2, spill=spill)
    with pytest.warns(RuntimeWarning, match="spill tier degraded"):
        for t in range(5):
            rb.add({"x": np.full((1, 2, 1), t, np.float32)})
        spill.flush(30.0)
    assert spill.degraded
    np.testing.assert_array_equal(rb.buffers["x"][:5, 0, 0].numpy(), np.arange(5, dtype=np.float32))
    assert not rb.state_dict()["device_replay"]["from_spill"]
    spill.close()


# -- checkpoint state --------------------------------------------------------------
def test_state_dict_applies_the_tail_patch_as_jax_does():
    j, p = fill_both(steps=11, keys=("obs", "truncated", "terminated", "dones"))
    js, ps = j.state_dict(), p.state_dict()
    for k in js["buffer"]:
        np.testing.assert_array_equal(ps["buffer"][k], np.asarray(js["buffer"][k]), err_msg=k)
    for k in ("pos", "filled", "buffer_size", "n_envs"):
        np.testing.assert_array_equal(ps[k], js[k])
    # terminated survives, the live ring is not patched
    tail = (p._pos_h - 1) % 16
    assert np.all(ps["buffer"]["truncated"][tail, np.arange(3)] == 1.0)
    np.testing.assert_array_equal(ps["buffer"]["terminated"], p.buffers["terminated"].numpy())
    assert not torch.all(p.buffers["truncated"][tail, np.arange(3)] == 1.0)
    rb2 = pdr.DeviceReplay(16, 3).load_state_dict(ps)
    assert torch.equal(rb2.buffers["obs"], p.buffers["obs"]) and torch.equal(rb2.cursor["pos"], p.cursor["pos"])


def test_load_refuses_what_jax_refuses():
    host = EnvIndependentReplayBuffer(16, n_envs=2)
    host.add({"x": np.zeros((3, 2, 1), np.float32)})
    with pytest.raises(ValueError, match="host EnvIndependent"):
        pdr.DeviceReplay(16, 2).load_state_dict(host.state_dict())
    state = pdr.DeviceReplay(16, 3).state_dict()
    with pytest.raises(ValueError, match="expected 2"):
        pdr.DeviceReplay(16, 2).load_state_dict(state)
    with pytest.raises(ValueError, match="window 16 != 8"):
        pdr.DeviceReplay(8, 3).load_state_dict(state)
    # a host ReplayBuffer's scalar-cursor state (the JAX module fails on its
    # missing "filled"; the port reads the cursor as the host ring means it)
    jhost = JaxReplayBuffer(8, 2)
    for t in range(11):
        jhost.add({"x": np.full((1, 2, 1), t, np.float32)})
    with pytest.raises(KeyError):
        jdr.DeviceReplay(8, 2).load_state_dict(jhost.state_dict())
    got = pdr.DeviceReplay(8, 2).load_state_dict(jhost.state_dict())
    np.testing.assert_array_equal(got.buffers["x"].numpy(), jhost.buffer["x"])
    np.testing.assert_array_equal(got._pos_h, [3, 3])
    np.testing.assert_array_equal(got.cursor["filled"].numpy(), [8, 8])


# -- the guard -----------------------------------------------------------------------
@pytest.mark.parametrize("call", ["item", "cpu", "bool", "nonzero", "tensor"])
def test_guarded_window_refuses_host_syncs(call):
    x = torch.arange(4.0)
    make = {"item": lambda: x[0].item(), "cpu": lambda: x.cpu(), "bool": lambda: bool(x[0] > 1),
            "nonzero": lambda: x.nonzero(), "tensor": lambda: torch.tensor([1.0])}[call]
    make()  # fine outside
    with refuse_host_syncs():
        with pytest.raises(AssertionError, match="inside a guarded window"):
            make()
    make()
    with pdr.steady_guard(True):  # no CUDA here: the guard itself does nothing
        make()


class _Recorder:
    """A trainer whose window only reads its batches (no read back)."""

    def __init__(self):
        self.seen = []

    def train_phase(self, batches, noise, counter):
        self.seen.append((batches, noise, counter))
        return tuple(v.float().mean() for v in batches.values())


def test_fused_windows_draw_gather_and_run_without_a_host_sync():
    j, p = fill_both(steps=23)
    gen = torch.Generator().manual_seed(0)
    trainer = _Recorder()
    with refuse_host_syncs():
        counter, metrics = pdr.fused_sequence_train(trainer, p, gen, 4, 5, 2, lambda b: b, 7)
        counter, metrics = pdr.fused_uniform_train(trainer, p, gen, 6, 3, lambda b: b, counter,
                                                   derive_next=("obs",))
    assert counter == 12
    seq, uni = trainer.seen[0][0], trainer.seen[1][0]
    assert seq["obs"].shape == (2, 5, 4, 4) and seq["rgb"].shape == (2, 5, 4, 3, 2, 2)
    assert uni["obs"].shape == (3, 6, 4) and uni["next_obs"].shape == (3, 6, 4)
    assert trainer.seen[0][1] is gen and trainer.seen[0][2] == 7 and trainer.seen[1][2] == 9
    # every gathered sequence is a run of consecutive steps of one env
    p2 = pdr.DeviceReplay(32, 2)
    for t in range(20):
        p2.add({"t": np.full((1, 2, 1), t, np.float32), "e": np.array([[[0.0], [1.0]]], np.float32)})
    blocks = p2.sample_sequences(gen, 8, 6, 2)
    assert torch.all(torch.diff(blocks["t"], dim=1) == 1)
    assert torch.all(blocks["e"] == blocks["e"][:, :1])


def test_stage_helpers_copy_explicitly():
    host = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.ones((2,), np.uint8)}
    out = pdr.stage_rollout(host, "cpu")
    assert out["a"].dtype == torch.float32 and out["b"].dtype == torch.uint8
    np.testing.assert_array_equal(out["a"].numpy(), host["a"])
    s = pdr.stage_scalar(0.2, "cpu")
    assert s.shape == () and s.dtype == torch.float32 and float(s) == np.float32(0.2)


# -- the layouts' prep: a gathered batch laid out as the host path lays out a sample --
@pytest.mark.parametrize("stacked", [False, True], ids=["frames", "frame-stack"])
def test_prep_blocks_match_blocks_to_device(stacked):
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import blocks_to_device, prep_blocks

    rng = np.random.default_rng(4)
    rgb = (2, 5, 3, *((4,) if stacked else ()), 8, 8, 3)
    sample = {"rgb": rng.integers(0, 256, rgb, dtype=np.uint8),
              "state": rng.standard_normal((2, 5, 3, 2, 2)),  # float64, 2-D: flattened to float32
              "actions": np.eye(4, dtype=np.float32)[rng.integers(0, 4, (2, 5, 3))],
              **{k: rng.random((2, 5, 3, 1)).astype(np.float32) for k in ("rewards", "terminated", "is_first")}}
    want = blocks_to_device(sample, ("rgb",), ("state",), "cpu")
    got = prep_blocks({k: torch.from_numpy(np.asarray(v)) for k, v in sample.items()}, ("rgb",), ("state",))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("layout", ["vector", "pixels", "pixels-frame-stack"])
def test_off_policy_prep_matches_the_host_batches(layout):
    from sheeprl_tpu_torch.algos.sac.sac import VectorLayout
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import PixelLayout
    from sheeprl_tpu_torch.config.compose import compose

    rng = np.random.default_rng(5)
    U, B = 2, 3
    sample = {"actions": rng.standard_normal((U, B, 2)).astype(np.float32),
              **{k: rng.random((U, B, 1)).astype(np.float32) for k in ("rewards", "terminated")}}
    if layout == "vector":
        lay = VectorLayout(compose(["exp=sac", "env=dummy", "algo.mlp_keys.encoder=[state]"]),
                           spaces.Dict({"state": spaces.Box(-1, 1, (4,), np.float32)}))
        sample.update({k: rng.standard_normal((U, B, 4)).astype(np.float32) for k in ("obs", "next_obs")})
    else:
        stack = (4,) if layout.endswith("stack") else ()
        lay = PixelLayout(compose(["exp=sac_ae", "env=dummy", "algo.cnn_keys.encoder=[rgb]",
                                   "algo.mlp_keys.encoder=[state]"]),
                          spaces.Dict({"rgb": spaces.Box(0, 255, (*stack, 8, 8, 3), np.uint8),
                                       "state": spaces.Box(-1, 1, (2, 2), np.float32)}))
        for k in ("rgb", "next_rgb"):
            sample[k] = rng.integers(0, 256, (U, B, *stack, 8, 8, 3), dtype=np.uint8)
        for k in ("state", "next_state"):
            sample[k] = rng.standard_normal((U, B, 2, 2)).astype(np.float32)
    want = lay.batches(sample, "cpu")
    got = lay.prep({k: torch.from_numpy(v) for k, v in sample.items()})
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_build_device_replay_arms_the_spill_beyond_the_budget(monkeypatch):
    from sheeprl_tpu_torch.config.compose import compose

    cfg = compose(["exp=sac", "env=dummy", "buffer.memmap=False"])
    monkeypatch.setenv("SHEEPRL_REPLAY_BUDGET_BYTES", str(48 * 2 * 100))
    rb = pdr.build_device_replay(cfg, 1000, 2, "cpu", 48, sequential=False, memmap_dir=None)
    assert rb.capacity == 100 and rb.spill.capacity == 1000
    assert rb.describe() == "a device ring on cpu (100 steps/env, a host spill of 1000)"
    rb.spill.close()
    cfg = compose(["exp=sac", "env=dummy", "buffer.memmap=False", "buffer.hbm_window=64"])
    rb = pdr.build_device_replay(cfg, 1000, 2, "cpu", 48, sequential=True, memmap_dir=None)
    assert rb.capacity == 64 and isinstance(rb.spill.buffer, EnvIndependentReplayBuffer)
    rb.spill.close()
    monkeypatch.delenv("SHEEPRL_REPLAY_BUDGET_BYTES")
    rb = pdr.build_device_replay(compose(["exp=sac", "env=dummy"]), 1000, 2, "cpu", 48, False, None)
    assert rb.capacity == 1000 and rb.spill is None and rb.describe() == "a device ring on cpu (1000 steps/env)"
