"""Preemption in the port (``sheeprl_tpu_torch/checkpoint/preemption.py`` and
the checkpoint manager), on the CPU.

The guard's units are held to the JAX package's ``PreemptionGuard``: the
first SIGTERM latches, a second restores the previous disposition and
re-delivers itself, ``clear_latch`` keeps the handlers, and nothing is
installed off the main thread.  The manager's ``should_save`` installs the
latch and answers True once it is set, and ``save`` is then synchronous.
The end-to-end drill mirrors ``tests/test_checkpoint/test_preempt_resume.py``:
a tiny SAC run through ``python -m sheeprl_tpu_torch`` is sent SIGTERM, exits
0 with a verified commit, and ``checkpoint.resume_from=auto`` continues its
counters, generators and replay cursor.  A DreamerV3 run preempted in the
process exits after its committed save without its test episode.
"""

import glob
import os
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

from sheeprl_tpu.checkpoint.preemption import PreemptionGuard as JaxPreemptionGuard
from sheeprl_tpu_torch.checkpoint.preemption import PREEMPTION_GUARD, PreemptionGuard
from sheeprl_tpu_torch.checkpoint.protocol import (
    checkpoint_step,
    list_checkpoints,
    load_step_dir,
    verify_checkpoint,
    write_shard,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _restore_handlers():
    PREEMPTION_GUARD.reset()  # an earlier in-process run may have installed it
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    PREEMPTION_GUARD.reset()
    for s, h in saved.items():
        signal.signal(s, h)


@pytest.mark.parametrize("guard_cls", [PreemptionGuard, JaxPreemptionGuard], ids=["torch", "jax"])
def test_guard_latches_then_redelivers_the_second_signal(guard_cls):
    received = []
    signal.signal(signal.SIGTERM, lambda signum, frame: received.append(signum))
    guard = guard_cls()
    assert guard.install() and guard.install()  # idempotent
    os.kill(os.getpid(), signal.SIGTERM)
    assert guard.requested() and guard.signal_name == "SIGTERM" and received == []
    # the second signal: the previous handler is back and gets it
    os.kill(os.getpid(), signal.SIGTERM)
    assert received == [signal.SIGTERM]
    assert signal.getsignal(signal.SIGTERM) is not guard._handle
    guard.reset()


@pytest.mark.parametrize("guard_cls", [PreemptionGuard, JaxPreemptionGuard], ids=["torch", "jax"])
def test_guard_clear_latch_keeps_the_handlers(guard_cls):
    guard = guard_cls()
    guard.install()
    os.kill(os.getpid(), signal.SIGINT)
    assert guard.requested() and guard.signal_name == "SIGINT"
    guard.clear_latch()
    assert not guard.requested() and guard.signal_name is None
    os.kill(os.getpid(), signal.SIGINT)  # still latched, not a KeyboardInterrupt
    assert guard.requested()
    guard.reset()
    assert signal.getsignal(signal.SIGINT) is not guard._handle


@pytest.mark.parametrize("guard_cls", [PreemptionGuard, JaxPreemptionGuard], ids=["torch", "jax"])
def test_guard_installs_only_on_the_main_thread(guard_cls):
    guard, out = guard_cls(), []
    t = threading.Thread(target=lambda: out.append(guard.install()))
    t.start()
    t.join(10)
    assert out == [False] and not t.is_alive()
    assert signal.getsignal(signal.SIGTERM) is not guard._handle


def _manager(tmp_path, **ckpt):
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.utils.structured import dotdict

    return CheckpointManager(dotdict({"checkpoint": {"every": 100, "save_last": False, **ckpt}}), tmp_path)


def test_manager_saves_at_once_and_synchronously_once_preempted(tmp_path):
    mgr = _manager(tmp_path)
    assert not mgr.should_save(10, 0)  # installs the latch
    assert signal.getsignal(signal.SIGTERM) == PREEMPTION_GUARD._handle
    os.kill(os.getpid(), signal.SIGTERM)
    assert mgr.preempted and mgr.should_save(11, 0)
    step_dir = mgr.save(11, {"w": torch.ones(3)})
    # synchronous: committed on return, no writer thread was made
    assert mgr._writer is None and verify_checkpoint(step_dir) == [] and mgr.latest() == step_dir
    mgr.finalize()

    off = _manager(tmp_path / "off", save_on_preemption=False)
    PREEMPTION_GUARD.reset()
    off.should_save(1, 0)
    assert signal.getsignal(signal.SIGTERM) != PREEMPTION_GUARD._handle
    off.force_preempt()
    assert off.preempted and off.should_save(2, 0)


# -- the end-to-end drill ---------------------------------------------------------------
COMMON = [
    "exp=sac", "env=dummy", "env.id=continuous_dummy", "env.num_envs=2", "env.capture_video=False",
    "env.max_episode_steps=8", "fabric.accelerator=cpu", "algo.total_steps=100000",
    "algo.per_rank_batch_size=4", "algo.learning_starts=4", "algo.mlp_keys.encoder=[state]",
    "algo.actor.hidden_size=8", "algo.critic.hidden_size=8", "algo.run_test=False", "checkpoint.every=20",
    "buffer.size=512", "buffer.memmap=False", "buffer.checkpoint=True", "metric.log_level=0",
    "root_dir=preempt_e2e", "seed=42",
]


def _launch(tmp_path, run_name, extra=()):
    return subprocess.Popen(
        [sys.executable, "-m", "sheeprl_tpu_torch", *COMMON, f"log_dir={tmp_path}/logs", f"run_name={run_name}",
         *extra],
        env={**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")},
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def _committed(tmp_path, min_step=-1):
    out = []
    for root in glob.glob(f"{tmp_path}/logs/**/checkpoint", recursive=True):
        out.extend(d for d in list_checkpoints(root) if checkpoint_step(d) > min_step)
    return sorted(out, key=checkpoint_step)


def _preempt_after_commit(proc, tmp_path, min_step=-1, timeout=60):
    deadline = time.monotonic() + timeout
    while not _committed(tmp_path, min_step):
        if proc.poll() is not None or time.monotonic() > deadline:
            proc.kill()
            raise AssertionError(f"no commit past step {min_step}, rc={proc.poll()}:\n{proc.communicate()[0][-4000:]}")
        time.sleep(0.1)
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=60)
    return proc.returncode, out


def test_sigterm_commits_and_auto_resume_continues(tmp_path):
    rc, out_a = _preempt_after_commit(_launch(tmp_path, "run_a"), tmp_path)
    assert rc == 0, out_a[-4000:]
    assert "Preemption: committed checkpoint" in out_a
    newest = _committed(tmp_path)[-1]
    assert verify_checkpoint(newest) == []
    saved = load_step_dir(newest)
    for key in ("agent", "opt_state", "generators", "update", "policy_step", "rb", "ratio", "grad_steps"):
        assert key in saved, key
    assert saved["policy_step"] == checkpoint_step(newest)

    # a torn snapshot at a higher step is never chosen
    torn = newest.parent / f"step_{10**9:012d}"
    torn.mkdir()
    write_shard(torn, 0, {"corrupt": True})

    rc, out_b = _preempt_after_commit(_launch(tmp_path, "run_b", ["checkpoint.resume_from=auto"]), tmp_path,
                                      min_step=saved["policy_step"])
    assert rc == 0, out_b[-4000:]
    assert f"checkpoint.resume_from=auto -> {newest}" in out_b
    resumed = load_step_dir(_committed(tmp_path, min_step=saved["policy_step"])[-1])
    k = resumed["update"] - saved["update"]
    assert k >= 1 and resumed["policy_step"] == saved["policy_step"] + 2 * k
    assert resumed["rb"]["pos"] == (saved["rb"]["pos"] + k) % 256  # 512 // 2 envs
    assert resumed["grad_steps"] > saved["grad_steps"]
    # the rows below the restored cursor are the saved ones; run B appended
    pos = saved["rb"]["pos"]
    assert torch.equal(resumed["rb"]["buffer"]["obs"][:pos], saved["rb"]["buffer"]["obs"][:pos])
    # the generators went on from the saved streams, not from the seed
    fresh = torch.Generator().manual_seed(42).get_state()
    assert not torch.equal(saved["generators"]["train"], fresh)
    assert not torch.equal(resumed["generators"]["train"], saved["generators"]["train"])


def test_dreamer_v3_preempted_in_process_exits_after_its_save_without_its_test(tmp_path, monkeypatch):
    """The latch set during a window: the loop saves at that iteration,
    synchronously, and stops without its test episode."""
    from tests.test_torch_train_cli import TINY

    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3
    from sheeprl_tpu_torch.cli import run

    tested, phase = [], dreamer_v3.DV3Trainer.train_phase

    def preempting_phase(self, *args, **kwargs):
        out = phase(self, *args, **kwargs)
        os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(dreamer_v3.DV3Trainer, "train_phase", preempting_phase)
    monkeypatch.setattr(dreamer_v3, "test", lambda *a, **k: tested.append(1))
    run([*TINY, "algo.run_test=True", "algo.total_steps=40", "algo.replay_ratio=0.125", "checkpoint.async_save=True",
         f"log_dir={tmp_path}"])
    (snapshot,) = sorted(glob.glob(f"{tmp_path}/**/checkpoint/step_*", recursive=True))
    state = load_step_dir(snapshot)
    # sequences of 8 can first be sampled at policy step 18: one window of
    # int(18 / 8) updates, then the save
    assert state["policy_step"] == 18 and state["grad_steps"] == 2 and verify_checkpoint(snapshot) == []
    assert tested == [] and PREEMPTION_GUARD.requested()
    # a later run in this interpreter starts un-preempted: it trains to its end
    monkeypatch.undo()
    run([*COMMON, "algo.total_steps=16", "checkpoint.every=0", f"log_dir={tmp_path / 'again'}"])
    (final,) = glob.glob(f"{tmp_path / 'again'}/**/checkpoint/step_*", recursive=True)
    assert load_step_dir(final)["update"] == 8 and not PREEMPTION_GUARD.requested()
