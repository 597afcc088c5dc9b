"""Environment factory for the port: ``make_env`` and a synchronous vector
env (counterpart of ``sheeprl_tpu/utils/env.py``).

``make_env`` builds the suite env, then the wrapper pipeline of the JAX
factory in its order: ActionRepeat → velocity masking → a Dict observation
space → image resize / grayscale → FrameStack → actions as observation →
reward as observation → reward clipping → TimeLimit; then seeds it.  The
suites: the dummy envs; the device envs (``wrapper.kind: jax``) behind
:class:`~sheeprl_tpu_torch.envs.device.adapter.DeviceEnvAdapter` on the run's
device; gymnasium (``kind: gym``) and DeepMind Control (``kind: dmc``), whose
packages are imported only when such an env is built.  Settings and suites
not ported yet raise, naming their ROADMAP item.  :func:`vectorize` gives the
semantics the JAX loops get from gymnasium's vector envs, same-step
autoreset and episode statistics: on the caller's thread
(``env.sync_env=True``), or in worker processes under a step-deadline
watchdog (:class:`AsyncVectorEnv`, :class:`StepDeadlineVectorEnv`).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.dummy import (
    ContinuousDummyEnv,
    DiscreteDummyEnv,
    Env,
    MultiDiscreteDummyEnv,
    PixelGridDummyEnv,
)
from sheeprl_tpu_torch.envs.wrappers import (
    ActionRepeat,
    ActionsAsObservationWrapper,
    FaultInjectionEnv,
    FrameStack,
    MaskVelocityWrapper,
    RestartOnException,
    RewardAsObservationWrapper,
    TimeLimit,
    TransformReward,
    Wrapper,
)
from sheeprl_tpu_torch.resilience.faults import active_plan
from sheeprl_tpu_torch.telemetry.monitors import RESILIENCE_MONITOR
from sheeprl_tpu_torch.telemetry.recorder import RECORDER

DUMMY_ENVS = {
    "discrete_dummy": DiscreteDummyEnv,
    "multidiscrete_dummy": MultiDiscreteDummyEnv,
    "continuous_dummy": ContinuousDummyEnv,
    "pixel_grid_dummy": PixelGridDummyEnv,
}
#: set in a vector env's worker process: a device env built there steps on the CPU
_IN_WORKER = False
#: the suites whose packages neither the port's CPU host nor its H100 host has
UNPORTED_SUITES = {
    "atari": "ale_py",
    "crafter": "crafter",
    "minedojo": "minedojo",
    "minerl": "minerl",
    "diambra": "diambra",
    "super_mario_bros": "gym_super_mario_bros",
}


def _wrapper_config(cfg: Any) -> Dict[str, Any]:
    """``cfg.env.wrapper`` (a dict, a bare suite name or the "???"
    placeholder) as a dict with a ``kind`` entry."""
    wrapper_cfg = cfg.env.get("wrapper") or {}
    if not isinstance(wrapper_cfg, dict):
        wrapper_cfg = {"kind": str(wrapper_cfg)} if wrapper_cfg != "???" else {}
    return {"kind": "gym", **wrapper_cfg}


def _make_base_env(cfg: Any, seed: Optional[int], render_mode: str) -> Env:
    env_id = cfg.env.id
    wrapper_cfg = _wrapper_config(cfg)
    kind = wrapper_cfg["kind"]
    kwargs = {k: v for k, v in wrapper_cfg.items() if k not in ("kind", "id")}
    if env_id in DUMMY_ENVS:
        return DUMMY_ENVS[env_id](**kwargs)
    if kind == "jax":
        from sheeprl_tpu_torch.envs.device.adapter import DeviceEnvAdapter
        from sheeprl_tpu_torch.envs.device.registry import env_kwargs, make_device_env
        from sheeprl_tpu_torch.fabric import run_device

        env = make_device_env(wrapper_cfg.get("id") or env_id, **env_kwargs(cfg))
        # a vector env's worker touches no card: its device env steps on the CPU
        return DeviceEnvAdapter(env, "cpu" if _IN_WORKER else run_device(cfg))
    if kind == "gym":
        from sheeprl_tpu_torch.envs.gymnasium_env import GymnasiumEnv

        return GymnasiumEnv(env_id, render_mode=render_mode, **kwargs)
    if kind == "dmc":
        from sheeprl_tpu_torch.envs.dmc import DMCWrapper

        return DMCWrapper(env_id, seed=seed, **kwargs)
    if kind in UNPORTED_SUITES:
        raise NotImplementedError(
            f"env.wrapper.kind={kind} is not ported: its package ({UNPORTED_SUITES[kind]}) is on neither machine "
            "the port runs on (ROADMAP.md, queue A item 2)"
        )
    raise ValueError(f"Unknown env wrapper kind '{kind}'")


class _DictObs(Wrapper):
    """Any observation space as a Dict: vectors under 'state', images under 'rgb'."""

    def __init__(self, env: Env):
        super().__init__(env)
        obs_space = env.observation_space
        if isinstance(obs_space, spaces.Dict):
            self._key = None
        else:
            self._key = "rgb" if len(obs_space.shape or ()) == 3 else "state"
            self.observation_space = spaces.Dict({self._key: obs_space})

    def _observation(self, obs: Any) -> Dict[str, Any]:
        return obs if self._key is None else {self._key: obs}

    def reset(self, **kwargs: Any):
        obs, info = self.env.reset(**kwargs)
        return self._observation(obs), info

    def step(self, action: Any):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return self._observation(obs), reward, terminated, truncated, info


class _ImageTransform(Wrapper):
    """Every image key as ``(screen, screen, C)`` uint8: resized with
    ``cv2.INTER_AREA``, turned gray (``COLOR_RGB2GRAY``) or given three
    channels as ``grayscale`` asks, CHW frames turned HWC."""

    def __init__(self, env: Env, cnn_keys: List[str], screen_size: int, grayscale: bool):
        super().__init__(env)
        import cv2

        self._cv2 = cv2
        self._cnn_keys = cnn_keys
        self._screen = screen_size
        self._gray = grayscale
        new_spaces = dict(env.observation_space.spaces)
        for k in cnn_keys:
            new_spaces[k] = spaces.Box(0, 255, (screen_size, screen_size, 1 if grayscale else 3), np.uint8)
        self.observation_space = spaces.Dict(new_spaces)

    def _transform(self, img: np.ndarray) -> np.ndarray:
        cv2 = self._cv2
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[0] in (1, 3) and img.shape[-1] not in (1, 3):
            img = np.transpose(img, (1, 2, 0))
        if img.shape[:2] != (self._screen, self._screen):
            img = cv2.resize(img, (self._screen, self._screen), interpolation=cv2.INTER_AREA)
            if img.ndim == 2:
                img = img[..., None]
        if self._gray and img.shape[-1] == 3:
            img = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)[..., None]
        elif not self._gray and img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        return img.astype(np.uint8)

    def _observation(self, obs: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(obs)
        for k in self._cnn_keys:
            out[k] = self._transform(obs[k])
        return out

    def reset(self, **kwargs: Any):
        obs, info = self.env.reset(**kwargs)
        return self._observation(obs), info

    def step(self, action: Any):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return self._observation(obs), reward, terminated, truncated, info


def make_env(
    cfg: Any,
    seed: Optional[int],
    rank: int = 0,
    run_name: Optional[str] = None,
    prefix: str = "",
    vector_env_idx: int = 0,
) -> "EnvThunk":
    """Build a thunk creating one wrapped environment instance; a device env
    steps on the run's device (``fabric.accelerator``), or on the CPU inside
    a vector env's worker process.  The thunk pickles, so a worker process
    can build its env.  With ``env.capture_video`` env 0 of rank 0 of a run
    (``run_name`` given) records episode videos under ``{run_name}/videos``
    (``{run_name}/{prefix}_videos`` with a ``prefix``), as the JAX package's
    ``make_env`` does (:class:`~sheeprl_tpu_torch.envs.video.RecordVideo`)."""
    return EnvThunk(cfg, seed, rank, vector_env_idx, run_name, prefix)


class EnvThunk:
    """``make_env``'s thunk: a top-level callable, so it pickles into an
    :class:`AsyncVectorEnv` worker (a recorded env records there)."""

    def __init__(self, cfg: Any, seed: Optional[int], rank: int, vector_env_idx: int,
                 run_name: Optional[str] = None, prefix: str = ""):
        self.cfg, self.seed, self.rank, self.vector_env_idx = cfg, seed, rank, vector_env_idx
        self.run_name, self.prefix = run_name, prefix

    def build(self) -> Env:
        cfg, seed = self.cfg, self.seed
        capture = (bool(cfg.env.get("capture_video", False)) and self.rank == 0 and self.vector_env_idx == 0
                   and self.run_name is not None)
        render_mode = "rgb_array" if capture else cfg.env.get("render_mode", "rgb_array")
        env = _make_base_env(cfg, seed, render_mode)
        if cfg.env.action_repeat > 1:
            env = ActionRepeat(env, cfg.env.action_repeat)
        if cfg.env.get("mask_velocities", False):
            # keyed on gymnasium ids: any other env raises, as in the JAX factory
            env = MaskVelocityWrapper(env, cfg.env.id if _wrapper_config(cfg)["kind"] == "gym" else "")
        env = _DictObs(env)
        cnn_keys = [k for k, sp in env.observation_space.spaces.items() if len(sp.shape) in (2, 3)]
        if cnn_keys:
            env = _ImageTransform(env, cnn_keys, cfg.env.screen_size, cfg.env.grayscale)
        if cfg.env.frame_stack > 1 and cnn_keys:
            env = FrameStack(env, cfg.env.frame_stack, cnn_keys, cfg.env.frame_stack_dilation)
        aao = cfg.env.get("actions_as_observation") or {}
        if aao.get("num_stack", -1) > 0:
            env = ActionsAsObservationWrapper(env, aao["num_stack"], aao["noop"], aao.get("dilation", 1))
        if cfg.env.get("reward_as_observation", False):
            env = RewardAsObservationWrapper(env)
        if cfg.env.get("clip_rewards", False):
            env = TransformReward(env, _tanh_reward)
        if cfg.env.max_episode_steps is not None and cfg.env.max_episode_steps > 0:
            env = TimeLimit(env, cfg.env.max_episode_steps)
        if capture:
            from sheeprl_tpu_torch.envs.video import RecordVideo

            env = RecordVideo(env, os.path.join(self.run_name, f"{self.prefix}_videos" if self.prefix else "videos"))
        if seed is not None:
            env.reset(seed=seed + self.rank * cfg.env.num_envs + self.vector_env_idx)
            env.action_space.seed(seed + self.rank * cfg.env.num_envs + self.vector_env_idx)
        # the env fault sites, only when the active plan targets them; after
        # seeding (a construction reset is no target) and inside
        # RestartOnException, so an injected crash takes the real restart path
        plan = active_plan()
        if plan is not None and plan.targets("env."):
            env = FaultInjectionEnv(env)
        return env

    def __call__(self) -> Env:
        if self.cfg.env.get("restart_on_exception", False):
            return RestartOnException(self.build)
        return self.build()


def _tanh_reward(r: float) -> float:
    return float(np.tanh(r))


class _Slot:
    """One env of a vector env with its episode's running return and
    length: the same-step autoreset both vector envs share."""

    def __init__(self, env: Env):
        self.env = env
        self.ret, self.len = 0.0, 0

    def reset(self, seed: Optional[int]) -> Tuple[Any, Dict[str, Any]]:
        self.ret, self.len = 0.0, 0
        return self.env.reset(seed=seed)

    def step(self, action: Any) -> tuple:
        """``(obs, reward, terminated, truncated, info, final_obs, episode)``:
        a finished episode is reset within the step; ``final_obs`` is its
        last observation and ``episode`` its (return, length), else None."""
        o, r, term, trunc, info = self.env.step(action)
        self.ret += float(r)
        self.len += 1
        final = episode = None
        if term or trunc:
            final, episode = o, (self.ret, self.len)
            self.ret, self.len = 0.0, 0
            o, reset_info = self.env.reset()
            info = {**info, **reset_info}
        return o, float(r), bool(term), bool(trunc), info, final, episode


def _stack(obs: List[Any]) -> Any:
    if isinstance(obs[0], dict):
        return {k: np.stack([np.asarray(o[k]) for o in obs]) for k in obs[0]}
    return np.stack([np.asarray(o) for o in obs])


def _merge_infos(infos: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-env info dicts → one dict of arrays, each key with its mask ``"_" + key``."""
    n, into = len(infos), {}
    for i, info in enumerate(infos):
        for k, v in info.items():
            if k not in into:
                into[k] = np.zeros(n, dtype=np.asarray(v).dtype) if np.isscalar(v) else np.empty(n, object)
                into["_" + k] = np.zeros(n, bool)
            into[k][i] = v
            into["_" + k][i] = True
    return into


def _collate_resets(results: List[Tuple[Any, Dict[str, Any]]]) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    return _stack([o for o, _ in results]), _merge_infos([i for _, i in results])


def _collate_steps(results: List[tuple]):
    """The :meth:`_Slot.step` results of every env as one vector step."""
    n = len(results)
    obs = [r[0] for r in results]
    rewards = np.array([r[1] for r in results], np.float64)
    terminated = np.array([r[2] for r in results], bool)
    truncated = np.array([r[3] for r in results], bool)
    out_info = _merge_infos([r[4] for r in results])
    done_mask = np.array([r[6] is not None for r in results], bool)
    if done_mask.any():
        final_obs = np.empty(n, object)
        ep_r = np.zeros(n, np.float64)
        ep_l = np.zeros(n, np.int64)
        for i, r in enumerate(results):
            if r[6] is not None:
                final_obs[i] = r[5]
                ep_r[i], ep_l[i] = r[6]
        out_info["final_obs"], out_info["_final_obs"] = final_obs, done_mask
        out_info["episode"], out_info["_episode"] = {"r": ep_r, "l": ep_l}, done_mask
    return _stack(obs), rewards, terminated, truncated, out_info


class SyncVectorEnv:
    """``n`` envs stepped in turn on the caller's thread.

    Same-step autoreset: an env whose episode ends is reset within the same
    ``step``; the returned observation is the reset's, the final one is in
    ``info["final_obs"]`` (an object array, None for running envs).  Finished
    episodes report their return and length in ``info["episode"]`` under
    the mask ``info["_episode"]``; other per-env info keys become arrays
    under ``info[key]`` with the mask ``info["_" + key]``."""

    def __init__(self, thunks: List[Callable[[], Env]]):
        self.envs = [t() for t in thunks]
        self._slots = [_Slot(env) for env in self.envs]
        self.num_envs = len(self.envs)
        self.single_observation_space = self.envs[0].observation_space
        self.single_action_space = self.envs[0].action_space

    def reset(self, seed: Optional[int] = None) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        return _collate_resets([s.reset(None if seed is None else seed + i) for i, s in enumerate(self._slots)])

    def step(self, actions: np.ndarray):
        return _collate_steps([s.step(actions[i]) for i, s in enumerate(self._slots)])

    def describe(self) -> str:
        return f"{self.num_envs} env(s) stepped synchronously"

    def close(self) -> None:
        for env in self.envs:
            env.close()


class RemoteTraceback(Exception):
    """The traceback of an exception raised in a worker process, attached
    as the ``__cause__`` of the exception raised again in the parent."""

    def __init__(self, tb: str):
        super().__init__(tb)
        self.tb = tb

    def __str__(self) -> str:
        return self.tb


def _worker(index: int, thunk: Callable[[], Env], pipe: Any, parent_pipe: Any, plan_json: Optional[str],
            parent_pid: int) -> None:
    """One env in its own process: build it, send its spaces, then serve
    ``reset`` / ``step`` / ``close`` commands until closed or the parent goes
    away.  SIGINT and SIGTERM are ignored, so a signal to the process group
    reaches the parent's preemption guard alone and the envs stay alive for
    its committed save; the parent ends a worker with ``close`` or SIGKILL.
    An exception is sent back with its traceback, and the worker exits."""
    import signal
    import traceback

    global _IN_WORKER
    _IN_WORKER = True
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    _exit_with(parent_pid)
    parent_pipe.close()
    from sheeprl_tpu_torch.resilience.faults import FaultPlan, install_plan

    slot = None
    try:
        # the parent's fault plan, so env.step / env.reset faults fire here
        install_plan(FaultPlan.from_json(plan_json) if plan_json else None)
        slot = _Slot(thunk())
        pipe.send(("ok", (slot.env.observation_space, slot.env.action_space)))
        while True:
            try:
                cmd, data = pipe.recv()
            except (EOFError, OSError):
                break
            if cmd == "step":
                pipe.send(("ok", slot.step(data)))
            elif cmd == "reset":
                pipe.send(("ok", slot.reset(data)))
            elif cmd == "close":
                pipe.send(("ok", None))
                break
            else:
                raise RuntimeError(f"unknown vector env command {cmd!r}")
    except BaseException as e:  # noqa: BLE001 - every failure goes back to the parent
        import pickle

        tb = traceback.format_exc()
        try:
            pickle.dumps(e)
        except Exception:  # an exception that does not pickle goes back as its text
            e = RuntimeError(f"{type(e).__name__}: {e}")
        try:
            pipe.send(("error", (index, e, tb)))
        except (OSError, ValueError):
            pass
    finally:
        if slot is not None:
            try:
                slot.env.close()
            except Exception:
                pass
        pipe.close()


def _exit_with(parent_pid: int, poll_s: float = 1.0) -> None:
    """End this worker when the process that owns its vector env is gone,
    even while its env is wedged in a step: no worker outlives a killed
    run.  (A worker's parent is the fork server, which a signal to the
    process group may end first; the owner is what counts.)"""
    import threading

    def watch() -> None:
        while True:
            time.sleep(poll_s)
            try:
                os.kill(parent_pid, 0)
            except ProcessLookupError:
                os._exit(1)
            except PermissionError:
                pass

    threading.Thread(target=watch, name="owner-watch", daemon=True).start()


def _kill(pid: Optional[int]) -> None:
    """SIGKILL ``pid`` if it is still there.  By pid: a worker whose fork
    server has died reads as ended to ``multiprocessing`` while it runs on."""
    import signal

    if pid is None:
        return
    try:
        os.kill(pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass


def pid_alive(pid: int) -> bool:
    """Whether ``pid`` names a live process (a zombie counts as ended)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (FileNotFoundError, ProcessLookupError, IndexError):
        return False
    except OSError:
        try:
            os.kill(pid, 0)
            return True
        except ProcessLookupError:
            return False


#: seconds a new worker has to build its env and report its spaces
WORKER_START_S = 120.0


def worker_context() -> Any:
    """The ``multiprocessing`` context the workers start from: ``forkserver``
    (``spawn`` where there is none), the env stack preloaded in the server
    so each worker forks with it imported.  Starting the server early (this
    call, ahead of the first vector env) takes its start out of the way."""
    context = "forkserver" if "forkserver" in mp.get_all_start_methods() else "spawn"
    ctx = mp.get_context(context)
    if context == "forkserver":
        from multiprocessing import forkserver

        ctx.set_forkserver_preload(["sheeprl_tpu_torch.utils.env"])
        forkserver.ensure_running()
    return ctx


#: vector envs with live workers, killed at interpreter exit (the workers
#: ignore the SIGTERM multiprocessing's own exit handler sends)
_LIVE: Any = None


def _kill_live_workers() -> None:
    for env in list(_LIVE or ()):
        env.close(terminate=True)


class AsyncVectorEnv:
    """``n`` envs, each stepped in a worker process of its own, with the
    same-step autoreset and the info contract of :class:`SyncVectorEnv`.

    Workers start with ``forkserver`` (``spawn`` where there is none): the
    parent may hold a CUDA context and run threads, which ``fork`` would
    copy; a worker imports no CUDA and builds a device env on the CPU.  The
    active fault plan is handed to each worker.  ``step_async`` /
    ``step_wait(timeout)`` and ``reset_async`` / ``reset_wait(timeout)``
    split a call so a watchdog can bound it (``multiprocessing.TimeoutError``
    past ``timeout``); ``close(timeout, terminate)`` ends the workers,
    killing those that do not stop in time.  A worker's exception is raised
    again here with the worker's traceback as its cause."""

    def __init__(self, thunks: List[Callable[[], Env]]):
        import weakref

        global _LIVE
        ctx = worker_context()
        plan = active_plan()
        plan_json = plan.to_json() if plan else None
        self.num_envs = len(thunks)
        self.closed = False
        self._pipes: List[Any] = []
        self._procs: List[Any] = []
        self._pending: Optional[str] = None
        if _LIVE is None:
            import atexit

            _LIVE = weakref.WeakSet()
            atexit.register(_kill_live_workers)
        _LIVE.add(self)
        try:
            for i, thunk in enumerate(thunks):
                parent, child = ctx.Pipe()
                proc = ctx.Process(target=_worker, args=(i, thunk, child, parent, plan_json, os.getpid()),
                                   name=f"AsyncVectorEnv-worker-{i}", daemon=True)
                proc.start()
                child.close()
                self._pipes.append(parent)
                self._procs.append(proc)
            spaces_ = self._receive_all(WORKER_START_S, "start")
        except BaseException:
            self.close(terminate=True)
            raise
        self.single_observation_space, self.single_action_space = spaces_[0]

    # -- the pipe protocol ---------------------------------------------------
    def _send_all(self, cmd: str, data: List[Any]) -> None:
        if self.closed:
            raise RuntimeError("the vector env is closed")
        if self._pending is not None:
            raise RuntimeError(f"a {self._pending} is still pending: call {self._pending}_wait first")
        for pipe, d in zip(self._pipes, data):
            pipe.send((cmd, d))
        self._pending = cmd

    def _receive_all(self, timeout: Optional[float], what: str) -> List[Any]:
        deadline = None if timeout is None else time.monotonic() + float(timeout)
        results = []
        for i, pipe in enumerate(self._pipes):
            left = None if deadline is None else max(deadline - time.monotonic(), 0.0)
            if not pipe.poll(left):
                raise mp.TimeoutError(f"the vector env's {what} exceeded {timeout}s (worker {i} has not answered)")
            try:
                status, payload = pipe.recv()
            except (EOFError, OSError) as e:
                raise RuntimeError(f"vector env worker {i} died (exit code {self._procs[i].exitcode})") from e
            if status == "error":
                self._raise_worker_error(*payload)
            results.append(payload)
        self._pending = None
        return results

    def _raise_worker_error(self, index: int, exc: BaseException, tb: str) -> None:
        self._pending = None
        if getattr(exc, "env_restarts", None) is not None:
            # the worker's RestartOnException gave up: leave its evidence
            # here, where the run directory is known
            RECORDER.record("watchdog.giveup", reason="env crashed", restarts=exc.env_restarts)
            RECORDER.dump("watchdog")
        self.close(terminate=True)
        exc.__cause__ = RemoteTraceback(f"\n\nin vector env worker {index}:\n{tb}")
        raise exc

    # -- the vector env API --------------------------------------------------
    def reset_async(self, seed: Optional[int] = None) -> None:
        self._send_all("reset", [None if seed is None else seed + i for i in range(self.num_envs)])

    def reset_wait(self, timeout: Optional[float] = None) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        return _collate_resets(self._receive_all(timeout, "reset"))

    def reset(self, seed: Optional[int] = None) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        self.reset_async(seed)
        return self.reset_wait()

    def step_async(self, actions: np.ndarray) -> None:
        self._send_all("step", [actions[i] for i in range(self.num_envs)])

    def step_wait(self, timeout: Optional[float] = None):
        return _collate_steps(self._receive_all(timeout, "step"))

    def step(self, actions: np.ndarray):
        self.step_async(actions)
        return self.step_wait()

    def close(self, timeout: Optional[float] = None, terminate: bool = False) -> None:
        """End the workers: with ``terminate`` kill them at once, else ask
        each to close and kill those that have not ended within ``timeout``
        seconds (a pending call is waited for first, within the same time)."""
        if self.closed:
            return
        self.closed = True
        if _LIVE is not None:
            _LIVE.discard(self)
        wait = 5.0 if timeout is None else float(timeout)
        if not terminate:
            deadline = time.monotonic() + wait
            for pipe, proc in zip(self._pipes, self._procs):
                try:
                    if self._pending is not None and pipe.poll(max(deadline - time.monotonic(), 0.0)):
                        pipe.recv()
                    pipe.send(("close", None))
                except (EOFError, OSError, BrokenPipeError):
                    pass
            for proc in self._procs:
                proc.join(max(deadline - time.monotonic(), 0.0))
        for proc in self._procs:
            if terminate or pid_alive(proc.pid):
                _kill(proc.pid)
        for proc in self._procs:
            proc.join(5.0)
        for pipe in self._pipes:
            pipe.close()
        self._pending = None

    @property
    def processes(self) -> List[Any]:
        return list(self._procs)

    def describe(self) -> str:
        return f"{self.num_envs} env(s) in worker processes"


class StepDeadlineVectorEnv:
    """A watchdog around :class:`AsyncVectorEnv` (counterpart of the JAX
    package's): a wedged worker no longer wedges the run.

    ``RestartOnException`` inside each worker catches exceptions only; a
    worker that stops answering would block ``step`` forever.  Each step and
    reset runs as ``*_async`` + ``*_wait(timeout=deadline_s)``; a miss tears
    the whole vector env down (its workers killed), recreates it from the
    original thunks, resets it under the same deadline, and reports the
    break through ``info["restart_on_exception"]`` and its mask for every
    env, so the sequence replay repairs its tails.  At most
    ``max_restarts`` teardowns within ``window_s`` seconds; past that the
    give-up is recorded and dumped (``watchdog``) and ``RuntimeError``
    propagates."""

    def __init__(self, make_vec: Callable[[], AsyncVectorEnv], deadline_s: float, max_restarts: int = 3,
                 window_s: float = 600.0):
        from collections import deque

        self._make_vec = make_vec
        self._deadline = float(deadline_s)
        self._max_restarts = int(max_restarts)
        self._window = float(window_s)
        self._restart_times: Any = deque()
        self._env = make_vec()

    def __getattr__(self, name: str) -> Any:
        # spaces, num_envs, ... delegate to the live env; private names never
        # do, so a failed construction raises instead of recursing
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._env, name)

    @property
    def unwrapped(self) -> AsyncVectorEnv:
        return self._env

    def _spend_restart_budget(self, reason: str) -> None:
        now = time.monotonic()
        while self._restart_times and now - self._restart_times[0] > self._window:
            self._restart_times.popleft()
        if len(self._restart_times) >= self._max_restarts:
            # the teardown budget is spent and the run dies: leave the
            # evidence now, even if something upstream swallows the raise
            RECORDER.record("watchdog.giveup", reason=reason, restarts=len(self._restart_times))
            RECORDER.dump("watchdog")
            raise RuntimeError(
                f"vector env wedged {len(self._restart_times) + 1} times within {self._window}s ({reason}); giving up"
            )
        self._restart_times.append(now)

    def _teardown_and_recreate(self, reason: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        import warnings

        # the recovery reset has the step's deadline: a worker wedged in it
        # spends budget per attempt and ends in the give-up, never a hang
        while True:
            self._spend_restart_budget(reason)
            warnings.warn(f"vector env watchdog: {reason}; terminating workers and recreating", RuntimeWarning)
            RESILIENCE_MONITOR.record_stall("vecenv.step")
            RESILIENCE_MONITOR.record_env_restart(getattr(self._env, "num_envs", 1))
            try:
                self._env.close(timeout=5.0, terminate=True)
            except (mp.TimeoutError, OSError, RuntimeError, EOFError):
                pass
            self._env = self._make_vec()
            try:
                self._env.reset_async()
                obs, info = self._env.reset_wait(timeout=self._deadline)
                break
            except mp.TimeoutError:
                reason = f"recovery reset exceeded the {self._deadline}s deadline"
        info = dict(info)
        # every env restarted: the whole batch of streams broke
        n = self._env.num_envs
        info["restart_on_exception"] = np.ones(n, dtype=bool)
        info["_restart_on_exception"] = np.ones(n, dtype=bool)
        return obs, info

    def step(self, actions: Any):
        try:
            self._env.step_async(actions)
            return self._env.step_wait(timeout=self._deadline)
        except mp.TimeoutError:
            obs, info = self._teardown_and_recreate(f"step exceeded the {self._deadline}s deadline")
            n = self._env.num_envs
            return obs, np.zeros(n, np.float64), np.zeros(n, bool), np.zeros(n, bool), info

    def reset(self, **kwargs: Any):
        try:
            self._env.reset_async(**kwargs)
            return self._env.reset_wait(timeout=self._deadline)
        except mp.TimeoutError:
            return self._teardown_and_recreate(f"reset exceeded the {self._deadline}s deadline")

    def close(self, **kwargs: Any) -> None:
        self._env.close(**kwargs)

    def describe(self) -> str:
        return f"{self._env.describe()} (step deadline {self._deadline}s)"


def vectorize(cfg: Any, thunks: List[Callable[[], Env]]) -> Any:
    """The envs of ``thunks`` as one vector env, with same-step autoreset.

    ``env.sync_env=True`` steps them in turn on the caller's thread
    (:class:`SyncVectorEnv`); otherwise each runs in a worker process
    (:class:`AsyncVectorEnv`), behind :class:`StepDeadlineVectorEnv` when
    ``env.step_deadline_s`` > 0 (``env.max_vecenv_restarts`` teardowns
    within ``env.vecenv_restart_window_s``).  The sync path has no watchdog:
    a hang there is the caller's own thread."""
    if cfg.env.sync_env:
        return SyncVectorEnv(thunks)

    def make() -> AsyncVectorEnv:
        return AsyncVectorEnv(thunks)

    deadline = float(cfg.env.get("step_deadline_s", 0) or 0)
    if deadline > 0:
        return StepDeadlineVectorEnv(make, deadline, max_restarts=int(cfg.env.get("max_vecenv_restarts", 3) or 3),
                                     window_s=float(cfg.env.get("vecenv_restart_window_s", 600.0) or 600.0))
    return make()


def episode_stats(info: Dict[str, Any]) -> List[Tuple[float, int]]:
    """Finished-episode (return, length) pairs of one vector step."""
    if "episode" not in info:
        return []
    ep, mask = info["episode"], np.asarray(info["_episode"], bool)
    return [(float(ep["r"][i]), int(ep["l"][i])) for i in np.nonzero(mask)[0]]


def final_obs_rows(info: Dict[str, Any], env_indices: np.ndarray, obs_keys) -> Optional[Dict[str, np.ndarray]]:
    """The real final observations of the given env rows, stacked per key
    (None when any of them is missing)."""
    fo = info.get("final_obs")
    if fo is None:
        return None
    rows = [fo[i] for i in env_indices]
    if any(not isinstance(r, dict) for r in rows):
        return None
    return {k: np.stack([np.asarray(r[k]) for r in rows]) for k in obs_keys}
