"""``env.capture_video``: episode videos written with cv2, in the layout of
gymnasium 1.2's ``RecordVideo`` as the JAX package's ``make_env`` uses it
(``sheeprl_tpu/utils/env.py``).

Neither machine has moviepy, so JAX's wrapper cannot write here; the port's
follows its rules: gymnasium's capped cubic episode trigger, files
``rl-video-episode-{id}.mp4`` under ``{run_name}/videos`` (``test_videos``
for the test env), env 0 of rank 0 only, ``render_fps`` (else 30), a frame
at the reset that starts a recording and one per step, the video finished
at the next reset or at ``close()``.  Each file decodes to the recorded
frames at the env's H x W; ``mp4v`` is lossy: on CartPole's 400 x 600
frames the decoded pixels differ from the rendered ones by 3.64 on average
(of 255, at most 97 on the edges of the cart; measured with cv2 5.0 on this
test's episode and two other seeds), and the test holds the mean to 5.
"""

import glob
import pathlib

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.config.compose import compose
from sheeprl_tpu_torch.envs.dummy import DiscreteDummyEnv, PixelGridDummyEnv
from sheeprl_tpu_torch.envs.video import VideoWriter, capped_cubic_video_schedule
from sheeprl_tpu_torch.utils.env import make_env

CODEC_MEAN_ABS = 5.0  # decoded vs rendered pixels, mean absolute difference (of 255)


def _decode(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return np.stack(frames), fps


def test_the_episode_trigger_is_gymnasiums():
    cubes = {0, 1, 8, 27, 64, 125, 216, 343, 512, 729}
    assert [e for e in range(5001) if capped_cubic_video_schedule(e)] == sorted(cubes | {1000, 2000, 3000, 4000, 5000})


@pytest.mark.parametrize("env_cls", [DiscreteDummyEnv, PixelGridDummyEnv])
def test_the_dummy_envs_render_their_rgb(env_cls):
    env = env_cls()
    obs, _ = env.reset(seed=0)
    np.testing.assert_array_equal(env.render(), obs["rgb"])
    obs, *_ = env.step(env.action_space.sample())
    np.testing.assert_array_equal(env.render(), obs["rgb"])


def test_a_recorded_episode_decodes_to_its_frames(tmp_path, monkeypatch):
    """CartPole (``exp=ppo``'s default env) through ``make_env``: the build's
    seeded reset is episode 0 (one frame); episode 1 is the reset and every
    step until ``close()``, at CartPole's 50 fps and its 400 x 600 frames."""
    from sheeprl_tpu_torch.envs.gymnasium_env import GymnasiumEnv

    rendered = []
    render = GymnasiumEnv.render
    monkeypatch.setattr(GymnasiumEnv, "render", lambda self: rendered.append(render(self)) or rendered[-1])
    cfg = compose(["exp=ppo", "fabric.accelerator=cpu"])
    assert cfg.env.capture_video  # the default
    env = make_env(cfg, 3, 0, run_name=str(tmp_path))()
    env.reset()
    steps = 0
    for steps in range(1, 13):
        if env.step(env.action_space.sample())[2]:
            break
    env.close()
    assert sorted(p.name for p in (tmp_path / "videos").iterdir()) == ["rl-video-episode-0.mp4",
                                                                      "rl-video-episode-1.mp4"]
    first, _ = _decode(tmp_path / "videos" / "rl-video-episode-0.mp4")
    frames, fps = _decode(tmp_path / "videos" / "rl-video-episode-1.mp4")
    assert first.shape == (1, 400, 600, 3) and frames.shape == (steps + 1, 400, 600, 3) and fps == 50
    assert len(rendered) == steps + 2
    err = np.abs(frames.astype(np.float32) - np.stack(rendered[1:]).astype(np.float32)).mean()
    assert err <= CODEC_MEAN_ABS, err


@pytest.mark.parametrize("sync_env", [True, False], ids=["loop_thread", "workers"])
def test_exp_ppo_records_env_0_at_the_schedules_episodes(tmp_path, sync_env):
    """``exp=ppo`` on CartPole-v1 with no ``capture_video`` override (and
    ``matmul_precision=high``, which a CPU run checks and leaves alone):
    env 0 records episodes 0, 1 and 8 of its 5-step episodes, in either env
    mode; the test episode records under ``test_videos``; no other env
    writes."""
    from sheeprl_tpu_torch.cli import run

    before = torch.get_float32_matmul_precision()
    run(["exp=ppo", "fabric.accelerator=cpu", f"env.sync_env={sync_env}", "env.num_envs=2",
         "env.max_episode_steps=5", "algo.rollout_steps=48", "algo.per_rank_batch_size=48", "algo.update_epochs=1",
         "dry_run=True", "matmul_precision=high", "metric/logger=csv", f"log_dir={tmp_path}"])
    assert torch.get_float32_matmul_precision() == before
    (version,) = glob.glob(f"{tmp_path}/**/version_0", recursive=True)
    videos = sorted(str(pathlib.Path(p).relative_to(version)) for p in glob.glob(f"{version}/**/*.mp4",
                                                                                   recursive=True))
    assert videos == ["test_videos/rl-video-episode-0.mp4", "test_videos/rl-video-episode-1.mp4",
                      "videos/rl-video-episode-0.mp4", "videos/rl-video-episode-1.mp4",
                      "videos/rl-video-episode-8.mp4"]
    for name in ("videos/rl-video-episode-1.mp4", "videos/rl-video-episode-8.mp4"):
        frames, _ = _decode(pathlib.Path(version) / name)
        assert frames.shape[1:] == (400, 600, 3) and 2 <= len(frames) <= 6  # the reset and 1-5 steps


STOCK = ["ppo", "a2c", "ppo_recurrent", "sac", "droq", "sac_ae", "dreamer_v1", "dreamer_v2", "dreamer_v3",
         "p2e_dv3_exploration"]


@pytest.mark.parametrize("exp", STOCK)
def test_the_stock_recipes_build_their_first_env(tmp_path, exp):
    """Composed with no override (``capture_video: True``), each builds env 0
    with a run name, as its loop does, and records the build's reset."""
    cfg = compose([f"exp={exp}", "fabric.accelerator=cpu"])
    assert cfg.env.capture_video
    env = make_env(cfg, cfg.seed, 0, run_name=str(tmp_path), vector_env_idx=0)()
    other = make_env(cfg, cfg.seed + 1, 0, run_name=str(tmp_path), vector_env_idx=1)()
    env.step(env.action_space.sample())
    env.close()
    other.close()
    assert [p.name for p in (tmp_path / "videos").iterdir()] == ["rl-video-episode-0.mp4"]


def test_a_writer_that_does_not_open_raises(tmp_path):
    writer = VideoWriter(str(tmp_path / "missing" / "v.mp4"), 30)
    with pytest.raises(RuntimeError, match="could not open an mp4v writer"):
        writer.write(np.zeros((8, 8, 3), np.uint8))
