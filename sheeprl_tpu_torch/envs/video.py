"""Episode videos of an environment (``env.capture_video``): the port's
counterpart of gymnasium 1.2's ``RecordVideo`` as the JAX package's
``make_env`` uses it, written with cv2 in place of moviepy.

The trigger is gymnasium's :func:`capped_cubic_video_schedule` (episodes 0,
1, 8, 27, ..., 729, then every 1000th).  A recording starts at the reset
that begins a triggered episode: the frame of that reset, then one per step,
each from the env's ``render()``.  The video ``rl-video-episode-{id}.mp4``
is finished at the next reset or at ``close()``, at the env's
``metadata["render_fps"]`` (30 without one).  Frames stream into cv2's
``VideoWriter`` (``mp4v``, RGB turned to BGR) under a temporary name, and
the file takes its name when the video is finished, so a finished name is a
whole video; a writer that does not open raises.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Optional

import numpy as np

from sheeprl_tpu_torch.envs.dummy import Env
from sheeprl_tpu_torch.envs.wrappers import Wrapper


def capped_cubic_video_schedule(episode_id: int) -> bool:
    """Gymnasium's default episode trigger: every cube up to 1000, then
    every 1000th episode."""
    if episode_id < 1000:
        return int(round(episode_id ** (1.0 / 3))) ** 3 == episode_id
    return episode_id % 1000 == 0


class VideoWriter:
    """One mp4 file written frame by frame with cv2 (``mp4v``)."""

    def __init__(self, path: str, fps: float):
        self.path, self.fps = path, float(fps)
        self._partial = os.path.join(os.path.dirname(path), f".{os.path.basename(path)[:-4]}.partial.mp4")
        self._writer: Any = None
        self.frames = 0

    def write(self, frame: np.ndarray) -> None:
        import cv2

        if frame.dtype != np.uint8 or frame.ndim != 3 or frame.shape[-1] != 3:
            raise ValueError(f"a video frame must be uint8 (H, W, 3), got {frame.dtype} {frame.shape}")
        if self._writer is None:
            height, width = frame.shape[:2]
            self._writer = cv2.VideoWriter(self._partial, cv2.VideoWriter_fourcc(*"mp4v"), self.fps, (width, height))
            if not self._writer.isOpened():
                raise RuntimeError(f"cv2 could not open an mp4v writer for {self.path} ({width}x{height} at "
                                   f"{self.fps} fps)")
        bgr = cv2.cvtColor(frame, cv2.COLOR_RGB2BGR)
        self._writer.write(bgr)
        self.frames += 1

    def close(self) -> None:
        """Finish the file and give it its name."""
        if self._writer is not None:
            self._writer.release()
            self._writer = None
            os.replace(self._partial, self.path)


class RecordVideo(Wrapper):
    """Record the episodes :func:`capped_cubic_video_schedule` picks under
    ``video_folder``, as ``rl-video-episode-{id}.mp4``."""

    def __init__(self, env: Env, video_folder: str):
        super().__init__(env)
        self.video_folder = os.path.abspath(video_folder)
        os.makedirs(self.video_folder, exist_ok=True)
        self.frames_per_sec = self.metadata.get("render_fps", 30)
        self.episode_id = -1
        self._video: Optional[VideoWriter] = None

    @property
    def recording(self) -> bool:
        return self._video is not None

    def reset(self, **kwargs: Any):
        obs, info = self.env.reset(**kwargs)
        self.episode_id += 1
        self.stop_recording()
        if capped_cubic_video_schedule(self.episode_id):
            path = os.path.join(self.video_folder, f"rl-video-episode-{self.episode_id}.mp4")
            self._video = VideoWriter(path, self.frames_per_sec)
            self._capture_frame()
        return obs, info

    def step(self, action: Any):
        out = self.env.step(action)
        if self.recording:
            self._capture_frame()
        return out

    def _capture_frame(self) -> None:
        frame = self.env.render()
        if isinstance(frame, np.ndarray):
            self._video.write(frame)
        else:
            self.stop_recording()
            warnings.warn(f"Recording stopped: the env's render() returned {type(frame).__name__}, not a frame",
                          RuntimeWarning)

    def stop_recording(self) -> None:
        video, self._video = self._video, None
        if video is not None and video.frames == 0:
            warnings.warn("Ignored saving a video as there were zero frames to save.", RuntimeWarning)
        elif video is not None:
            video.close()

    def close(self) -> None:
        super().close()
        self.stop_recording()
