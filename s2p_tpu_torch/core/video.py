"""Eval-rollout videos: the port of ``s2p_tpu/core/video.py``.

``VideoSaveFunction`` (rlkit's ``visualization/video.py``) is a post-epoch
hook: every ``save_video_period`` epochs (and at the last) it rolls out the
policy and ``dump_video`` writes the NHWC uint8 frames as mp4, or gif when
no mp4 writer is there. ``imageio`` is imported when a video is written,
so the package and ``--no_video`` runs do without it; writing a video
without it raises.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Callable, Optional

import numpy as np

from s2p_tpu_torch.samplers.rollout import rollout as default_rollout


def write_video(path: str, frames: np.ndarray, fps: int = 20) -> str:
    """frames [T, H, W, C] uint8 → mp4 (or gif fallback)."""
    import imageio.v2 as imageio

    frames = np.asarray(frames, np.uint8)
    try:
        imageio.mimwrite(path, list(frames), fps=fps)
    except (ValueError, RuntimeError, ImportError):  # no mp4 writer (imageio-ffmpeg)
        path = osp.splitext(path)[0] + ".gif"
        imageio.mimwrite(path, list(frames), duration=1.0 / fps)
    return path


def dump_video(
    env,
    policy,
    filename: str,
    rollout_fn: Callable = default_rollout,
    horizon: int = 100,
    num_rollouts: int = 1,
    fps: int = 20,
    image_key: str = "image_observations",
    **rollout_kwargs,
) -> Optional[str]:
    """Roll out and write frames (reference util/video.py:33-98)."""
    all_frames = []
    for _ in range(num_rollouts):
        path = rollout_fn(
            env, policy, max_path_length=horizon,
            render_image_for_video_when_state_rl=image_key not in ("observations",),
            **rollout_kwargs,
        )
        frames = path.get(image_key)
        if frames is None:
            obs = np.asarray(path["observations"])
            if obs.ndim < 4:
                return None  # nothing renderable
            frames = obs
        all_frames.append(np.asarray(frames))
    frames = np.concatenate(all_frames, axis=0)
    if frames.dtype != np.uint8:
        frames = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    return write_video(filename, frames, fps=fps)


class VideoSaveFunction:
    """post_epoch hook (reference visualization/video.py:6-35)."""

    def __init__(
        self,
        env,
        policy,
        log_dir: str,
        tag: str = "eval",
        save_video_period: int = 5,
        horizon: int = 100,
        fps: int = 20,
        **rollout_kwargs,
    ):
        self.env = env
        self.policy = policy
        self.log_dir = osp.join(log_dir, "videos")
        self.tag = tag
        self.save_video_period = save_video_period
        self.horizon = horizon
        self.fps = fps
        self.rollout_kwargs = rollout_kwargs
        os.makedirs(self.log_dir, exist_ok=True)

    def __call__(self, algo, epoch: int) -> Optional[str]:
        if epoch % self.save_video_period != 0 and epoch != algo.num_epochs - 1:
            return None
        filename = osp.join(
            self.log_dir, f"{self.tag}_video_{epoch}_env.mp4"
        )
        return dump_video(
            self.env, self.policy, filename, horizon=self.horizon,
            fps=self.fps, **self.rollout_kwargs,
        )
