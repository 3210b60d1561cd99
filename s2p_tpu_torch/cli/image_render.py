"""``image_render`` — render the frames of a state dataset by replaying its
simulator states.

The port of the root ``image_render.py``, with the same flags:

    python -m s2p_tpu_torch.cli.image_render --dataset state_dataset.hdf5 \
        --env_name cheetah-run --imsize 100 \
        --output image_numpy_dataset_stack3_imgsize_100.hdf5

For every transition the simulator is set to its recorded ``qpos_qvel``
(``DMCEnv.set_state``) and rendered at ``--imsize``; the image dataset is
the state dataset plus ``image_observations`` and its 3-frame-stack
companions: ``image_observations_tm1``/``_tm2`` (the previous frames within
the episode, the first one repeated at an episode's start) and
``image_observations_tp1`` (the next frame, the last one repeated at an
episode's end). Host work only (MuJoCo rendering and numpy): no flag picks
a device.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", required=True, help="state dataset HDF5 with qpos_qvel")
    p.add_argument("--env_name", default="cheetah-run")
    p.add_argument("--imsize", type=int, default=100)
    p.add_argument("--camera_id", type=int, default=0)
    p.add_argument("--output", default="image_numpy_dataset_stack3_imgsize_100.hdf5")
    return p


def render_images_for_dataset(env, qpos_qvel: np.ndarray, imsize: int,
                              camera_id: int = 0) -> np.ndarray:
    """[N, H, W, 3] uint8 frames, one per recorded state."""
    nq = env.physics.model.nq
    frames = np.empty((len(qpos_qvel), imsize, imsize, 3), np.uint8)
    for i, row in enumerate(qpos_qvel):
        env.set_state(np.asarray(row[:nq]), np.asarray(row[nq:]))
        frames[i] = env.render(height=imsize, width=imsize, camera_id=camera_id)
    return frames


def add_frame_stacks(frames: np.ndarray, timeouts: np.ndarray) -> Dict[str, np.ndarray]:
    """The tm1/tm2/tp1 companions of ``frames`` within each episode (rows
    after the last timeout form one more)."""
    from s2p_tpu_torch.data.hdf5 import episode_slices

    n = len(frames)
    tm1 = np.empty_like(frames)
    tm2 = np.empty_like(frames)
    tp1 = np.empty_like(frames)
    eps = list(episode_slices(timeouts))
    tail = eps[-1].stop if eps else 0
    if tail < n:
        eps.append(slice(tail, n))
    for ep in eps:
        f = frames[ep]
        tm1[ep] = np.concatenate([f[:1], f[:-1]], axis=0)
        tm2[ep] = np.concatenate([f[:1], f[:1], f[:-2]], axis=0) if len(f) > 1 else f
        tp1[ep] = np.concatenate([f[1:], f[-1:]], axis=0)
    return dict(image_observations=frames, image_observations_tm1=tm1,
                image_observations_tm2=tm2, image_observations_tp1=tp1)


def main(argv: Optional[list] = None) -> str:
    args = build_parser().parse_args(argv)

    import h5py

    from s2p_tpu_torch.data.hdf5 import save_dataset
    from s2p_tpu_torch.envs import make_dmc

    with h5py.File(args.dataset, "r") as f:
        ds = {k: f[k][:] for k in f.keys()}
    if "qpos_qvel" not in ds:
        raise ValueError(f"{args.dataset} has no qpos_qvel to replay")

    env = make_dmc(args.env_name, from_pixels=False)
    frames = render_images_for_dataset(env, ds["qpos_qvel"], args.imsize, args.camera_id)
    ds.update(add_frame_stacks(frames, np.asarray(ds["timeouts"]).ravel()))
    save_dataset(args.output, ds)
    print(f"rendered {len(frames)} frames at {args.imsize}px → {args.output}")
    return args.output


if __name__ == "__main__":
    main()
