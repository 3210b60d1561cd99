"""Device-resident replay buffers.

The port of ``s2p_tpu/data/replay.py``:

- ``SlacReplayBuffer``, the SLAC sequence buffer: unique frames live once
  in a uint8 ``[F, H, W, C]`` pool and each slot is ``num_sequences + 1``
  frame indices, so overlapping windows share pixels. Ingestion (real
  datasets, the augmented 1-step datasets with their uncertainty-penalized
  rewards, online episodes) is host numpy and gives the JAX package's
  arrays value for value. ``device_state()`` uploads the live prefix once
  (frames, windows, actions, rewards, dones as tensors on the buffer's
  device) and keeps it until the next ingest; sampling is an index draw
  from a ``torch.Generator`` and one gather on the device.
- ``SimpleReplayBuffer``, the flat transition buffer of state RL, with the
  memory-efficient frame-stack reconstruction.

Frames become floats in [0, 1] as ``x · f32(1/255)``, the factor a tensor on
the frames' device. That is what the JAX package computes (XLA rewrites
its jitted ``x / 255.0`` into this product; an eager JAX or CPU PyTorch
division differs from it in the last bit for about half the values), and a
tensor-by-tensor product rounds the same on the card and on the CPU, where
a division by a Python number would not (PyTorch's CUDA kernel multiplies
by the reciprocal, its CPU kernel divides).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from s2p_tpu_torch.data.hdf5 import SENTINEL, episode_slices

Batch = Dict[str, torch.Tensor]


def frames_to_float(frames: torch.Tensor) -> torch.Tensor:
    """uint8 → f32 in [0, 1] as ``x · f32(1/255)`` with the factor a tensor
    on ``frames``' device (see the module docstring)."""
    return frames.float() * frames.new_tensor(1.0 / 255.0, dtype=torch.float32)


def gather_windows(state: Dict, idx: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(obs [b, ns+1, H, W, C] float in [0, 1], actions [b, ns, A],
    rewards [b, ns, 1], dones [b, ns, 1]) of the slots ``idx`` of a
    ``device_state()``."""
    obs = frames_to_float(state["frames"][state["windows"][idx]])
    return obs, state["actions"][idx], state["rewards"][idx], state["dones"][idx]


def window_batch(obs, act, rew, done) -> Batch:
    """The RL trainers' batch of a window gather: the last step's reward
    and done."""
    return dict(observations=obs, actions=act, rewards=rew[:, -1], terminals=done[:, -1])


def draw_indices(low: int, high: int, batch_size: int, generator: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    return torch.randint(low, high, (batch_size,), generator=generator, device=device)


class SlacReplayBuffer:
    """Episode-aware sequence replay over an indexed frame pool."""

    def __init__(self, capacity: int, num_sequences: int, frame_shape: Tuple[int, int, int],
                 action_dim: int, device: str | torch.device = "cuda") -> None:
        self.capacity = int(capacity)
        self.num_sequences = int(num_sequences)
        self.frame_shape = tuple(frame_shape)
        self.action_dim = int(action_dim)
        self.device = torch.device(device)

        # the pool grows by amortized doubling; _n_frames is its live prefix
        self._frames = np.zeros((0, *self.frame_shape), np.uint8)
        self._n_frames = 0
        self._windows = np.zeros((self.capacity, self.num_sequences + 1), np.int64)
        self._actions = np.zeros((self.capacity, self.num_sequences, action_dim), np.float32)
        self._rewards = np.zeros((self.capacity, self.num_sequences, 1), np.float32)
        self._dones = np.zeros((self.capacity, self.num_sequences, 1), np.float32)
        self._n = 0
        self._real_n = 0  # slots [0, _real_n) came from the real dataset
        self._device_cache: Optional[Dict] = None

        # online streaming state
        self._ep_frame_start: Optional[int] = None
        self._ep_actions: list = []
        self._ep_rewards: list = []
        self._ep_dones: list = []

    def __len__(self) -> int:
        return self._n

    @property
    def real_n(self) -> int:
        return self._real_n

    def mark_real(self) -> None:
        """Everything ingested so far is real data."""
        self._real_n = self._n

    # -- frame pool ---------------------------------------------------------
    def _add_frames(self, frames: np.ndarray) -> int:
        """Append frames to the pool; returns their base index."""
        frames = np.asarray(frames, np.uint8)
        if frames.shape[1:] != self.frame_shape:
            raise ValueError(f"frame shape {frames.shape[1:]} != {self.frame_shape}")
        base = self._n_frames
        need = base + len(frames)
        if need > len(self._frames):
            grown = np.zeros((max(need, 2 * len(self._frames), 64), *self.frame_shape), np.uint8)
            grown[:base] = self._frames[:base]
            self._frames = grown
        self._frames[base:need] = frames
        self._n_frames = need
        self._device_cache = None
        return base

    def _add_slots(self, windows: np.ndarray, actions: np.ndarray, rewards: np.ndarray,
                   dones: np.ndarray) -> None:
        k = len(windows)
        if self._n + k > self.capacity:
            raise ValueError(f"buffer overflow: {self._n}+{k} > capacity {self.capacity}")
        sl = slice(self._n, self._n + k)
        self._windows[sl] = windows
        self._actions[sl] = actions
        self._rewards[sl] = rewards.reshape(k, self.num_sequences, 1)
        self._dones[sl] = dones.reshape(k, self.num_sequences, 1)
        self._n += k
        self._device_cache = None

    # -- offline ingestion --------------------------------------------------
    def ingest_real(self, dataset: Dict[str, np.ndarray]) -> int:
        """One slot per in-episode step t ≥ num_sequences − 1, sliding by 1;
        rows past the last timeout form an episode of their own; the
        dataset's final row is dropped iff it is a timeout row (the
        reference stops before appending it). Returns the slots added."""
        ns = self.num_sequences
        timeouts = np.asarray(dataset["timeouts"]).ravel()
        imgs = dataset["image_observations"]
        imgs_tp1 = dataset["image_observations_tp1"]
        actions = dataset["actions"]
        rewards = np.asarray(dataset["rewards"]).ravel()
        added = 0
        n_rows = len(timeouts)
        eps = list(episode_slices(timeouts))
        tail_start = eps[-1].stop if eps else 0
        if tail_start < n_rows:
            eps.append(slice(tail_start, n_rows))
        for ep in eps:
            start, stop = ep.start, ep.stop
            if stop == n_rows and timeouts[stop - 1] == 1:
                stop -= 1
            length = stop - start
            if length < ns:
                continue
            # the episode's frames: F[0] = imgs[start], F[t+1] = imgs_tp1[start+t]
            base = self._add_frames(np.concatenate([imgs[start:start + 1], imgs_tp1[start:stop]]))
            # the slot of step t (t = ns−1 … length−1) holds frames F[t−ns+1 … t+1]
            t = np.arange(ns - 1, length)[:, None]
            win = base + t - (ns - 1) + np.arange(ns + 1)[None, :]
            step_idx = start + t - (ns - 1) + np.arange(ns)[None, :]
            rews = rewards[step_idx]
            self._add_slots(win, actions[step_idx], rews, np.zeros_like(rews))
            added += len(win)
        return added

    def ingest_generated(self, dataset: Dict[str, np.ndarray],
                         uncertainty_type: Optional[str] = None,
                         uncertainty_penalty_lambda: Optional[float] = None,
                         generated_frames: Optional[np.ndarray] = None) -> int:
        """One slot per valid row of an augmented 1-step dataset: 8 real
        context steps and the generated step, whose reward is penalized by
        λ × the chosen uncertainty. ``generated_frames`` stands in for
        ``dataset['image_observations_tp1']`` (frames the S2P generator
        made on the device). Returns the slots added."""
        ns = self.num_sequences
        obs_idx = np.asarray(dataset["slac_observation_indices"], np.int64)
        act_idx = np.asarray(dataset["slac_action_indices"], np.int64)
        timeouts = np.asarray(dataset["timeouts"]).ravel()
        n_rows = len(obs_idx)

        sentinel = obs_idx >= SENTINEL
        if (sentinel.any(axis=1) & ~sentinel.all(axis=1)).any():
            raise ValueError("rows with partial sentinel windows")
        valid = ~sentinel.any(axis=1)
        if not (act_idx[valid] == obs_idx[valid, :-1]).all():
            raise ValueError("action windows do not match the observation windows")
        if timeouts[n_rows - 1] == 1:
            valid[n_rows - 1] = False  # the reference stops before the last row
        rows = np.where(valid)[0]
        if len(rows) == 0:
            return 0

        imgs = dataset["image_observations"]
        gen_imgs = (np.asarray(generated_frames) if generated_frames is not None
                    else dataset["image_observations_tp1"])

        # penalize before touching the pool, so a bad uncertainty_type
        # leaves the buffer as it was
        reward = np.asarray(dataset["rewards"]).ravel().astype(np.float64)
        if uncertainty_type is not None:
            if uncertainty_penalty_lambda is None:
                raise ValueError("uncertainty_type needs uncertainty_penalty_lambda")
            get = lambda k: np.asarray(dataset[k]).reshape(len(reward), -1)[:, 0]  # noqa: E731
            if uncertainty_type == "aleatoric":
                u = get("aleatoric_uncertainty")
            elif uncertainty_type == "disagreement":
                u = get("disagreement_uncertainty")
            elif uncertainty_type == "max_of_both":
                u = np.maximum(get("aleatoric_uncertainty"), get("disagreement_uncertainty"))
            elif uncertainty_type == "min_of_both":
                u = np.minimum(get("aleatoric_uncertainty"), get("disagreement_uncertainty"))
            elif uncertainty_type == "average_both":
                u = 0.5 * (get("aleatoric_uncertainty") + get("disagreement_uncertainty"))
            else:
                raise NotImplementedError(uncertainty_type)
            reward = reward - float(uncertainty_penalty_lambda) * u

        base = self._add_frames(imgs)
        gen_base = self._add_frames(gen_imgs)
        # window: 8 real frames (obs_idx[:, :ns]) + the generated frame of row i−1
        win = np.concatenate([base + obs_idx[rows, :ns], gen_base + (rows - 1)[:, None]], axis=1)
        acts = np.concatenate([dataset["original_actions"][act_idx[rows, :ns - 1]],
                               dataset["actions"][rows - 1][:, None, :]], axis=1)
        rews = np.concatenate([
            np.asarray(dataset["original_rewards"]).ravel()[act_idx[rows, :ns - 1]],
            reward[rows - 1][:, None]], axis=1).astype(np.float32)
        self._add_slots(win, acts, rews, np.zeros_like(rews))
        return len(rows)

    # -- online streaming -----------------------------------------------------
    def reset_episode(self, state: np.ndarray) -> None:
        if self._ep_frame_start is not None:
            raise RuntimeError("episode already open")
        self._ep_frame_start = self._add_frames(state[None])
        self._ep_actions, self._ep_rewards, self._ep_dones = [], [], []

    def append(self, action: np.ndarray, reward: float, mask: bool, next_state: np.ndarray,
               episode_done: bool) -> None:
        if self._ep_frame_start is None:
            raise RuntimeError("reset_episode first")
        self._add_frames(next_state[None])
        self._ep_actions.append(np.asarray(action, np.float32))
        self._ep_rewards.append(float(reward))
        self._ep_dones.append(float(mask))
        ns = self.num_sequences
        t = len(self._ep_actions) - 1
        if t >= ns - 1:
            f0 = self._ep_frame_start + t - (ns - 1)
            sl = slice(t - ns + 1, t + 1)
            self._add_slots(np.arange(f0, f0 + ns + 1)[None],
                            np.stack(self._ep_actions[sl])[None],
                            np.asarray(self._ep_rewards[sl], np.float32)[None],
                            np.asarray(self._ep_dones[sl], np.float32)[None])
        if episode_done:
            self._ep_frame_start = None

    # -- sampling -------------------------------------------------------------
    def device_state(self) -> Dict:
        """The live prefix on the buffer's device (uploaded once per
        ingest), with ``n`` the slot count as a Python int."""
        if self._device_cache is None:
            if self._n == 0:
                raise ValueError("empty buffer")
            put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)  # noqa: E731
            self._device_cache = dict(
                frames=put(self._frames[:self._n_frames]), windows=put(self._windows[:self._n]),
                actions=put(self._actions[:self._n]), rewards=put(self._rewards[:self._n]),
                dones=put(self._dones[:self._n]), n=self._n)
        return self._device_cache

    def gather(self, idx: torch.Tensor):
        """(obs, actions, rewards, dones) of the slots ``idx``."""
        return gather_windows(self.device_state(), idx.to(self.device))

    def random_batch(self, batch_size: int, generator: torch.Generator) -> Batch:
        """dict(observations [b, ns+1, H, W, C] in [0, 1], actions [b, ns, A],
        rewards [b, 1], terminals [b, 1])."""
        return window_batch(*self.sample_latent(batch_size, generator))

    def sample_latent(self, batch_size: int, generator: torch.Generator):
        """(obs, actions, and the whole reward and done windows) for ELBO
        updates."""
        return self.gather(draw_indices(0, self._n, batch_size, generator, self.device))

    def random_batch_real_gen(self, batch_size: int, generator: torch.Generator
                              ) -> Tuple[Batch, Batch]:
        """A batch from the real slots and one from the generated slots."""
        if not 0 < self._real_n < self._n:
            raise ValueError(f"no real/generated split: {self._real_n} real of {self._n}")
        idx_r = draw_indices(0, self._real_n, batch_size, generator, self.device)
        idx_g = draw_indices(self._real_n, self._n, batch_size, generator, self.device)
        return window_batch(*self.gather(idx_r)), window_batch(*self.gather(idx_g))

    def get_diagnostics(self) -> Dict[str, float]:
        return {"size": float(self._n), "real_size": float(self._real_n)}

    def get_snapshot(self) -> Dict:
        return {}

    def end_epoch(self, epoch: int) -> None:
        return


class SimpleReplayBuffer:
    """Flat transition ring buffer with optional uint8 image observations
    and memory-efficient frame-stack next-observation reconstruction."""

    def __init__(self, max_replay_buffer_size: int, observation_dim, action_dim: int,
                 image_buffer: bool = False, memory_efficient_way: bool = False,
                 frame_stack: int = 3, device: str | torch.device = "cuda") -> None:
        self.capacity = int(max_replay_buffer_size)
        self.image_buffer = image_buffer
        self.memory_efficient = memory_efficient_way
        self.frame_stack = frame_stack
        self.device = torch.device(device)
        obs_shape = ((observation_dim,) if np.isscalar(observation_dim)
                     else tuple(observation_dim))
        obs_dtype = np.uint8 if image_buffer else np.float32
        self._obs = np.zeros((self.capacity, *obs_shape), obs_dtype)
        if image_buffer and memory_efficient_way:
            # only the newest frame of next_obs (the last C/k channels)
            c = obs_shape[-1] // frame_stack
            self._next_obs = np.zeros((self.capacity, *obs_shape[:-1], c), obs_dtype)
        else:
            self._next_obs = np.zeros((self.capacity, *obs_shape), obs_dtype)
        self._actions = np.zeros((self.capacity, action_dim), np.float32)
        self._rewards = np.zeros((self.capacity, 1), np.float32)
        self._terminals = np.zeros((self.capacity, 1), np.float32)
        self._top = 0
        self._size = 0

    def add_sample(self, observation, action, reward, terminal, next_observation) -> None:
        self._obs[self._top] = observation
        if self.image_buffer and self.memory_efficient:
            self._next_obs[self._top] = next_observation[..., -self._next_obs.shape[-1]:]
        else:
            self._next_obs[self._top] = next_observation
        self._actions[self._top] = action
        self._rewards[self._top] = reward
        self._terminals[self._top] = terminal
        self._top = (self._top + 1) % self.capacity
        self._size = min(self._size + 1, self.capacity)

    def add_path(self, path: Dict[str, np.ndarray]) -> None:
        for o, a, r, t, no in zip(path["observations"], path["actions"], path["rewards"],
                                  path["terminals"], path["next_observations"]):
            self.add_sample(o, a, r, t, no)

    def add_paths(self, paths) -> None:
        for path in paths:
            self.add_path(path)

    def random_batch(self, batch_size: int, rng: Optional[np.random.RandomState] = None):
        """A host numpy batch; rows from ``rng.randint`` (the JAX package's
        draw)."""
        rng = rng or np.random
        idx = rng.randint(0, self._size, size=batch_size)
        obs = self._obs[idx]
        if self.image_buffer and self.memory_efficient:
            c = self._next_obs.shape[-1]
            next_obs = np.concatenate([obs[..., c:], self._next_obs[idx]], axis=-1)
        else:
            next_obs = self._next_obs[idx]
        if self.image_buffer:
            obs = obs.astype(np.float32) / 255.0
            next_obs = next_obs.astype(np.float32) / 255.0
        return dict(observations=obs, actions=self._actions[idx], rewards=self._rewards[idx],
                    terminals=self._terminals[idx], next_observations=next_obs)

    def device_state(self) -> Dict:
        """The live prefix as tensors on the buffer's device (images stay
        uint8), with ``n`` the row count; built anew on each call."""
        if self._size == 0:
            raise ValueError("empty buffer")
        if self.image_buffer and self.memory_efficient:
            raise ValueError("memory-efficient image mode rebuilds next_obs at sample time")
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a[:self._size])).to(self.device)  # noqa: E731
        return dict(observations=put(self._obs), actions=put(self._actions),
                    rewards=put(self._rewards), terminals=put(self._terminals),
                    next_observations=put(self._next_obs), n=self._size)

    def __len__(self) -> int:
        return self._size

    def num_steps_can_sample(self) -> int:
        return self._size

    def get_diagnostics(self) -> Dict[str, float]:
        return {"size": float(self._size)}

    def end_epoch(self, epoch: int) -> None:
        return
