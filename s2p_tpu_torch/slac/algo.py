"""SLAC algorithm wrapper: the latent model, its Adam and the sequence
replay buffer(s).

The port of ``s2p_tpu/slac/algo.py``:

- ``latent_step``: one ELBO gradient step (Adam, as ``optax.adam``) on a
  window batch; ``update_latent`` samples that batch from a buffer first,
  ``update_latent_many`` loops it (the JAX package scans);
- ``prepare_batch``: encode a window, sample the posterior and return
  (z, next_z, action, feature_action, next_feature_action) for the RL
  trainers, without gradients;
- ``preprocess``: the feature_action of one observation window, for acting;
- ``load_data_in_buffer``: offline HDF5 ingestion, the uncertainty-penalized
  generated data included;
- ``save_model``/``load_latent``: ``latent.pkl``/``encoder.pkl`` as numpy
  trees under flax names (the JAX package's ``load_latent`` reads them), and
  the reference's ``latent.pth``.

Every random draw of the algorithm (window indices, posterior noise) comes
from one ``torch.Generator`` on its device, seeded from ``seed``; the
latent model's initial weights from a CPU generator of the same seed. The
JAX package draws from split PRNG keys, which the port cannot reproduce:
``update_latent`` and ``prepare_batch`` take given indices and noise
instead, for comparisons.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from s2p_tpu_torch.data.hdf5 import load_augment_dataset, load_rl_dataset
from s2p_tpu_torch.data.replay import SlacReplayBuffer, draw_indices, frames_to_float
from s2p_tpu_torch.slac.convert import (
    convert_latent_state_dict,
    jax_latent_params_from_state_dict,
    state_dict_from_jax_latent_params,
)
from s2p_tpu_torch.slac.latent import LatentModel, Noise, create_feature_actions


class SlacAlgorithm:
    def __init__(self, action_dim: int, num_sequences: int = 8, buffer_size: int = 10**5,
                 batch_size_latent: int = 32, lr_latent: float = 1e-4, feature_dim: int = 256,
                 z1_dim: int = 32, z2_dim: int = 256,
                 hidden_units: Tuple[int, int] = (256, 256), image_size: int = 64,
                 channels: int = 3, use_seperate_buffer: bool = False, seed: int = 0,
                 device: str | torch.device = "cuda") -> None:
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.action_dim = action_dim
        self.num_sequences = num_sequences
        self.batch_size_latent = batch_size_latent
        self.image_size = image_size
        self.z_dim = z1_dim + z2_dim
        self.feature_dim = feature_dim
        self.lr_latent = lr_latent

        self.latent = LatentModel(action_dim, feature_dim, z1_dim, z2_dim, tuple(hidden_units),
                                  image_size, channels, seed=seed).to(self.device)
        self.opt = self._adam()
        self.learning_steps_latent = 0

        frame_shape = (image_size, image_size, channels)
        self.buffer = SlacReplayBuffer(buffer_size, num_sequences, frame_shape, action_dim,
                                       device=self.device)
        self.use_seperate_buffer = use_seperate_buffer
        self.buffer_gen = (SlacReplayBuffer(buffer_size, num_sequences, frame_shape, action_dim,
                                            device=self.device)
                           if use_seperate_buffer else None)

    def _adam(self) -> torch.optim.Adam:
        """``optax.adam``: β 0.9/0.999, ε 1e-8 outside the square root."""
        return torch.optim.Adam(self.latent.parameters(), lr=self.lr_latent, eps=1e-8)

    @property
    def dtype(self) -> torch.dtype:
        return next(self.latent.parameters()).dtype

    # -- steps --------------------------------------------------------------
    def latent_step(self, obs: torch.Tensor, act: torch.Tensor, rew: torch.Tensor,
                    done: torch.Tensor, noise: Noise = None):
        """One ELBO step on a window batch; returns (loss_kld, loss_image,
        loss_reward) as tensors on the device. The posterior noise is
        ``noise`` (a list) or drawn from the algorithm's generator."""
        obs, act, rew, done = (t.to(self.dtype) for t in (obs, act, rew, done))
        self.opt.zero_grad(set_to_none=True)
        kld, img, r = self.latent.compute_loss(obs, act, rew, done,
                                               self.generator if noise is None else noise)
        (kld + img + r).backward()
        self.opt.step()
        return kld.detach(), img.detach(), r.detach()

    def update_latent(self, buffer: Optional[SlacReplayBuffer] = None,
                      idx: Optional[torch.Tensor] = None,
                      noise: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """One ELBO step on ``batch_size_latent`` windows of ``buffer`` (the
        main buffer by default): the slots ``idx``, or drawn uniformly."""
        buf = self.buffer if buffer is None else buffer
        if idx is None:
            idx = draw_indices(0, len(buf), self.batch_size_latent, self.generator, self.device)
        self.learning_steps_latent += 1
        kld, img, rew = self.latent_step(*buf.gather(idx), noise)
        return {"loss_kld": kld, "loss_image": img, "loss_reward": rew}

    def update_latent_many(self, num_steps: int, buffer: Optional[SlacReplayBuffer] = None
                           ) -> Dict[str, torch.Tensor]:
        """``num_steps`` ELBO steps; the last step's losses."""
        losses: Dict[str, torch.Tensor] = {}
        for _ in range(num_steps):
            losses = self.update_latent(buffer)
        return losses

    @torch.no_grad()
    def prepare_batch(self, obs: torch.Tensor, act: torch.Tensor, noise: Noise = None):
        """(z, next_z, action, feature_action, next_feature_action) of a
        window batch; posterior noise from ``noise`` (a generator or a
        list) or the algorithm's generator."""
        obs, act = obs.to(self.dtype), act.to(self.dtype)
        feature_ = self.latent.encode(obs)
        z_ = self.latent.latent_z(feature_, act, self.generator if noise is None else noise)
        fa, n_fa = create_feature_actions(feature_, act)
        return z_[:, -2], z_[:, -1], act[:, -1], fa, n_fa

    @torch.no_grad()
    def preprocess(self, frames: np.ndarray, actions: np.ndarray) -> torch.Tensor:
        """frames [S, H, W, C] uint8 and actions → feature_action [1, ·]."""
        obs = frames_to_float(torch.as_tensor(np.asarray(frames), device=self.device))[None]
        feat = self.latent.encode(obs.to(self.dtype)).reshape(1, -1)
        act = torch.as_tensor(np.asarray(actions), device=self.device, dtype=self.dtype)
        return torch.cat([feat, act.reshape(1, -1)], dim=1)

    @property
    def feature_action_dim(self) -> int:
        return (self.num_sequences * self.feature_dim
                + (self.num_sequences - 1) * self.action_dim)

    # -- offline ingestion --------------------------------------------------
    def load_data_in_buffer(self, h5f_r_name: str, data_num: Optional[int] = None,
                            uncertainty_type: Optional[str] = None,
                            uncertainty_penalty_lambda: Optional[float] = None,
                            generated_for_slac: bool = False,
                            data_mix_type: Optional[str] = None,
                            savedir: Optional[str] = None) -> int:
        if data_num == 0:
            return 0
        if generated_for_slac and data_mix_type == "all_state_1step_random_action":
            ds = load_augment_dataset(h5f_r_name, data_num)
            buf = self.buffer_gen if self.use_seperate_buffer else self.buffer
            added = buf.ingest_generated(ds, uncertainty_type, uncertainty_penalty_lambda)
        else:
            added = self.buffer.ingest_real(load_rl_dataset(h5f_r_name, data_num))
            self.buffer.mark_real()
        if savedir is not None:
            os.makedirs(savedir, exist_ok=True)
            with open(osp.join(savedir, "buffer_meta.pkl"), "wb") as f:
                pickle.dump(dict(n=len(self.buffer), path=h5f_r_name), f)
        return added

    # -- persistence --------------------------------------------------------
    def jax_params(self) -> Dict[str, Any]:
        """The latent model as the JAX package's ``{"params": ...}`` tree."""
        return jax_latent_params_from_state_dict(self.latent.state_dict())

    def save_model(self, save_dir: str) -> None:
        os.makedirs(save_dir, exist_ok=True)
        tree = self.jax_params()
        with open(osp.join(save_dir, "latent.pkl"), "wb") as f:
            pickle.dump(tree, f)
        with open(osp.join(save_dir, "encoder.pkl"), "wb") as f:
            pickle.dump({"params": tree["params"]["encoder"]}, f)

    def load_latent(self, path: str) -> None:
        """``latent.pkl`` (a numpy tree under flax names, as this package
        and the JAX package write it) or the reference's ``latent.pth``;
        the optimizer starts afresh."""
        from s2p_tpu_torch.gan.convert import load_pth
        from s2p_tpu_torch.utils.checkpoint import load_numpy_pickle

        if path.endswith((".pth", ".pt")):
            sd = convert_latent_state_dict(load_pth(path))
        else:
            sd = state_dict_from_jax_latent_params(load_numpy_pickle(path))
        self.latent.load_state_dict(sd, strict=True)
        self.opt = self._adam()

    # -- trainer protocol -----------------------------------------------------
    def get_snapshot(self) -> Dict[str, Any]:
        return {"latent_params": self.jax_params()}

    def get_diagnostics(self) -> Dict[str, float]:
        d = {"latent_steps": float(self.learning_steps_latent)}
        d.update({f"buffer/{k}": v for k, v in self.buffer.get_diagnostics().items()})
        return d
