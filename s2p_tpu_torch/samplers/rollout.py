"""The env–policy rollout loop: the port of ``s2p_tpu/samplers/rollout.py``.

Step the env with the agent's action until done or ``max_path_length``
(rlkit's ``rollout_functions.py``). With a SLAC algorithm the agent sees
the ``SlacObservation`` window, encoded each step as ``feature_action``
(``SlacAlgorithm.preprocess``) or as the posterior ``latent_z`` of
``prepare_batch``; the encoding stays on the algorithm's device and only
the action comes back to the host, where the env steps. ``terminals``
excludes a TimeLimit truncation and ``dones`` includes it; per-step renders
can be kept for state-RL video.

The ``latent_z`` window becomes floats by a true division by 255 (a tensor
on the device, so the card divides as the CPU does): the JAX package
divides eagerly there, which is a division and not the jitted product with
f32(1/255) that ``replay.frames_to_float`` reproduces.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from s2p_tpu_torch.samplers.agents import SlacObservation


def _latent_z(slac_algo, slac_ob: SlacObservation) -> torch.Tensor:
    frames = torch.as_tensor(slac_ob.state, device=slac_algo.device).float()
    obs = (frames / frames.new_tensor(255.0))[None]
    act = torch.as_tensor(slac_ob.action, device=slac_algo.device).reshape(
        1, slac_algo.num_sequences - 1, -1)
    z, *_ = slac_algo.prepare_batch(obs, act)
    return z.squeeze(0)


def rollout(
    env,
    agent,
    max_path_length: float = np.inf,
    render: bool = False,
    render_kwargs: Optional[dict] = None,
    preprocess_obs_for_policy_fn: Optional[Callable] = None,
    render_image_for_video_when_state_rl: bool = False,
    slac_algo=None,
    slac_policy_input_type: Optional[str] = None,
    slac_obs_reset_w_same_obs: bool = False,
) -> Dict[str, Any]:
    render_kwargs = render_kwargs or {}
    preprocess = preprocess_obs_for_policy_fn or (lambda x: x)
    if slac_algo is not None and slac_policy_input_type not in (None, "feature_action",
                                                                "latent_z"):
        raise ValueError(f"unknown slac_policy_input_type {slac_policy_input_type!r}")

    observations, actions, rewards = [], [], []
    terminals, dones, next_observations = [], [], []
    agent_infos, env_infos, images = [], [], []

    agent.reset()
    o = env.reset()
    if render:
        env.render(**render_kwargs)
    if render_image_for_video_when_state_rl:
        images.append(np.asarray(env.render(**render_kwargs)))

    slac_ob = None
    if slac_algo is not None:
        slac_ob = SlacObservation(
            env.observation_space.shape, env.action_space.shape,
            num_sequences=slac_algo.num_sequences,
            reset_w_same_obs=slac_obs_reset_w_same_obs,
        )
        slac_ob.reset_episode(o)

    path_length = 0
    while path_length < max_path_length:
        if slac_algo is None:
            o_for_agent = preprocess(o)
        elif slac_policy_input_type == "latent_z":
            o_for_agent = _latent_z(slac_algo, slac_ob)
        else:
            o_for_agent = slac_algo.preprocess(slac_ob.state, slac_ob.action).squeeze(0)

        a, agent_info = agent.get_action(o_for_agent)
        next_o, r, done, env_info = env.step(np.array(a, copy=True))
        if slac_ob is not None:
            slac_ob.append(next_o, a)

        if render:
            env.render(**render_kwargs)
        if render_image_for_video_when_state_rl:
            images.append(np.asarray(env.render(**render_kwargs)))

        observations.append(o)
        actions.append(a)
        rewards.append(r)
        terminal = bool(done) and not env_info.get("TimeLimit.truncated", False)
        terminals.append(terminal)
        dones.append(bool(done))
        next_observations.append(next_o)
        agent_infos.append(agent_info)
        env_infos.append(env_info)
        path_length += 1
        if done:
            break
        o = next_o

    actions = np.array(actions)
    if actions.ndim == 1:
        actions = actions[:, None]
    rewards = np.array(rewards).reshape(-1, 1)
    path = dict(
        observations=np.array(observations),
        actions=actions,
        rewards=rewards,
        next_observations=np.array(next_observations),
        terminals=np.array(terminals).reshape(-1, 1),
        dones=np.array(dones).reshape(-1, 1),
        agent_infos=agent_infos,
        env_infos=env_infos,
    )
    if render_image_for_video_when_state_rl:
        path["image_observations"] = np.stack(images, axis=0)  # [T+1, H, W, C]
    return path
