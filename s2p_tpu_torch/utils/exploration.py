"""Exploration strategies: the port of ``s2p_tpu/utils/exploration.py``.

Capability contract (reference: rlkit/exploration_strategies/*.py): OU
process, additive Gaussian (optionally decayed), ε-greedy, Gaussian+ε, and
the policy wrapper that applies a strategy to ``get_action``. Host-side
numpy (they wrap env-stepping policies, not jitted code).

Shared structure: every strategy is a pure ``action -> noisy action``
transform over a private RandomState; time-dependent noise scales anneal
linearly via ``_anneal``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _anneal(t: int, hi: float, lo: float, period: int) -> float:
    """Linear schedule from ``hi`` at t=0 to ``lo`` at t>=period."""
    frac = min(1.0, float(t) / period)
    return hi + (lo - hi) * frac


class RawExplorationStrategy:
    def get_action_from_raw_action(self, action, **kwargs):
        raise NotImplementedError

    def get_action(self, t, observation, policy, **kwargs):
        raw, agent_info = policy.get_action(observation)
        noisy = self.get_action_from_raw_action(raw, t=t)
        return noisy, agent_info

    def reset(self):
        pass


class EpsilonGreedy(RawExplorationStrategy):
    """With probability ε take a uniform random action
    (reference epsilon_greedy.py:6)."""

    def __init__(self, action_space, prob_random_action: float = 0.1,
                 seed: int = 0):
        self.action_space = action_space
        self.prob_random_action = prob_random_action
        self._rng = np.random.RandomState(seed)

    def get_action_from_raw_action(self, action, **kwargs):
        explore = self._rng.random_sample() <= self.prob_random_action
        return self.action_space.sample() if explore else action


class GaussianStrategy(RawExplorationStrategy):
    """Additive Gaussian noise, σ annealed max→min over decay_period
    (reference gaussian_strategy.py:5)."""

    def __init__(self, action_space, max_sigma: float = 1.0,
                 min_sigma: Optional[float] = None,
                 decay_period: int = 1_000_000, seed: int = 0):
        self.space = action_space
        self.sigma_hi = max_sigma
        self.sigma_lo = max_sigma if min_sigma is None else min_sigma
        self.decay_period = decay_period
        self._rng = np.random.RandomState(seed)

    def get_action_from_raw_action(self, action, t: int = 0, **kwargs):
        sigma = _anneal(t, self.sigma_hi, self.sigma_lo, self.decay_period)
        noisy = action + sigma * self._rng.normal(size=len(action))
        return np.clip(noisy, self.space.low, self.space.high)


class GaussianAndEpsilonStrategy(RawExplorationStrategy):
    """ε-greedy over a Gaussian strategy: uniform random with prob ε,
    annealed Gaussian noise otherwise (reference
    gaussian_and_epsilon_strategy.py:6)."""

    def __init__(self, action_space, epsilon: float = 0.1,
                 max_sigma: float = 1.0, min_sigma: Optional[float] = None,
                 decay_period: int = 1_000_000, seed: int = 0):
        self.epsilon = epsilon
        self.space = action_space
        self._gaussian = GaussianStrategy(
            action_space, max_sigma, min_sigma, decay_period, seed=seed
        )
        self._rng = np.random.RandomState(seed + 1)

    def get_action_from_raw_action(self, action, t: int = 0, **kwargs):
        if self._rng.random_sample() < self.epsilon:
            return self.space.sample()
        return self._gaussian.get_action_from_raw_action(action, t=t)


class OUStrategy(RawExplorationStrategy):
    """Ornstein-Uhlenbeck temporally-correlated noise: the noise state
    mean-reverts to μ at rate θ with annealed diffusion σ
    (reference ou_strategy.py:7)."""

    def __init__(self, action_space, mu: float = 0.0, theta: float = 0.15,
                 max_sigma: float = 0.3, min_sigma: Optional[float] = None,
                 decay_period: int = 100_000, seed: int = 0):
        self.mu, self.theta = mu, theta
        self.sigma_hi = self.sigma = max_sigma
        self.sigma_lo = max_sigma if min_sigma is None else min_sigma
        self.decay_period = decay_period
        self.low, self.high = action_space.low, action_space.high
        self.dim = int(np.prod(action_space.low.shape))
        self._rng = np.random.RandomState(seed)
        self.reset()

    def reset(self):
        self.state = np.full(self.dim, self.mu, dtype=np.float64)

    def evolve_state(self):
        drift = (self.mu - self.state) * self.theta
        diffusion = self._rng.randn(self.dim) * self.sigma
        self.state = self.state + drift + diffusion
        return self.state

    def get_action_from_raw_action(self, action, t: int = 0, **kwargs):
        noise = self.evolve_state()
        self.sigma = _anneal(t, self.sigma_hi, self.sigma_lo,
                             self.decay_period)
        return np.clip(action + noise, self.low, self.high)


class PolicyWrappedWithExplorationStrategy:
    """get_action adapter (reference base.py:28)."""

    def __init__(self, exploration_strategy: RawExplorationStrategy, policy):
        self.es, self.policy, self.t = exploration_strategy, policy, 0

    def get_action(self, *args, **kwargs) -> Tuple[np.ndarray, dict]:
        out = self.es.get_action(self.t, *args, policy=self.policy, **kwargs)
        self.t += 1
        return out

    def reset(self):
        self.t = 0
        for owned in (self.es, self.policy):
            owned.reset()
