"""Test stubs: the port of ``s2p_tpu/testing/stubs.py`` (rlkit's
``testing/stub_classes.py``).

``StubPolicy`` (a constant action), ``AddEs`` (an exploration strategy that
adds a constant) and ``is_binomial_trial_likely`` for stochastic checks;
``StubEnv`` lives in ``s2p_tpu_torch.envs.wrappers``.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


class StubPolicy:
    """Always returns the same action (reference stub_classes.py:83)."""

    def __init__(self, action):
        self._action = np.asarray(action)

    def get_action(self, *args, **kwargs) -> Tuple[np.ndarray, dict]:
        return self._action.copy(), {}

    def reset(self) -> None:
        pass


class AddEs:
    """Exploration strategy stub: adds a constant (reference
    stub_classes.py:94-103)."""

    def __init__(self, number):
        self._number = number

    def get_action(self, t, observation, policy, **kwargs):
        action, info = policy.get_action(observation)
        return action + self._number, info

    def get_action_from_raw_action(self, action, **kwargs):
        return action + self._number


def is_binomial_trial_likely(n: int, p: float, num_success: int,
                             z: float = 3.0) -> bool:
    """Is num_success within z standard deviations of np
    (reference testing_utils.py:6-18)?"""
    mean = n * p
    std = math.sqrt(n * p * (1 - p))
    return abs(num_success - mean) <= z * std
