"""Hyperparameter sweepers and scalar schedules: the port of
``s2p_tpu/utils/sweep.py``.

Capability contract (reference: rlkit/util/hyperparameter.py:14-231 — enum/
log-float/linear-float/log-int/linear-int random params, random and
deterministic (grid) sweepers — and rlkit/util/ml_util.py:9-75 — constant /
linear / piecewise-linear schedules with int variants)."""

from __future__ import annotations

import itertools
import math
import random
from typing import Any, Dict, Iterator, List, Mapping, Sequence

import numpy as np

from s2p_tpu_torch.utils.config import Config


# -- random hyperparameters --------------------------------------------------

class Hyperparameter:
    def __init__(self, name: str):
        self.name = name

    def generate(self) -> Any:
        raise NotImplementedError


class EnumParam(Hyperparameter):
    def __init__(self, name: str, possible_values: Sequence[Any]):
        super().__init__(name)
        self.possible_values = list(possible_values)

    def generate(self) -> Any:
        return random.choice(self.possible_values)


class LogFloatParam(Hyperparameter):
    """Uniform in log-space over [min, max] (+offset)."""

    def __init__(self, name: str, min_value: float, max_value: float, offset: float = 0.0):
        super().__init__(name)
        self._min, self._max, self._offset = min_value, max_value, offset

    def generate(self) -> float:
        return 10 ** random.uniform(
            math.log10(self._min), math.log10(self._max)
        ) + self._offset


class LinearFloatParam(Hyperparameter):
    def __init__(self, name: str, min_value: float, max_value: float):
        super().__init__(name)
        self._min, self._max = min_value, max_value

    def generate(self) -> float:
        return random.uniform(self._min, self._max)


class LogIntParam(LogFloatParam):
    def generate(self) -> int:
        return int(super().generate())


class LinearIntParam(Hyperparameter):
    def __init__(self, name: str, min_value: int, max_value: int):
        super().__init__(name)
        self._min, self._max = min_value, max_value

    def generate(self) -> int:
        return random.randint(self._min, self._max)


class RandomHyperparameterSweeper:
    """Sample N variants from a list of random params
    (reference hyperparameter.py:106-160)."""

    def __init__(self, hyperparameters: Sequence[Hyperparameter],
                 default_kwargs: Mapping[str, Any] = ()):
        self._params = list(hyperparameters)
        names = [p.name for p in self._params]
        if len(names) != len(set(names)):
            raise ValueError("duplicate hyperparameter names")
        self._default = Config(dict(default_kwargs))

    def generate_random_hyperparameters(self) -> Dict[str, Any]:
        return {p.name: p.generate() for p in self._params}

    def iterate_hyperparameters(self, num: int) -> Iterator[Config]:
        for _ in range(num):
            out = self._default.deep_update({})
            for name, value in self.generate_random_hyperparameters().items():
                out.set_path(name, value)
            yield out


class DeterministicHyperparameterSweeper:
    """Cartesian grid over {name: [values]} (reference
    hyperparameter.py:162-201); dotted names address nested config paths."""

    def __init__(self, hyperparameters: Mapping[str, Sequence[Any]],
                 default_parameters: Mapping[str, Any] = ()):
        self._grid = dict(hyperparameters)
        self._default = Config(dict(default_parameters))

    def iterate_hyperparameters(self) -> List[Config]:
        names = list(self._grid)
        out = []
        for combo in itertools.product(*(self._grid[n] for n in names)):
            cfg = self._default.deep_update({})
            for name, value in zip(names, combo):
                cfg.set_path(name, value)
            out.append(cfg)
        return out


# -- schedules ---------------------------------------------------------------

class ConstantSchedule:
    def __init__(self, value: float):
        self._value = value

    def get_value(self, t: int) -> float:
        return self._value


class LinearSchedule:
    """Linear from init to final over a step range (reference ml_util.py:23)."""

    def __init__(self, init_value: float, final_value: float,
                 ramp_duration: int, start: int = 0):
        self._init, self._final = init_value, final_value
        self._start, self._duration = start, ramp_duration

    def get_value(self, t: int) -> float:
        frac = np.clip((t - self._start) / max(self._duration, 1), 0.0, 1.0)
        return self._init + frac * (self._final - self._init)


class IntLinearSchedule(LinearSchedule):
    def get_value(self, t: int) -> int:
        return int(super().get_value(t))


class PiecewiseLinearSchedule:
    """np.interp over (x_values, y_values) knots (reference ml_util.py:53)."""

    def __init__(self, x_values: Sequence[float], y_values: Sequence[float]):
        self._x = list(x_values)
        self._y = list(y_values)

    def get_value(self, t: int) -> float:
        return float(np.interp(t, self._x, self._y))


class IntPiecewiseLinearSchedule(PiecewiseLinearSchedule):
    def get_value(self, t: int) -> int:
        return int(super().get_value(t))
