"""In-memory dataset iterators + conv shape calculators: the port of
``s2p_tpu/data/loaders.py`` (plain numpy, the same index stream).

Capability contracts:
- ``ImageDataset``/``InfiniteRandomSampler`` (reference: rlkit/torch/
  data.py:9-40): an index-addressable image dataset and an endless shuffled
  index stream — here a generator yielding device-feedable batches.
- conv output-size calculators (reference: rlkit/torch/pytorch_util.py:
  181-215): ``conv2d_output_size`` / ``conv_transpose2d_output_size`` used
  to size conv stacks ahead of construction.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class ImageDataset:
    def __init__(self, images: np.ndarray, labels: np.ndarray = None):
        self.images = np.asarray(images)
        self.labels = labels if labels is None else np.asarray(labels)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx):
        if self.labels is None:
            return self.images[idx]
        return self.images[idx], self.labels[idx]


def infinite_random_sampler(
    n: int, batch_size: int, seed: int = 0
) -> Iterator[np.ndarray]:
    """Endless shuffled index batches (reference InfiniteRandomSampler)."""
    rng = np.random.RandomState(seed)
    while True:
        order = rng.permutation(n)
        for lo in range(0, n - batch_size + 1, batch_size):
            yield order[lo : lo + batch_size]


def batch_iterator(
    dataset: Dict[str, np.ndarray], batch_size: int, seed: int = 0
) -> Iterator[Dict[str, np.ndarray]]:
    """Endless dict-of-arrays batch stream over a fixed dataset."""
    n = len(next(iter(dataset.values())))
    for idx in infinite_random_sampler(n, batch_size, seed):
        yield {k: v[idx] for k, v in dataset.items()}


def conv2d_output_size(h_in: int, kernel: int, stride: int = 1,
                       padding: int = 0, dilation: int = 1) -> int:
    """floor((H + 2p − d(k−1) − 1)/s + 1) (reference pytorch_util.py:181)."""
    return (h_in + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1


def conv_transpose2d_output_size(h_in: int, kernel: int, stride: int = 1,
                                 padding: int = 0, output_padding: int = 0,
                                 dilation: int = 1) -> int:
    """(H−1)s − 2p + d(k−1) + op + 1 (reference pytorch_util.py:199)."""
    return (h_in - 1) * stride - 2 * padding + dilation * (kernel - 1) + \
        output_padding + 1


def conv_stack_output_shape(hw: int, kernels, strides, paddings) -> int:
    for k, s, p in zip(kernels, strides, paddings):
        hw = conv2d_output_size(hw, k, s, p)
    return hw
