"""The port's augmentations keep the JAX package's input contract.

At every input edge, each entry of ``AUGMENTATIONS`` gives in the port what
it gives in the JAX package on JAX's draws (computed from its key, as
``tests/test_torch_pixel.py::jax_draws`` does), or raises there as it does
in JAX (the port raises ``ValueError`` for JAX's input errors): a channel
count other than 3 for grayscale, images at or below the cutout size, a
crop or canvas at or beyond the image size, non-square rotations, one
colour channel, an empty cut-size range, batch 1 and float input. With no
draws given, the port draws its own and raises only where JAX raises.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s2p_tpu.nn.augmentations as jaug
from s2p_tpu_torch.nn import augmentations as aug
from tests.test_torch_pixel import ONE_STEP_SHARE, jax_draws

# float outputs of the three augmentations that sum in f32, on a [0, 255]
# scale: the convolution's 81-term sums are ordered differently by XLA's and
# PyTorch's CPU convolutions, and XLA fuses the jitter's products (a few f32
# steps of 255, 1.5e-5 each; 6.1e-5 seen); the rest are exact
FLOAT_ATOL = dict.fromkeys(("grayscale", "convolution", "color_jitter"), 1e-3)


def images(shape, dtype=np.uint8, seed=0):
    x = np.random.RandomState(seed).randint(0, 256, shape, dtype=np.uint8)
    return x.astype(dtype)


def jax_outcome(name, key, x, args):
    """JAX's output, or the exception it raises."""
    try:
        return np.asarray(jaug.AUGMENTATIONS[name](key, jnp.asarray(x), *args))
    except Exception as err:  # TypeError, AssertionError, ValueError: JAX's input errors
        return err


def assert_same(name, got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if ref.dtype == np.uint8:
        diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
        if name not in ONE_STEP_SHARE:
            np.testing.assert_array_equal(got, ref)
        else:
            assert diff.max() <= 1, diff.max()
            assert (diff > 0).mean() <= ONE_STEP_SHARE[name], (diff > 0).mean()
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=FLOAT_ATOL.get(name, 0.0))


def check_edge(name, x, args=(), draw_kw=None, seed=0):
    """The port against JAX on JAX's draws; then the port on its own draws
    raises exactly where JAX raises."""
    key = jax.random.PRNGKey(seed)
    ref = jax_outcome(name, key, x, args)
    fn = aug.AUGMENTATIONS[name]
    draws = jax_draws(name, key, x, **(draw_kw or {}))
    if isinstance(ref, Exception):
        with pytest.raises(ValueError):
            fn(None, torch.from_numpy(x), *args, **draws)
        with pytest.raises(ValueError):
            fn(torch.Generator().manual_seed(seed), torch.from_numpy(x), *args)
        return ref
    assert_same(name, fn(None, torch.from_numpy(x), *args, **draws).numpy(), ref)
    own = fn(torch.Generator().manual_seed(seed), torch.from_numpy(x), *args)
    assert own.shape == ref.shape and own.numpy().dtype == ref.dtype
    return ref


# -- F2: grayscale on a frame stack, cutout at or below max_cut --------------------


def test_grayscale_raises_on_a_frame_stack():
    """A 3-frame stack (9 channels): JAX's contraction with three weights
    raises, and so does the port, where it used to grey frame 1 into all
    nine channels."""
    x = images((2, 8, 8, 9))
    with pytest.raises(TypeError):
        jaug.grayscale(jnp.asarray(x))
    with pytest.raises(ValueError, match="3 channels"):
        aug.grayscale(torch.from_numpy(x))


@pytest.mark.parametrize("with_mask", [False, True])
def test_random_grayscale_raises_on_a_frame_stack(with_mask):
    x = images((2, 8, 8, 9))
    with pytest.raises(TypeError):
        jaug.random_grayscale(jax.random.PRNGKey(0), jnp.asarray(x))
    mask = dict(mask=torch.tensor([True, False])) if with_mask else {}
    with pytest.raises(ValueError, match="3 channels"):
        aug.random_grayscale(torch.Generator().manual_seed(0), torch.from_numpy(x), **mask)


@pytest.mark.parametrize("name", ["cutout", "cutout_color"])
@pytest.mark.parametrize("size", [24, 30])
def test_cutout_at_or_below_max_cut_matches_jax(name, size):
    """H = W ≤ max_cut: JAX's ``randint(0, H − max_cut)`` gives 0, so each
    box starts at the corner; the port used to raise on the empty range."""
    x = images((4, size, size, 3))
    kw = dict(min_cut=10, max_cut=30)
    ref = check_edge(name, x, (10, 30), kw, seed=size)
    draws = jax_draws(name, jax.random.PRNGKey(size), x, **kw)
    assert (draws["h0"] == 0).all() and (draws["w0"] == 0).all()
    assert (ref != x).any()  # the boxes are there


# -- every other edge, per augmentation -------------------------------------------

FRAMES = (2, 12, 12, 9)
ALL = dict(
    crop=((8,), dict(out=8)),
    translate=((16,), dict(size=16)),
    grayscale=((0.5,), dict(p=0.5)),
    cutout=((2, 6), dict(min_cut=2, max_cut=6)),
    cutout_color=((2, 6), dict(min_cut=2, max_cut=6)),
    flip=((0.5,), dict(p=0.5)),
    rotation=((), {}),
    convolution=((), {}),
    color_jitter=((), {}),
    no_aug=((), {}),
)


def channels(name):
    return 3 if name == "grayscale" else FRAMES[-1]


@pytest.mark.parametrize("name", sorted(ALL))
def test_batch_of_one(name):
    args, kw = ALL[name]
    check_edge(name, images((1, *FRAMES[1:3], channels(name))), args, kw, seed=1)


@pytest.mark.parametrize("name", sorted(ALL))
def test_float_input(name):
    """f32 frames in [0, 255]: each keeps its dtype, as in JAX."""
    args, kw = ALL[name]
    check_edge(name, images((*FRAMES[:3], channels(name)), np.float32), args, kw, seed=2)


EDGES = {
    # the crop and the canvas at the image size, and past it (both raise)
    "crop at H": ("crop", FRAMES, (12,), dict(out=12)),
    "crop past H": ("crop", FRAMES, (13,), dict(out=13)),
    "crop past W only": ("crop", (2, 16, 12, 9), (14,), dict(out=14)),
    "crop non-square": ("crop", (2, 16, 12, 9), (10,), dict(out=10)),
    "translate at H": ("translate", FRAMES, (12,), dict(size=12)),
    "translate below H": ("translate", FRAMES, (11,), dict(size=11)),
    # grayscale: one channel raises as nine do
    "grayscale one channel": ("grayscale", (2, 12, 12, 1), (0.5,), dict(p=0.5)),
    # the cut at the image size, and an empty size range (JAX draws min_cut)
    "cutout H at max_cut": ("cutout", FRAMES, (2, 12), dict(min_cut=2, max_cut=12)),
    "cutout W below max_cut": ("cutout", (2, 16, 8, 9), (2, 10), dict(min_cut=2, max_cut=10)),
    "cutout min_cut = max_cut": ("cutout", FRAMES, (5, 5), dict(min_cut=5, max_cut=5)),
    "cutout min_cut > max_cut": ("cutout", FRAMES, (7, 4), dict(min_cut=7, max_cut=4)),
    "cutout_color at max_cut": ("cutout_color", FRAMES, (2, 12), dict(min_cut=2, max_cut=12)),
    "cutout_color one channel": ("cutout_color", (2, 12, 12, 1), (2, 6),
                                 dict(min_cut=2, max_cut=6)),
    # rotation of non-square images raises in both; one channel turns
    "rotation non-square": ("rotation", (2, 12, 10, 9), (), {}),
    "rotation one channel": ("rotation", (4, 12, 12, 1), (), {}),
    "flip one channel": ("flip", (2, 12, 12, 1), (0.5,), dict(p=0.5)),
    "flip non-square": ("flip", (2, 12, 10, 9), (0.5,), dict(p=0.5)),
    "convolution one channel": ("convolution", (2, 12, 12, 1), (), {}),
    "color_jitter one channel": ("color_jitter", (2, 12, 12, 1), (), {}),
    "no_aug one channel": ("no_aug", (2, 12, 12, 1), (), {}),
}
RAISES = {"crop past H", "crop past W only", "translate below H", "grayscale one channel",
          "rotation non-square"}


@pytest.mark.parametrize("edge", sorted(EDGES))
def test_edge_matches_jax(edge):
    name, shape, args, kw = EDGES[edge]
    ref = check_edge(name, images(shape), args, kw, seed=sorted(EDGES).index(edge))
    assert isinstance(ref, Exception) == (edge in RAISES), ref
