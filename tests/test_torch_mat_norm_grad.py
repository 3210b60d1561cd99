"""The gradient of the port's MAT norm (``FusedMATNorm``) against autograd
and the JAX package. On the CPU the Function runs the plain forward and
``fused_mat_norm_bwd_plain``, the formula the CUDA backward kernel is held
to on the card by chip_smoke.py. JAX's ``fused_mat_norm`` runs ``_plain``
on the CPU, which ``jax.vjp`` differentiates; f32, atol 1e-5."""

import numpy as np
import pytest
import torch

import jax

from s2p_tpu.gan.pallas_kernels import fused_mat_norm as jax_fused_mat_norm
from s2p_tpu_torch.gan.cuda_kernels import (
    FusedMATNorm,
    fused_mat_norm,
    fused_mat_norm_bwd_plain,
    fused_mat_norm_plain,
)


def _arrays(shape, seed):
    """x, dy and one γ‖β tensor ``[..., 2C]`` (the fast path passes γ and β
    as its two channel halves)."""
    rs = np.random.RandomState(seed)
    x = (0.5 + rs.randn(*shape)).astype(np.float32)
    dy = rs.randn(*shape).astype(np.float32)
    gb = (0.5 * rs.randn(*shape[:3], 2 * shape[3])).astype(np.float32)
    return x, dy, gb


def _torch_inputs(x, gb, strided, dtype=torch.float32):
    C = x.shape[-1]
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    gbt = torch.from_numpy(gb).to(dtype)
    if strided:
        gbt.requires_grad_()
        return xt, gbt, gbt[..., :C], gbt[..., C:]
    g = gbt[..., :C].contiguous().requires_grad_()
    b = gbt[..., C:].contiguous().requires_grad_()
    return xt, None, g, b


def test_gradcheck_f64():
    rs = np.random.RandomState(0)
    x, g, b = (torch.from_numpy(rs.randn(2, 3, 4, 5)).requires_grad_() for _ in range(3))
    assert torch.autograd.gradcheck(fused_mat_norm, (x, g, b), eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("C", [12, 64])
@pytest.mark.parametrize("hw", [4, 7, 13])  # H·W = 16, 49, 169
def test_grads_match_jax_vjp(hw, C, strided):
    x, dy, gb = _arrays((2, hw, hw, C), seed=hw * C + strided)
    xt, gbt, g, b = _torch_inputs(x, gb, strided)
    out = fused_mat_norm(xt, g, b)
    out.backward(torch.from_numpy(dy))

    ref_out, vjp = jax.vjp(jax_fused_mat_norm, x, gb[..., :C], gb[..., C:])
    rdx, rdg, rdb = (np.asarray(t) for t in vjp(dy))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), rdx, atol=1e-5)
    if strided:
        dg, db = gbt.grad[..., :C].numpy(), gbt.grad[..., C:].numpy()
    else:
        dg, db = g.grad.numpy(), b.grad.numpy()
    np.testing.assert_allclose(dg, rdg, atol=1e-5)
    np.testing.assert_allclose(db, rdb, atol=1e-5)


@pytest.mark.parametrize("C", [12, 64])
@pytest.mark.parametrize("hw", [4, 7, 13])
def test_bwd_plain_matches_autograd_of_plain(hw, C):
    """The plain backward formula against autograd through the plain
    forward's own ops, from the statistics the forward saves."""
    x, dy, gb = _arrays((2, hw, hw, C), seed=3 * hw + C)
    xt, _, g, b = _torch_inputs(x, gb, strided=False)
    dyt = torch.from_numpy(dy)
    fused_mat_norm_plain(xt, g, b).backward(dyt)

    xf = torch.from_numpy(x)
    mean = xf.mean(dim=(1, 2))
    rstd = torch.rsqrt((xf - mean[:, None, None]).square().mean(dim=(1, 2)) + 1e-5)
    dx, dg = fused_mat_norm_bwd_plain(dyt, xf, g.detach(), mean, rstd)
    np.testing.assert_allclose(dx.numpy(), xt.grad.numpy(), atol=1e-5)
    np.testing.assert_allclose(dg.numpy(), g.grad.numpy(), atol=1e-5)


def test_bf16_grads_keep_input_types():
    x, dy, gb = _arrays((2, 4, 4, 12), seed=9)
    xt, _, g, b = _torch_inputs(x, gb, strided=False, dtype=torch.bfloat16)
    fused_mat_norm(xt, g, b).backward(torch.from_numpy(dy).bfloat16())
    assert xt.grad.dtype == g.grad.dtype == b.grad.dtype == torch.bfloat16
    assert torch.equal(b.grad, torch.from_numpy(dy).bfloat16())
    assert torch.isfinite(xt.grad.float()).all()


def test_stats_saved_only_when_autograd_records():
    x, _, gb = _arrays((2, 4, 4, 12), seed=1)
    xt, _, g, b = _torch_inputs(x, gb, strided=False)
    with torch.no_grad():
        assert fused_mat_norm(xt, g, b).grad_fn is None
    plain = [t.detach() for t in (xt, g, b)]
    assert fused_mat_norm(*plain).grad_fn is None
    out = fused_mat_norm(xt, g, b)
    assert type(out.grad_fn).__name__ == FusedMATNorm.__name__ + "Backward"
    saved = out.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [(2, 4, 4, 12), (2, 4, 4, 12), (2, 12), (2, 12)]


@pytest.mark.parametrize("dy_requires_grad", [False, True])
def test_second_order_raises(dy_requires_grad):
    x, dy, gb = _arrays((2, 4, 4, 12), seed=2)
    xt, _, g, b = _torch_inputs(x, gb, strided=False)
    dyt = torch.from_numpy(dy).requires_grad_(dy_requires_grad)
    with pytest.raises(RuntimeError, match="once differentiable"):
        torch.autograd.grad(fused_mat_norm(xt, g, b), (xt, g), dyt, create_graph=True)
