"""Hand-written CUDA kernels of the generator, with their plain versions.

``fused_mat_norm`` is the port of ``s2p_tpu/gan/pallas_kernels.py::
fused_mat_norm``: per-(image, channel) instance-norm statistics over H·W
plus the MAT modulation ``·(1+γ)+β`` in one kernel. It always runs through
``FusedMATNorm``, an autograd Function whose backward is a kernel too
(``fused_mat_norm_bwd``). The source of both is
``s2p_tpu_torch/csrc/fused_mat_norm.cu`` (its header states the design and
the bounds). On a CUDA tensor each direction launches its kernel or raises;
on a CPU tensor it runs its plain version (``fused_mat_norm_plain``,
``fused_mat_norm_bwd_plain``). There is no other path.

The kernel is compiled by ``nvcc`` for ``sm_90a`` at first use into
``build/s2p_tpu_torch/`` beside the package, named by the hash of its source
and flags so that an edited source is rebuilt, and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import torch
from torch.autograd.function import once_differentiable

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "fused_mat_norm.cu"
BUILD_DIR = _PKG.parent / "build" / "s2p_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # CUDA_HOME, CUDA_PATH or nvcc on PATH

    if CUDA_HOME is None or not (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to build the CUDA kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build() -> Path:
    """Compile the kernel library if this source and these flags have not
    been built yet; returns the path of the shared library."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"fused_mat_norm_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    except subprocess.CalledProcessError as err:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{err.stderr}") from err
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    lib = ctypes.CDLL(str(build()))
    fwd = lib.s2p_fused_mat_norm
    fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                    + [ctypes.c_longlong] * 4
                    + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fwd.restype = ctypes.c_int
    bwd = lib.s2p_fused_mat_norm_bwd
    bwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                    + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
    bwd.restype = ctypes.c_int
    return lib


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the accumulation type: float32, or float64 when it is."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _plain_forward(x, gamma, beta, eps):
    """(out, mean, rstd), the statistics ``[B, C]`` in the accumulation type."""
    xf = _acc(x)
    mean = xf.mean(dim=(1, 2), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 2), keepdim=True)
    rstd = torch.rsqrt(var + eps)
    out = (xf - mean) * rstd * (1.0 + _acc(gamma)) + _acc(beta)
    return out.to(x.dtype), mean[:, 0, 0], rstd[:, 0, 0]


def fused_mat_norm_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         eps: float = 1e-5) -> torch.Tensor:
    """``instance_norm(x) * (1 + gamma) + beta`` over NHWC: the port of
    ``_plain`` (pallas_kernels.py:41-45), computed in float32 (float64 for
    float64 inputs) and cast back to x's type, as the kernel does; two-pass
    variance, as ``jnp.var``."""
    return _plain_forward(x, gamma, beta, eps)[0]


def fused_mat_norm_bwd_plain(dy: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor,
                             mean: torch.Tensor, rstd: torch.Tensor):
    """(dx, dγ) of ``fused_mat_norm`` from the forward's ``mean`` and ``rstd``
    ``[B, C]``; dβ is dy itself. With xhat = (x − mean)·rstd and
    g = dy·(1 + γ): dγ = dy·xhat, dx = rstd·(g − mean_HW(g) −
    xhat·mean_HW(g·xhat)). Computed in float32 (float64 for float64 inputs)
    and cast back to x's and γ's types, as the kernel does."""
    m, r = mean[:, None, None, :], rstd[:, None, None, :]
    dyf = _acc(dy)
    xhat = (_acc(x) - m) * r
    g = dyf * (1.0 + _acc(gamma))
    dx = r * (g - g.mean(dim=(1, 2), keepdim=True)
              - xhat * (g * xhat).mean(dim=(1, 2), keepdim=True))
    return dx.to(x.dtype), (dyf * xhat).to(gamma.dtype)


def _batch_pixel_strides(t: torch.Tensor, name: str) -> tuple[int, int]:
    """(batch stride, pixel stride) of an NHWC tensor whose channels are
    unit-stride and whose H and W collapse into one strided pixel axis."""
    _, H, W, C = t.shape
    if C > 1 and t.stride(3) != 1:
        raise ValueError(f"{name}: channels must be unit-stride, got strides {t.stride()}")
    if H > 1 and W > 1 and t.stride(1) != W * t.stride(2):
        raise ValueError(f"{name}: H and W must form one strided pixel axis, "
                         f"got strides {t.stride()}")
    pixel = t.stride(2) if W > 1 else t.stride(1)
    return t.stride(0), pixel


def _check(name: str, t: torch.Tensor, x: torch.Tensor) -> None:
    if t.device != x.device or t.dtype != x.dtype or t.shape != x.shape:
        raise ValueError(f"fused_mat_norm: {name} is {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}, x is {x.dtype} {tuple(x.shape)} on {x.device}")


def _launch_forward(x, gamma, beta, eps, save):
    """The forward kernel: (out, mean, rstd), the f32 ``[B, C]`` statistics
    only when ``save`` (else None, and the kernel writes none)."""
    for name, t in (("gamma", gamma), ("beta", beta)):
        _check(name, t, x)
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"fused_mat_norm: x must be 4-D float32/bfloat16 NHWC, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"fused_mat_norm: x must be contiguous NHWC, got strides {x.stride()}")
    g_b, g_p = _batch_pixel_strides(gamma, "gamma")
    b_b, b_p = _batch_pixel_strides(beta, "beta")
    B, H, W, C = x.shape
    out = torch.empty_like(x)
    mean = rstd = None
    if save:
        mean, rstd = torch.empty(2, B, C, device=x.device, dtype=torch.float32)
    if out.numel() == 0:
        return out, mean, rstd
    with torch.cuda.device(x.device):
        err = load_library().s2p_fused_mat_norm(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
            mean.data_ptr() if save else None, rstd.data_ptr() if save else None,
            B, H * W, C, g_b, g_p, b_b, b_p, _DTYPES[x.dtype], eps,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mat_norm: kernel launch failed with cudaError {err}")
    fused_mat_norm.launches += 1
    return out, mean, rstd


def fused_mat_norm_bwd(dy: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor,
                       mean: torch.Tensor, rstd: torch.Tensor):
    """(dx, dγ) of ``fused_mat_norm``. On the card: the backward kernel; dy
    is copied only when its NHWC view is not contiguous (autograd may hand
    over an expanded or permuted gradient). On the CPU: the plain version."""
    if x.device.type == "cpu":
        return fused_mat_norm_bwd_plain(dy, x, gamma, mean, rstd)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mat_norm_bwd: unsupported device {x.device}")
    _check("dy", dy, x)
    _check("gamma", gamma, x)
    if x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"fused_mat_norm_bwd: x must be contiguous float32/bfloat16 "
                         f"NHWC, got {x.dtype} strides {x.stride()}")
    B, H, W, C = x.shape
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.dtype != torch.float32 or t.shape != (B, C) or not t.is_contiguous():
            raise ValueError(f"fused_mat_norm_bwd: {name} must be contiguous float32 "
                             f"{(B, C)}, got {t.dtype} {tuple(t.shape)}")
    dy = dy.contiguous()
    g_b, g_p = _batch_pixel_strides(gamma, "gamma")
    dx, dgamma = torch.empty_like(x), torch.empty_like(x)
    if x.numel() == 0:
        return dx, dgamma
    with torch.cuda.device(x.device):
        err = load_library().s2p_fused_mat_norm_bwd(
            dy.data_ptr(), x.data_ptr(), gamma.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), dx.data_ptr(), dgamma.data_ptr(), B, H * W, C, g_b, g_p,
            _DTYPES[x.dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mat_norm_bwd: kernel launch failed with cudaError {err}")
    fused_mat_norm_bwd.launches += 1
    return dx, dgamma


@once_differentiable
def _first_order_backward(ctx, dy):
    x, gamma, mean, rstd = ctx.saved_tensors
    dx, dgamma = fused_mat_norm_bwd(dy, x, gamma, mean, rstd)
    return dx, dgamma, dy.to(ctx.beta_dtype), None, None


class FusedMATNorm(torch.autograd.Function):
    """The MAT norm with its gradient. The forward saves x, γ and the f32
    statistics only when autograd records (``save``), so the inference path
    pays nothing for them. The backward is once-differentiable: a
    second-order call raises rather than returning wrong numbers."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, save):
        if x.device.type == "cpu":
            out, mean, rstd = _plain_forward(x, gamma, beta, eps)
        else:
            out, mean, rstd = _launch_forward(x, gamma, beta, eps, save)
        if save:
            ctx.save_for_backward(x, gamma, mean, rstd)
            ctx.beta_dtype = beta.dtype
        return out

    @staticmethod
    def backward(ctx, dy):
        # once_differentiable alone raises only when dy itself requires grad;
        # create_graph=True with a constant dy would silently drop the
        # second-order terms through x, γ and the statistics
        if torch.is_grad_enabled():
            raise RuntimeError("fused_mat_norm is once differentiable: no gradient "
                               "through its backward (create_graph=True)")
        return _first_order_backward(ctx, dy)


def fused_mat_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """``instance_norm(x) * (1 + gamma) + beta`` for NHWC ``[B, H, W, C]``
    tensors in float32 or bfloat16, differentiable in x, gamma and beta. On
    the card: the CUDA kernels. x must be contiguous; gamma and beta need
    unit channel stride only (they may be channel slices of one wider
    tensor)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_mat_norm: unsupported device {x.device}")
    save = torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                        or beta.requires_grad)
    return FusedMATNorm.apply(x, gamma, beta, eps, save)


fused_mat_norm.launches = 0
fused_mat_norm_bwd.launches = 0
