"""Hand-written CUDA kernels of the generator, with their plain versions.

``fused_mat_norm`` is the port of ``s2p_tpu/gan/pallas_kernels.py::
fused_mat_norm``: per-(image, channel) instance-norm statistics over H·W
plus the MAT modulation ``·(1+γ)+β`` in one kernel. The source is
``s2p_tpu_torch/csrc/fused_mat_norm.cu`` (its header states the design and
the bound). On a CUDA tensor the wrapper launches that kernel or raises; on
a CPU tensor it runs ``fused_mat_norm_plain``. There is no other path.

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
    fn = lib.s2p_fused_mat_norm
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 4
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def fused_mat_norm_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         eps: float = 1e-5) -> torch.Tensor:
    """``instance_norm(x) * (1 + gamma) + beta`` over NHWC: the port of
    ``_plain`` (pallas_kernels.py:41-45), computed in float32 and cast back
    to x's type, as the kernel does; two-pass variance, as ``jnp.var``."""
    xf = x.float()
    mean = xf.mean(dim=(1, 2), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 2), keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps) * (1.0 + gamma.float()) + beta.float()
    return out.to(x.dtype)


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


def fused_mat_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """``instance_norm(x) * (1 + gamma) + beta`` for NHWC ``[B, H, W, C]``
    tensors in float32 or bfloat16. On the card: the CUDA kernel. x must be
    contiguous; gamma and beta need unit channel stride only (they may be
    channel slices of one wider tensor)."""
    if x.device.type == "cpu":
        return fused_mat_norm_plain(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mat_norm: unsupported device {x.device}")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.device != x.device or t.dtype != x.dtype or t.shape != x.shape:
            raise ValueError(f"fused_mat_norm: {name} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, x is {x.dtype} {tuple(x.shape)} on {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"fused_mat_norm: x must be 4-D float32/bfloat16 NHWC, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"fused_mat_norm: x must be contiguous NHWC, got strides {x.stride()}")
    g_b, g_p = _batch_pixel_strides(gamma, "gamma")
    b_b, b_p = _batch_pixel_strides(beta, "beta")
    B, H, W, C = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        err = load_library().s2p_fused_mat_norm(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
            B, H * W, C, g_b, g_p, b_b, b_p, _DTYPES[x.dtype], eps,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mat_norm: kernel launch failed with cudaError {err}")
    fused_mat_norm.launches += 1
    return out


fused_mat_norm.launches = 0
