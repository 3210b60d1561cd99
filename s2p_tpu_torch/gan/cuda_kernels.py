"""Hand-written CUDA kernels of the generator, with their plain versions.

``fused_mat_norm`` is the port of ``s2p_tpu/gan/pallas_kernels.py::
fused_mat_norm`` (the TPU kernel, ``pl.pallas_call`` at l.78): per-(image,
channel) instance-norm statistics over H·W plus the MAT modulation
``·(1+γ)+β`` in one kernel. It always runs through ``FusedMATNorm``, an
autograd Function whose backward is a kernel too (``fused_mat_norm_bwd``).
The source of both is ``s2p_tpu_torch/csrc/fused_mat_norm.cu``. On a CUDA
tensor each direction launches its kernel or raises; on a CPU tensor it
runs its plain version (``fused_mat_norm_plain``, ``fused_mat_norm_bwd_plain``).
There is no other path.

Both kernels are bound by bytes (~10 flops per byte against the card's
~295): the forward must move 4 elements per entry of B·H·W·C (read x, γ,
β, write out), the backward 5 (read dy, x, γ, write dx, dγ).
``mat_norm_plan`` chooses, from the shapes, strides and alignment and
before the launch, how a launch meets that bound:

- occupancy: the H·W pixels of one (image, channel tile) are split over a
  thread block cluster of k ∈ {1, 2, 4, 8} CTAs, whose partial sums meet in
  distributed shared memory; on images of ≥ 1024 pixels k rises until the
  grid reaches about two CTAs per SM while each CTA keeps ≥ 256 pixels (the
  50² and 100² training shapes: ≥ 256 CTAs from 16 images); smaller images
  (25² and below) are split only where their slice would not fit
  otherwise, and reach about one CTA per SM with a narrower channel tile
  instead, since there a cluster launch and its barriers cost more than
  the CTAs it adds;
- re-reads: on the ``resident`` path each CTA holds its slice of x (the
  backward: x and dy) in shared memory, ≤ 100 KB so that two CTAs fit on
  an SM, loaded once with 16-byte ``cp.async``; every pass reads it there,
  so x leaves HBM once instead of three times. The ``streaming`` path is
  the same kernel reading x from global memory in each pass: it takes a
  slice that does not fit even at k = 8 (256² images and up), and a launch
  whose x (and dy) total ≤ 4 MiB, whose re-reads meet L2 and for which the
  copy into shared memory and its barrier cost more than they save;
- load width: 16-byte loads and stores (8 bf16 or 4 f32 channels a
  thread) when C is a multiple of ``VEC_MULTIPLE`` (16 forward: StyleGAN's
  16 channels at 1024²; 32 backward; every S2P width is both) and every
  base pointer and stride is 16-byte aligned;
  otherwise a scalar variant of the same kernel (e.g. β = ``gb[..., 12:]``
  with C = 12).

γ and β may also be one value per (image, channel) broadcast over the
pixels, views of pixel stride 0 (StyleGAN's AdaIN, ``stylegan.adain_nchw``):
the kernel reads them as it reads any pixel stride, and
``fused_mat_norm.style_launches`` counts those launches beside ``launches``.

``spade_norm`` is SPADE's modulation with given per-channel statistics,
``(x·a + b)·(1 + γ) + β`` (GauGAN's generator at inference, whose batch
norm reads its running statistics), from ``s2p_tpu_torch/csrc/spade_norm.cu``;
it replaces no TPU kernel (the JAX package has no SPADE generator). One pass,
bound by bytes like the MAT norm's forward (4 elements per entry), with no
gradient; ``spade_norm_plan`` sets its channel tile, threads and grid, and
``spade_norm_plain`` is its plain version.

The MAT norm's forward and ``spade_norm`` also take an optional
``gb_bias`` ``[2C]``, the fast path's γ‖β conv bias (γ's C values, then
β's), which they add to γ and β in f32 as they read them: the fast path
runs that conv without its bias, and PyTorch's separate bias pass over the
2C-channel map goes. A thread loads its channels' biases once, so the bytes
moved hardly change. Without it a kernel does no bias arithmetic, and its
output is bit for bit the formula's without the bias; with it there is no
gradient (it raises where autograd would record). ``bias_launches`` counts
the launches that took one, beside ``launches``.

``hidden_maps`` writes a res-block's hidden maps from the bias-free output
of the fast path's shared conv, from ``s2p_tpu_torch/csrc/hidden_maps.cu``:
in one pass it adds the conv's bias and, for S2P, the constant-map conv's
border-aware terms, applies the ReLU, and writes each norm's map
channels_last-contiguous into one allocation; it replaces no TPU kernel
(XLA fuses the same arithmetic there). Bound by bytes (read the map once,
write it once), with no gradient; ``hidden_maps_plan`` sets its launch,
``hidden_maps_plain`` is its plain version, and ``cmap_launches`` counts
the launches with the constant-map terms beside ``launches``.

``style_epilogue`` is StyleGAN's layer epilogue before the instance norm,
``lrelu(x + noise·strength + bias)`` with one float32 noise value a pixel
and a strength and bias a channel, in one in-place pass, from
``s2p_tpu_torch/csrc/style_epilogue.cu``; it replaces no TPU kernel (the
JAX package has no StyleGAN). Bound by bytes (read and write x, read the
noise), with no gradient; ``style_epilogue_plan`` sets its launch and
``style_epilogue_plain`` is its plain version.

Each kernel source is compiled by ``nvcc`` for ``sm_90a`` at its first use
into ``build/s2p_tpu_torch/`` beside the package, named by the hash of its
source, the headers beside it and the flags so that an edited source is
rebuilt, and loaded with ``ctypes``: a program that never calls
``spade_norm`` (or ``hidden_maps``, or ``style_epilogue``) never builds it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path

import torch
from torch.autograd.function import once_differentiable

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "fused_mat_norm.cu"
SPADE_SOURCE = _PKG / "csrc" / "spade_norm.cu"
HIDDEN_SOURCE = _PKG / "csrc" / "hidden_maps.cu"
STYLE_SOURCE = _PKG / "csrc" / "style_epilogue.cu"
BUILD_DIR = _PKG.parent / "build" / "s2p_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the launch plan (chip_smoke.py --sweep times every plan at the main-path shapes)
TARGET_CTAS = 256  # about two CTAs per SM (132 on the H100 SXM)
WAVE_CTAS = 128  # about one CTA per SM: the target of an image too small to split
CLUSTER_SIZES = (1, 2, 4, 8)  # 8: the portable cluster limit
RESIDENT_BYTES = 100 * 1024  # a slice this small lets two CTAs share an SM
SPLIT_MIN_HW = 1024  # smaller images are split over a cluster only to fit
MIN_SPLIT_PIXELS = 256  # a cluster split for occupancy leaves each CTA this many pixels
# the vector path's channel multiple: whole tiles of >= 2 lanes (forward: StyleGAN's 16
# channels at 1024²) or >= 4 lanes (backward: the widths it was measured at)
VEC_MULTIPLE = {"forward": 16, "backward": 32}
STREAM_BYTES = 4 << 20  # a launch whose x (and dy) total this or less streams from L2
CTA_THREADS = 256  # threads of a CTA (kThreads in the .cu)
SCRATCH_BYTES_PER_CHANNEL = 88  # f32 reduction scratch, kScratchFloats in the .cu


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # CUDA_HOME, CUDA_PATH or nvcc on PATH

    if CUDA_HOME is None or not (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to build the CUDA kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build(source: Path = SOURCE) -> Path:
    """Compile ``source`` into a shared library if this source, the headers
    beside it (``csrc/*.cuh``) and these flags have not been built yet;
    returns the path of the library."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(header.read_bytes())
    lib = BUILD_DIR / f"{source.stem}_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    except subprocess.CalledProcessError as err:
        raise RuntimeError(f"nvcc failed on {source}:\n{err.stderr}") from err
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    lib = ctypes.CDLL(str(build()))
    fwd = lib.s2p_fused_mat_norm
    fwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                    + [ctypes.c_longlong] * 4
                    + [ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fwd.restype = ctypes.c_int
    bwd = lib.s2p_fused_mat_norm_bwd
    bwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                    + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    bwd.restype = ctypes.c_int
    return lib


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the accumulation type: float32, or float64 when it is."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _modulation(gamma, beta, gb_bias):
    """(1 + γ, β) in the accumulation type, with the γ‖β conv's bias
    ``gb_bias`` ``[2C]`` added as the kernels add it: (1 + b_γ) + γ, β + b_β."""
    if gb_bias is None:
        return 1.0 + _acc(gamma), _acc(beta)
    b_gamma, b_beta = _acc(gb_bias).chunk(2)
    return (1.0 + b_gamma) + _acc(gamma), _acc(beta) + b_beta


def _plain_forward(x, gamma, beta, eps, gb_bias=None):
    """(out, mean, rstd), the statistics ``[B, C]`` in the accumulation type."""
    xf = _acc(x)
    mean = xf.mean(dim=(1, 2), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 2), keepdim=True)
    rstd = torch.rsqrt(var + eps)
    one_gamma, beta = _modulation(gamma, beta, gb_bias)
    out = (xf - mean) * rstd * one_gamma + beta
    return out.to(x.dtype), mean[:, 0, 0], rstd[:, 0, 0]


def fused_mat_norm_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         eps: float = 1e-5, gb_bias: torch.Tensor | None = None) -> torch.Tensor:
    """``instance_norm(x) * (1 + gamma) + beta`` over NHWC: the port of
    ``_plain`` (pallas_kernels.py:41-45), computed in float32 (float64 for
    float64 inputs) and cast back to x's type, as the kernel does; two-pass
    variance, as ``jnp.var``. ``gb_bias`` ``[2C]`` is added to γ and β in
    that type first."""
    return _plain_forward(x, gamma, beta, eps, gb_bias)[0]


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
    s_b, s_h, s_w, s_c = t.stride()
    if C > 1 and s_c != 1:
        raise ValueError(f"{name}: channels must be unit-stride, got strides {t.stride()}")
    if H > 1 and W > 1 and s_h != W * s_w:
        raise ValueError(f"{name}: H and W must form one strided pixel axis, "
                         f"got strides {t.stride()}")
    return s_b, s_w if W > 1 else s_h


def _check(name: str, t: torch.Tensor, x: torch.Tensor) -> None:
    if t.device != x.device or t.dtype != x.dtype or t.shape != x.shape:
        raise ValueError(f"fused_mat_norm: {name} is {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}, x is {x.dtype} {tuple(x.shape)} on {x.device}")


def _check_gb_bias(kernel: str, gb_bias: torch.Tensor, x: torch.Tensor, *operands) -> None:
    """Raise unless ``gb_bias`` is a bias the kernel can fold: contiguous
    ``(2C,)`` of x's type on x's device, with no gradient to record (the
    kernels have none for it)."""
    C = x.shape[-1]
    if (gb_bias.shape != (2 * C,) or gb_bias.dtype != x.dtype or gb_bias.device != x.device
            or not gb_bias.is_contiguous()):
        raise ValueError(f"{kernel}: gb_bias must be contiguous {x.dtype} ({2 * C},) on "
                         f"{x.device}, got {gb_bias.dtype} {tuple(gb_bias.shape)} strides "
                         f"{gb_bias.stride()} on {gb_bias.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (gb_bias, x, *operands)):
        raise RuntimeError(f"{kernel}: a folded gb_bias has no backward: call it under "
                           "torch.no_grad()")


@dataclass(frozen=True)
class MATNormPlan:
    """How one MAT-norm launch covers its tensors (see the module docstring)."""
    tile_c: int  # channels of one (image, channel tile)
    cluster: int  # CTAs per (image, channel tile): the cluster size k
    pixels_per_cta: int  # contiguous pixels of each CTA (the last ones may run short)
    smem: int  # dynamic shared memory per CTA, bytes: the slice plus the scratch
    path: str  # "resident" (slice in shared memory) or "streaming"
    vec: bool  # 16-byte loads and stores
    grid: int  # CTAs launched: B · channel tiles · k


def plan_variant(batch: int, hw: int, C: int, dtype: torch.dtype, direction: str,
                 vec: bool, tile_c: int, cluster: int, resident: bool = True) -> MATNormPlan:
    """The plan of one channel tile and cluster size: ``resident`` when
    asked for and the slice fits in ``RESIDENT_BYTES``, else ``streaming``."""
    arrays = 1 if direction == "forward" else 2
    ppc = -(-hw // cluster)
    slice_bytes = arrays * ppc * tile_c * dtype.itemsize
    resident = resident and slice_bytes <= RESIDENT_BYTES
    return MATNormPlan(
        tile_c=tile_c, cluster=cluster, pixels_per_cta=ppc,
        smem=(slice_bytes if resident else 0) + SCRATCH_BYTES_PER_CHANNEL * tile_c,
        path="resident" if resident else "streaming", vec=vec,
        grid=batch * -(-C // tile_c) * cluster)


def plan_tiles(C: int, dtype: torch.dtype, vec: bool) -> list:
    """The channel tiles a launch may take, widest first: 8, 4 or 2
    sixteen-byte lanes on the vector path, 32 channels on the scalar one."""
    width = 16 // dtype.itemsize
    return [lanes * width for lanes in (8, 4, 2) if C % (lanes * width) == 0] if vec else [32]


@functools.cache
def mat_norm_plan(batch: int, hw: int, C: int, dtype: torch.dtype, direction: str,
                  vec_ok: bool) -> MATNormPlan:
    """The launch plan of one MAT-norm kernel call: ``direction`` is
    "forward" (x resident) or "backward" (x and dy resident); ``vec_ok``
    says that every base pointer and batch/pixel stride is 16-byte aligned.

    A launch whose x (and dy) total at most ``STREAM_BYTES`` streams.
    Otherwise each channel tile (``plan_tiles``) gets the smallest cluster
    whose slice fits in ``RESIDENT_BYTES``. On an image of at least
    ``SPLIT_MIN_HW`` pixels k is then raised (for occupancy) until the grid
    reaches ``TARGET_CTAS`` or a CTA would get fewer than
    ``MIN_SPLIT_PIXELS`` pixels; a smaller image aims at ``WAVE_CTAS``
    with its tile alone. A tile narrower than the widest is dropped when it
    leaves a thread fewer than two vectors per pass. The plan is the widest
    resident tile that reaches the aim (on a small image: of those with
    the smallest cluster), else the resident tile with the largest grid;
    ``streaming`` also when no tile fits at k = 8. More CTAs
    or clusters than that cost the small shapes more than they give (a
    cluster launch and its barriers, CTAs with little work each):
    ``chip_smoke.py --sweep`` times every plan."""
    if direction not in ("forward", "backward"):
        raise ValueError(f"mat_norm_plan: direction {direction!r}")
    vec = vec_ok and C % VEC_MULTIPLE[direction] == 0
    width = 16 // dtype.itemsize if vec else 1
    arrays = 1 if direction == "forward" else 2
    resident = arrays * batch * hw * C * dtype.itemsize > STREAM_BYTES
    split = hw >= SPLIT_MIN_HW
    aim = TARGET_CTAS if split else WAVE_CTAS
    options = []
    for tile_c in plan_tiles(C, dtype, vec):
        fits = [k for k in CLUSTER_SIZES if plan_variant(
            batch, hw, C, dtype, direction, vec, tile_c, k, resident).path == "resident"]
        k = fits[0] if fits else 1
        while (split and k < CLUSTER_SIZES[-1] and batch * -(-C // tile_c) * k < aim
               and -(-hw // (2 * k)) >= MIN_SPLIT_PIXELS):
            k *= 2
        if options and -(-hw // k) * (tile_c // width) < 2 * CTA_THREADS:
            continue  # narrower than the widest tile and leaves threads nearly idle
        options.append(plan_variant(batch, hw, C, dtype, direction, vec, tile_c, k, resident))
    pool = [o for o in options if o.path == "resident"] or options
    if not split:  # a cluster costs a small image more than a narrower tile
        pool.sort(key=lambda o: o.cluster)  # stable: the widest tile first within one k
    return next((o for o in pool if o.grid >= aim), max(pool, key=lambda o: o.grid))


def _plan(direction: str, x: torch.Tensor, tensors: tuple, strides: tuple) -> MATNormPlan:
    """``mat_norm_plan`` for x's shape, with the vector path allowed when
    every base pointer and element stride is 16-byte aligned."""
    B, H, W, C = x.shape
    bits = 0
    for t in tensors:
        bits |= t.data_ptr()
    for s in strides:
        bits |= s * x.element_size()
    return mat_norm_plan(B, H * W, C, x.dtype, direction, bits % 16 == 0)


def forward_plan(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> MATNormPlan:
    """The plan the forward kernel runs for these tensors."""
    strides = _batch_pixel_strides(gamma, "gamma") + _batch_pixel_strides(beta, "beta")
    return _plan("forward", x, (x, gamma, beta), strides)


def backward_plan(dy: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor) -> MATNormPlan:
    """The plan the backward kernel runs for these tensors (dy contiguous)."""
    return _plan("backward", x, (dy, x, gamma), _batch_pixel_strides(gamma, "gamma"))


def _plan_args(plan: MATNormPlan) -> tuple:
    """The plan as the C entry points take it."""
    return (plan.tile_c, plan.cluster, plan.pixels_per_cta, int(plan.path == "resident"),
            int(plan.vec), plan.smem)


def _on_stream(x: torch.Tensor, entry, *args) -> int:
    """``entry(*args, stream)`` on x's device and its current stream; returns
    the launch's cudaError_t. The raw stream handle is read without building
    a ``torch.cuda.Stream`` object, which costs a small launch more host time
    than its kernel takes on the card."""
    dev = x.device.index
    if dev != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _on_stream(x, entry, *args)
    return entry(*args, torch._C._cuda_getCurrentRawStream(dev))


def _launch_forward(x, gamma, beta, eps, save, gb_bias=None):
    """The forward kernel: (out, mean, rstd), the f32 ``[B, C]`` statistics
    only when ``save`` (else None, and the kernel writes none), with
    ``gb_bias`` (checked by the caller) folded in when given."""
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
        mean = torch.empty(B, C, device=x.device, dtype=torch.float32)
        rstd = torch.empty_like(mean)
    if out.numel() == 0:
        return out, mean, rstd
    plan = _plan("forward", x, (x, gamma, beta), (g_b, g_p, b_b, b_p))
    err = _on_stream(x, load_library().s2p_fused_mat_norm,
                     x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                     None if gb_bias is None else gb_bias.data_ptr(), out.data_ptr(),
                     mean.data_ptr() if save else None, rstd.data_ptr() if save else None,
                     B, H * W, C, g_b, g_p, b_b, b_p, _DTYPES[x.dtype], eps, *_plan_args(plan))
    if err != 0:
        raise RuntimeError(f"fused_mat_norm: kernel launch failed with cudaError {err}")
    fused_mat_norm.launches += 1
    fused_mat_norm.bias_launches += gb_bias is not None
    fused_mat_norm.style_launches += g_p == b_p == 0
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
    return _launch_backward(dy, x, gamma, mean, rstd)


def _launch_backward(dy, x, gamma, mean, rstd):
    """The backward kernel: (dx, dγ)."""
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
    plan = _plan("backward", x, (dy, x, gamma), (g_b, g_p))
    err = _on_stream(x, load_library().s2p_fused_mat_norm_bwd,
                     dy.data_ptr(), x.data_ptr(), gamma.data_ptr(), mean.data_ptr(),
                     rstd.data_ptr(), dx.data_ptr(), dgamma.data_ptr(), B, H * W, C, g_b, g_p,
                     _DTYPES[x.dtype], *_plan_args(plan))
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
                   eps: float = 1e-5, gb_bias: torch.Tensor | None = None) -> torch.Tensor:
    """``instance_norm(x) * (1 + gamma) + beta`` for NHWC ``[B, H, W, C]``
    tensors in float32 or bfloat16, differentiable in x, gamma and beta. On
    the card: the CUDA kernels. x must be contiguous; gamma and beta need
    unit channel stride only (they may be channel slices of one wider
    tensor). ``gb_bias`` ``[2C]``, inference only, is added to γ and β
    inside the forward kernel (the γ‖β conv's bias, see the module
    docstring)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_mat_norm: unsupported device {x.device}")
    if gb_bias is not None:
        _check_gb_bias("fused_mat_norm", gb_bias, x, gamma, beta)
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        return FusedMATNorm.apply(x, gamma, beta, eps, True)
    # nothing to differentiate (inference): the kernel alone, without autograd's overhead
    if x.device.type == "cpu":
        return _plain_forward(x, gamma, beta, eps, gb_bias)[0]
    return _launch_forward(x, gamma, beta, eps, False, gb_bias)[0]


fused_mat_norm.launches = fused_mat_norm.bias_launches = fused_mat_norm.style_launches = 0
fused_mat_norm_bwd.launches = 0


# -- SPADE's modulation with given statistics ---------------------------------

SPADE_THREADS = 256  # the most threads a block takes (kMaxThreads in spade_norm.cu)
SPADE_UNROLL = 2  # pixels a thread loads before it stores (kUnroll)
SPADE_BLOCKS_PER_SM = 8  # a grid of this many blocks an SM at most (2,048 threads)


@functools.cache
def load_spade_library() -> ctypes.CDLL:
    """Build (if needed) and load the SPADE-norm library."""
    lib = ctypes.CDLL(str(build(SPADE_SOURCE)))
    fn = lib.s2p_spade_norm
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 2
                   + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@dataclass(frozen=True)
class SpadeNormPlan:
    """How one SPADE-norm launch covers its tensors (see ``spade_norm.cu``)."""
    vec: bool  # 16-byte loads and stores
    lanes: int  # threads that cover one pixel's channel tile
    threads: int  # threads of a block: whole rows of ``lanes``
    c_tiles: int  # channel tiles (the grid's y)
    grid: int  # blocks over the pixels (the grid's x)


@functools.cache
def spade_norm_plan(pixels: int, C: int, dtype: torch.dtype, vec_ok: bool,
                    sms: int) -> SpadeNormPlan:
    """The launch plan of one ``spade_norm`` call over ``pixels`` = B·H·W
    pixels of C channels: the vector path when C is a multiple of a 16-byte
    vector and ``vec_ok`` (every base pointer and stride 16-byte aligned);
    a channel tile of at most ``SPADE_THREADS`` threads; as many rows of
    tiles as fit in a block; and blocks enough for every pixel at
    ``SPADE_UNROLL`` a thread, at most ``SPADE_BLOCKS_PER_SM`` an SM over
    the tiles (the kernel loops over the rest)."""
    width = 16 // dtype.itemsize
    vec = vec_ok and C % width == 0
    vectors = C // width if vec else C
    lanes = min(vectors, SPADE_THREADS)
    threads = lanes * (SPADE_THREADS // lanes)
    c_tiles = -(-vectors // lanes)
    rows = threads // lanes
    cap = max(1, SPADE_BLOCKS_PER_SM * sms // c_tiles)
    grid = max(1, min(-(-pixels // (rows * SPADE_UNROLL)), cap))
    return SpadeNormPlan(vec=vec, lanes=lanes, threads=threads, c_tiles=c_tiles, grid=grid)


def spade_norm_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     scale: torch.Tensor, shift: torch.Tensor,
                     gb_bias: torch.Tensor | None = None) -> torch.Tensor:
    """``(x·scale + shift)·(1 + gamma) + beta`` over NHWC, scale and shift
    ``[C]``: computed in float32 (float64 for float64 inputs) and cast back
    to x's type, as the kernel does. ``gb_bias`` ``[2C]`` is added to γ and
    β in that type first."""
    one_gamma, beta = _modulation(gamma, beta, gb_bias)
    out = (_acc(x) * _acc(scale) + _acc(shift)) * one_gamma + beta
    return out.to(x.dtype)


def _launch_spade(x, gamma, beta, scale, shift, gb_bias=None):
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.device != x.device or t.dtype != x.dtype or t.shape != x.shape:
            raise ValueError(f"spade_norm: {name} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, x is {x.dtype} {tuple(x.shape)} on {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"spade_norm: x must be contiguous 4-D float32/bfloat16 NHWC, got "
                         f"{x.dtype} {tuple(x.shape)} strides {x.stride()}")
    B, H, W, C = x.shape
    for name, t in (("scale", scale), ("shift", shift)):
        if (t.dtype != torch.float32 or t.shape != (C,) or not t.is_contiguous()
                or t.device != x.device):
            raise ValueError(f"spade_norm: {name} must be contiguous float32 ({C},) on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    g_b, g_p = _batch_pixel_strides(gamma, "gamma")
    b_b, b_p = _batch_pixel_strides(beta, "beta")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    bits = x.data_ptr() | gamma.data_ptr() | beta.data_ptr()
    for s in (g_b, g_p, b_b, b_p):
        bits |= s * x.element_size()
    plan = spade_norm_plan(B * H * W, C, x.dtype, bits % 16 == 0, _sm_count(x.device.index))
    err = _on_stream(x, load_spade_library().s2p_spade_norm,
                     x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), scale.data_ptr(),
                     shift.data_ptr(), None if gb_bias is None else gb_bias.data_ptr(),
                     out.data_ptr(), B * H * W, H * W, C, g_b, g_p, b_b, b_p,
                     _DTYPES[x.dtype], int(plan.vec), plan.lanes, plan.threads, plan.grid,
                     plan.c_tiles)
    if err != 0:
        raise RuntimeError(f"spade_norm: kernel launch failed with cudaError {err}")
    spade_norm.launches += 1
    spade_norm.bias_launches += gb_bias is not None
    return out


def spade_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               scale: torch.Tensor, shift: torch.Tensor,
               gb_bias: torch.Tensor | None = None) -> torch.Tensor:
    """``(x·scale + shift)·(1 + gamma) + beta`` for NHWC ``[B, H, W, C]``
    tensors in float32 or bfloat16 with f32 ``scale``/``shift`` ``[C]``. On
    the card: the CUDA kernel, for inference only (it raises where autograd
    would record: SPADE's generator is not trained in the port). x must be
    contiguous; gamma and beta need unit channel stride only (they may be
    channel slices of one wider tensor). ``gb_bias`` ``[2C]`` is added to γ
    and β inside the kernel (the γ‖β conv's bias, see the module
    docstring). On the CPU: the plain version."""
    if gb_bias is not None:
        _check_gb_bias("spade_norm", gb_bias, x, gamma, beta, scale, shift)
    if x.device.type == "cpu":
        return spade_norm_plain(x, gamma, beta, scale, shift, gb_bias)
    if x.device.type != "cuda":
        raise ValueError(f"spade_norm: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, gamma, beta, scale, shift)):
        raise RuntimeError("spade_norm has no backward: call it under torch.no_grad()")
    return _launch_spade(x, gamma, beta, scale, shift, gb_bias)


spade_norm.launches = spade_norm.bias_launches = 0


# -- a res-block's hidden maps ------------------------------------------------

HIDDEN_THREADS = 256  # the most threads a block takes (kMaxThreads in hidden_maps.cu)
HIDDEN_UNROLL = 4  # pixels a thread loads before it stores (kUnroll)
HIDDEN_BLOCKS_PER_SM = 8  # a grid of this many blocks an SM at most (2,048 threads)
HIDDEN_MAX_NORMS = 4  # kMaxNorms
CMAP_ROWS = 9  # the constant-map terms: full, top, bottom, left, right, corners 00, 02, 20, 22


@functools.cache
def load_hidden_maps_library() -> ctypes.CDLL:
    """Build (if needed) and load the hidden-map library."""
    lib = ctypes.CDLL(str(build(HIDDEN_SOURCE)))
    fn = lib.s2p_hidden_maps
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


@dataclass(frozen=True)
class HiddenMapsPlan:
    """How one hidden-map launch covers its tensors (see ``hidden_maps.cu``)."""
    vec: bool  # 16-byte loads and stores
    lanes: int  # threads that cover one pixel's channel tile
    threads: int  # threads of a block: whole rows of ``lanes``
    c_tiles: int  # channel tiles (the grid's y; the images are its z)
    grid: int  # blocks over one image's pixels (the grid's x)


@functools.cache
def hidden_maps_plan(batch: int, hw: int, widths: tuple, dtype: torch.dtype, vec_ok: bool,
                     sms: int) -> HiddenMapsPlan:
    """The launch plan of one ``hidden_maps`` call over ``batch`` images of
    ``hw`` pixels and the norms' ``widths``: the vector path when every
    width is a multiple of a 16-byte vector and ``vec_ok`` (every base
    pointer and stride 16-byte aligned); a channel tile of at most
    ``HIDDEN_THREADS`` threads; as many rows of tiles as fit in a block; and
    blocks enough for an image's pixels at ``HIDDEN_UNROLL`` a thread, at
    most ``HIDDEN_BLOCKS_PER_SM`` an SM over the images and tiles (the
    kernel loops over the rest)."""
    width = 16 // dtype.itemsize
    vec = vec_ok and all(w % width == 0 for w in widths)
    vectors = sum(widths) // width if vec else sum(widths)
    lanes = min(vectors, HIDDEN_THREADS)
    threads = lanes * (HIDDEN_THREADS // lanes)
    c_tiles = -(-vectors // lanes)
    rows = threads // lanes
    cap = max(1, HIDDEN_BLOCKS_PER_SM * sms // (c_tiles * batch))
    grid = max(1, min(-(-hw // (rows * HIDDEN_UNROLL)), cap))
    return HiddenMapsPlan(vec=vec, lanes=lanes, threads=threads, c_tiles=c_tiles, grid=grid)


def _hidden_outputs(h: torch.Tensor, widths: tuple) -> tuple:
    """One allocation for the norms' maps and each map in it: norm k's
    ``[B, F_k, H, W]`` channels_last-contiguous at B·H·W·(F_0 + … + F_{k−1})."""
    B, _, H, W = h.shape
    n = B * H * W
    buf = torch.empty(n * sum(widths), dtype=h.dtype, device=h.device)
    maps, off = [], 0
    for w in widths:
        maps.append(buf[off:off + n * w].view(B, H, W, w).permute(0, 3, 1, 2))
        off += n * w
    return buf, maps


def hidden_maps_plain(h: torch.Tensor, bias: torch.Tensor, widths, terms=None) -> list:
    """What ``hidden_maps`` computes, in float32 (float64 for float64
    inputs) with one rounding to h's type: ``h + (bias + full)``, each
    border row and column less its term and each corner plus its own, in
    that order (every term that applies, as ``_add_const_map`` applies them
    in place), ReLU, split by ``widths`` into channels_last-contiguous maps
    of one allocation."""
    t = None if terms is None else _acc(terms)
    base = _acc(bias)[None] if t is None else _acc(bias) + t[:, 0]
    v = _acc(h) + base[:, :, None, None]
    if t is not None:
        v[:, :, 0] -= t[:, 1, :, None]
        v[:, :, -1] -= t[:, 2, :, None]
        v[:, :, :, 0] -= t[:, 3, :, None]
        v[:, :, :, -1] -= t[:, 4, :, None]
        v[:, :, 0, 0] += t[:, 5]
        v[:, :, 0, -1] += t[:, 6]
        v[:, :, -1, 0] += t[:, 7]
        v[:, :, -1, -1] += t[:, 8]
    v = torch.relu(v).to(h.dtype)
    _, maps = _hidden_outputs(h, tuple(widths))
    for m, part in zip(maps, torch.split(v, list(widths), dim=1)):
        m.copy_(part)
    return maps


def _check_hidden(h, bias, widths, terms) -> None:
    """Raise ``ValueError`` unless the operands are what ``hidden_maps``
    takes (the layout of h is the card's to check)."""
    if h.dim() != 4 or h.dtype not in _DTYPES:
        raise ValueError(f"hidden_maps: h must be 4-D float32/bfloat16 [B, C, H, W], got "
                         f"{h.dtype} {tuple(h.shape)}")
    B, C = h.shape[:2]
    if not 0 < len(widths) <= HIDDEN_MAX_NORMS or min(widths) <= 0 or sum(widths) != C:
        raise ValueError(f"hidden_maps: widths {widths} must be 1 to {HIDDEN_MAX_NORMS} "
                         f"positive widths summing to h's {C} channels")
    if (bias.shape != (C,) or bias.dtype != h.dtype or bias.device != h.device
            or not bias.is_contiguous()):
        raise ValueError(f"hidden_maps: bias must be contiguous {h.dtype} ({C},) on {h.device}, "
                         f"got {bias.dtype} {tuple(bias.shape)} on {bias.device}")
    if terms is not None and (terms.shape != (B, CMAP_ROWS, C) or terms.dtype != h.dtype
                              or terms.device != h.device or (C > 1 and terms.stride(2) != 1)):
        raise ValueError(f"hidden_maps: terms must be {h.dtype} ({B}, {CMAP_ROWS}, {C}) on "
                         f"{h.device} with a unit channel stride, got {terms.dtype} "
                         f"{tuple(terms.shape)} strides {terms.stride()} on {terms.device}")


def _launch_hidden_maps(h, bias, widths, terms):
    if not h.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"hidden_maps: h must be channels_last-contiguous, got strides "
                         f"{h.stride()}")
    B, C, H, W = h.shape
    if B > 65535:
        raise ValueError(f"hidden_maps: at most 65,535 images a launch, got {B}")
    buf, maps = _hidden_outputs(h, widths)
    if buf.numel() == 0:
        return maps
    t_b = t_r = 0
    bits = h.data_ptr() | bias.data_ptr() | buf.data_ptr()
    if terms is not None:
        t_b, t_r = terms.stride(0), terms.stride(1)
        bits |= terms.data_ptr() | t_b * h.element_size() | t_r * h.element_size()
    plan = hidden_maps_plan(B, H * W, widths, h.dtype, bits % 16 == 0, _sm_count(h.device.index))
    err = _on_stream(h, load_hidden_maps_library().s2p_hidden_maps,
                     h.data_ptr(), bias.data_ptr(), None if terms is None else terms.data_ptr(),
                     buf.data_ptr(), B, H, W, C, t_b, t_r,
                     *widths, *(0,) * (HIDDEN_MAX_NORMS - len(widths)), len(widths),
                     _DTYPES[h.dtype], int(plan.vec), plan.lanes, plan.threads, plan.grid,
                     plan.c_tiles)
    if err != 0:
        raise RuntimeError(f"hidden_maps: kernel launch failed with cudaError {err}")
    hidden_maps.launches += 1
    hidden_maps.cmap_launches += terms is not None
    return maps


def hidden_maps(h: torch.Tensor, bias: torch.Tensor, widths, terms=None) -> list:
    """A res-block's hidden maps from its shared conv's bias-free output
    ``h`` ``[B, ΣF, H, W]`` (float32 or bfloat16; on the card in
    channels_last memory): ``relu(h + bias [+ the constant-map terms])``
    split by ``widths`` into one ``[B, F_k, H, W]`` map a norm, each
    channels_last-contiguous, all in one allocation. ``terms`` ``[B, 9,
    ΣF]`` (unit channel stride; any batch and row strides) are S2P's
    constant-map terms (``fast_inference._add_const_map``'s rows). On the
    card: the CUDA kernel, for inference only (it raises where autograd
    would record). On the CPU: the plain version."""
    widths = tuple(int(w) for w in widths)
    _check_hidden(h, bias, widths, terms)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (h, bias, terms)):
        raise RuntimeError("hidden_maps has no backward: call it under torch.no_grad()")
    if h.device.type == "cpu":
        return hidden_maps_plain(h, bias, widths, terms)
    if h.device.type != "cuda":
        raise ValueError(f"hidden_maps: unsupported device {h.device}")
    return _launch_hidden_maps(h, bias, widths, terms)


hidden_maps.launches = hidden_maps.cmap_launches = 0


# -- StyleGAN's layer epilogue ------------------------------------------------------

STYLE_THREADS = 256  # threads of a block (kThreads in style_epilogue.cu)
STYLE_UNROLL = 4  # vectors a thread loads before it stores (kUnroll)
STYLE_BLOCKS_PER_SM = 8  # a grid of this many blocks an SM at most (2,048 threads)


@functools.cache
def load_style_epilogue_library() -> ctypes.CDLL:
    """Build (if needed) and load the style-epilogue library."""
    lib = ctypes.CDLL(str(build(STYLE_SOURCE)))
    fn = lib.s2p_style_epilogue
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def style_epilogue_plan(elems: int, C: int, dtype: torch.dtype, vec_ok: bool,
                        sms: int) -> tuple[bool, int]:
    """(vector path, grid) of one ``style_epilogue`` launch over ``elems`` =
    B·H·W·C values: 16-byte vectors when C is a multiple of one and
    ``vec_ok`` (x, strength and bias 16-byte aligned); blocks enough for
    every vector at ``STYLE_UNROLL`` a thread, at most
    ``STYLE_BLOCKS_PER_SM`` an SM (the kernel loops over the rest)."""
    width = 16 // dtype.itemsize
    vec = vec_ok and C % width == 0
    vectors = elems // (width if vec else 1)
    return vec, max(1, min(-(-vectors // (STYLE_THREADS * STYLE_UNROLL)),
                           STYLE_BLOCKS_PER_SM * sms))


def style_epilogue_plain(x: torch.Tensor, noise: torch.Tensor, strength: torch.Tensor,
                         bias: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """``lrelu(x + noise·strength + bias, slope)`` over NHWC x ``[B, H, W,
    C]`` with noise ``[B, H, W]`` (float32) and strength and bias ``[C]``:
    computed in float32 (float64 for float64 inputs) and rounded once to
    x's type, as the kernel does."""
    t = _acc(x) + _acc(noise)[..., None] * _acc(strength) + _acc(bias)
    return torch.where(t > 0, t, t * slope).to(x.dtype)


def _check_style_epilogue(x, noise, strength, bias) -> None:
    if x.dim() != 4 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"style_epilogue: x must be contiguous 4-D float32/bfloat16 NHWC, got "
                         f"{x.dtype} {tuple(x.shape)} strides {x.stride()}")
    B, H, W, C = x.shape
    if (noise.shape != (B, H, W) or noise.dtype != torch.float32 or not noise.is_contiguous()
            or noise.device != x.device):
        raise ValueError(f"style_epilogue: noise must be contiguous float32 {(B, H, W)} on "
                         f"{x.device}, got {noise.dtype} {tuple(noise.shape)} on {noise.device}")
    for name, t in (("strength", strength), ("bias", bias)):
        if t.shape != (C,) or t.dtype != x.dtype or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"style_epilogue: {name} must be contiguous {x.dtype} ({C},) on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def style_epilogue(x: torch.Tensor, noise: torch.Tensor, strength: torch.Tensor,
                   bias: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """StyleGAN's ``apply_noise``, ``apply_bias`` and leaky ReLU in place:
    x ``[B, H, W, C]`` (contiguous NHWC, float32 or bfloat16) becomes
    ``lrelu(x + noise·strength + bias, slope)``, noise ``[B, H, W]``
    float32, strength and bias ``[C]`` of x's type; returns x. On the card:
    the CUDA kernel, for inference only (it raises where autograd would
    record). On the CPU: the plain version, written into x."""
    _check_style_epilogue(x, noise, strength, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, noise, strength, bias)):
        raise RuntimeError("style_epilogue has no backward: call it under torch.no_grad()")
    if x.device.type == "cpu":
        return x.copy_(style_epilogue_plain(x, noise, strength, bias, slope))
    if x.device.type != "cuda":
        raise ValueError(f"style_epilogue: unsupported device {x.device}")
    if x.numel() == 0:
        return x
    bits = x.data_ptr() | strength.data_ptr() | bias.data_ptr()
    vec, grid = style_epilogue_plan(x.numel(), x.shape[-1], x.dtype, bits % 16 == 0,
                                    _sm_count(x.device.index))
    err = _on_stream(x, load_style_epilogue_library().s2p_style_epilogue,
                     x.data_ptr(), noise.data_ptr(), strength.data_ptr(), bias.data_ptr(),
                     x.numel(), x.shape[-1], slope, _DTYPES[x.dtype], int(vec), grid)
    if err != 0:
        raise RuntimeError(f"style_epilogue: kernel launch failed with cudaError {err}")
    style_epilogue.launches += 1
    return x


style_epilogue.launches = 0
