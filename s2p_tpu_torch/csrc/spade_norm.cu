// SPADE modulation with given statistics for Hopper (sm_90a):
//   out = (x * a + b) * (1 + gamma) + beta
// with per-channel f32 a = rsqrt(running_var + eps) and b = -running_mean * a,
// folded once when the fast path's operands are fused
// (gan/fast_inference.py::fuse_fast_params). It is the SPADE norm of GauGAN's
// generator (NVlabs/SPADE, models/networks/normalization.py::SPADE) at
// inference: its param-free batch norm reads the running statistics there.
//
// Replaces no TPU kernel: the JAX package has no SPADE generator. It was added
// because no kernel of the port computes this: fused_mat_norm.cu computes
// instance statistics over H*W itself, in three passes over x.
//
// Layout, as fused_mat_norm's forward: x and out are NHWC and contiguous;
// gamma and beta keep a unit channel stride with their own batch and pixel
// strides. On the fast path they are the two channel halves of one
// gamma||beta conv output (pixel stride 2C), read in place with no copy.
//
// Bound. 5 flops per element (x*a + b, 1 + gamma, the product, + beta)
// against 4 elements moved (read x, gamma and beta, write out): in bf16 0.6
// flop per byte, far below the card's ~20 (f32 CUDA cores) or ~295 (bf16
// tensor cores), so bytes bound it. a and b are [C] and stay in registers.
// At 3.35 TB/s the 18 norms of one 256px GauGAN pass (ngf 64) at batch 32 in
// bf16 move 10.4 GB: >= 3.1 ms.
//
// Design. One pass with no reduction, so nothing to keep on chip but a and b:
// one launch covers every element. A thread owns one 16-byte vector of
// channels (8 bf16 or 4 f32; one channel on the scalar path) and loads its a
// and b into registers once; `lanes` consecutive threads cover a channel tile
// of one pixel, so a warp's loads of x, gamma and beta are whole 128-byte
// lines. The block's rows of threads walk the pixels in a grid-stride loop
// (the channel tile is blockIdx.y), kUnroll pixels a step, so that a thread
// has 3 * kUnroll loads in flight before it stores. The vector path needs C a
// multiple of the vector and 16-byte aligned pointers and strides; else the
// scalar variant of the same kernel runs. The plan (tile, threads, grid) is
// computed by the Python wrapper (gan/cuda_kernels.py::spade_norm_plan);
// this file only checks that it is consistent.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "vec_io.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kUnroll = 2;  // pixels a thread loads before it stores

template <typename T>
struct SpadeArgs {
  const T* x;
  const T* gamma;
  const T* beta;
  const float* scale;  // a, f32 [C]
  const float* shift;  // b, f32 [C]
  T* out;
  long long pixels;  // B * H * W
  int hw, C, lanes;  // lanes: threads that cover one pixel's channel tile
  long long g_bstride, g_pstride, b_bstride, b_pstride;
};

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads) spade_norm_kernel(const SpadeArgs<T> a) {
  const int c = (blockIdx.y * a.lanes + threadIdx.x % a.lanes) * V;
  if (c >= a.C) return;  // the ragged last tile of the scalar path
  const int rows = blockDim.x / a.lanes;
  float sc[V], sh[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    sc[v] = a.scale[c + v];
    sh[v] = a.shift[c + v];
  }
  const long long step = (long long)gridDim.x * rows;
  for (long long p0 = (long long)blockIdx.x * rows + threadIdx.x / a.lanes; p0 < a.pixels;
       p0 += kUnroll * step) {
    float xv[kUnroll][V], gv[kUnroll][V], bv[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long p = p0 + u * step;
      if (p < a.pixels) {
        const long long img = p / a.hw, q = p - img * a.hw;
        load_vec<T, V>(a.x + p * a.C + c, xv[u]);
        load_vec<T, V>(a.gamma + img * a.g_bstride + q * a.g_pstride + c, gv[u]);
        load_vec<T, V>(a.beta + img * a.b_bstride + q * a.b_pstride + c, bv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long p = p0 + u * step;
      if (p < a.pixels) {
        float r[V];
#pragma unroll
        for (int v = 0; v < V; ++v) r[v] = (xv[u][v] * sc[v] + sh[v]) * (1.f + gv[u][v]) + bv[u][v];
        store_vec<T, V>(a.out + p * a.C + c, r);
      }
    }
  }
}

// The plan's consistency with this kernel: whole pixel rows of threads, a
// tile that covers C, and the vector path only on whole vectors.
bool plan_ok(long long pixels, int hw, int C, int width, int lanes, int threads, int grid,
             int c_tiles) {
  if (pixels <= 0 || hw <= 0 || C <= 0 || pixels % hw != 0) return false;
  if (C % width != 0 || lanes <= 0 || threads <= 0 || threads > kMaxThreads) return false;
  if (threads % lanes != 0 || grid <= 0 || c_tiles <= 0 || c_tiles > 65535) return false;
  return (long long)c_tiles * lanes * width >= C && (long long)(c_tiles - 1) * lanes * width < C;
}

template <typename T, int V>
cudaError_t launch(const SpadeArgs<T>& a, int threads, int grid, int c_tiles,
                   cudaStream_t stream) {
  spade_norm_kernel<T, V><<<dim3(grid, c_tiles), threads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t forward(const void* x, const void* gamma, const void* beta, const void* scale,
                    const void* shift, void* out, long long pixels, int hw, int C,
                    long long g_bstride, long long g_pstride, long long b_bstride,
                    long long b_pstride, int vec, int lanes, int threads, int grid,
                    int c_tiles, cudaStream_t stream) {
  constexpr int W = 16 / sizeof(T);
  if (!plan_ok(pixels, hw, C, vec ? W : 1, lanes, threads, grid, c_tiles))
    return cudaErrorInvalidValue;
  const SpadeArgs<T> a{static_cast<const T*>(x),      static_cast<const T*>(gamma),
                       static_cast<const T*>(beta),   static_cast<const float*>(scale),
                       static_cast<const float*>(shift), static_cast<T*>(out),
                       pixels, hw, C, lanes, g_bstride, g_pstride, b_bstride, b_pstride};
  return vec ? launch<T, W>(a, threads, grid, c_tiles, stream)
             : launch<T, 1>(a, threads, grid, c_tiles, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; scale and shift are f32 [C]. vec ...
// c_tiles are the launch plan (cuda_kernels.py::spade_norm_plan). Returns the
// launch's cudaError_t; cudaErrorInvalidValue for a plan this file cannot run.
extern "C" int s2p_spade_norm(const void* x, const void* gamma, const void* beta,
                              const void* scale, const void* shift, void* out,
                              long long pixels, int hw, int C, long long g_bstride,
                              long long g_pstride, long long b_bstride, long long b_pstride,
                              int dtype, int vec, int lanes, int threads, int grid, int c_tiles,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return forward<float>(x, gamma, beta, scale, shift, out, pixels, hw, C, g_bstride,
                          g_pstride, b_bstride, b_pstride, vec, lanes, threads, grid, c_tiles,
                          s);
  if (dtype == 1)
    return forward<__nv_bfloat16>(x, gamma, beta, scale, shift, out, pixels, hw, C, g_bstride,
                                  g_pstride, b_bstride, b_pstride, vec, lanes, threads, grid,
                                  c_tiles, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
