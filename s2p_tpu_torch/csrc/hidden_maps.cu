// A res-block's hidden maps for Hopper (sm_90a), in one pass over the
// shared conv's output:
//   v = h + (bias[c] + full[b,c]) - top[b,c]*[y=0] - bot[b,c]*[y=H-1]
//         - left[b,c]*[x=0] - right[b,c]*[x=W-1]
//         + c00[b,c]*[y=0,x=0] + c02[b,c]*[y=0,x=W-1]
//         + c20[b,c]*[y=H-1,x=0] + c22[b,c]*[y=H-1,x=W-1]
//   out = max(v, 0), rounded once to h's type,
// computed in f32 in that order, every term that applies applied (at H = 1
// or W = 1 both edge terms and all four corners land on one pixel), and
// written per norm.
//
// Replaces no TPU kernel: on the TPU XLA fuses the same arithmetic (the JAX
// package's fast_inference.py::_block_hidden_maps builds 0/1 border masks
// and one ReLU). In eager PyTorch it was a broadcast add, 8 strided border
// updates, a ReLU and, per norm, a copy of its channel slice into a
// contiguous map: four passes over every hidden map.
//
// What it computes. h is the bias-free output [B, H, W, C] (NHWC,
// contiguous) of one 3x3 conv that gives a block's 2-3 norms their hidden
// maps side by side (C = the sum of the norms' widths). S2P's fast path adds
// the conv over the state's constant map from its 9 reduced terms
// (terms [B, 9, C]: full sum, top, bottom, left, right, then the corners 00,
// 02, 20, 22; a strided slice of the whole network's terms, read through its
// batch and row strides with a unit channel stride). GauGAN's fast path has
// no terms: the kernel then adds the bias and applies the ReLU only (kTerms,
// a template flag chosen by the pointer).
//
// Output. Norm k's map is written channels_last-contiguous ([B, H, W, F_k])
// into one allocation at the offset B*H*W*(F_0 + ... + F_{k-1}), so that
// each map is the unit-stride NHWC operand the gamma||beta conv reads,
// with no copy.
//
// Bound. At most 17 flops per element against 2 elements moved (read h,
// write out): bytes bound it, 2 * B*H*W*C * itemsize at 3.35 TB/s. The
// bias and terms ([C] and [B, 9, C]) are read once per thread or, for the
// border terms, per border pixel from L1/L2.
//
// Design, as spade_norm.cu's: a thread owns one 16-byte vector of channels
// (8 bf16 or 4 f32; one channel on the scalar path), `lanes` consecutive
// threads cover a channel tile of one pixel, and the block's rows of threads
// walk the pixels of ONE image (blockIdx.z) in a grid-stride loop, kUnroll
// pixels a step. So a thread holds bias + full for its image and channels in
// registers, and loads the border terms only at border pixels. Its channels
// lie in one norm (every width a multiple of the vector on the vector
// path), found once. The vector path needs C and every width a multiple of
// the vector and 16-byte aligned pointers and strides; else the scalar
// variant runs. The plan (lanes, threads, grid) is computed by the Python
// wrapper (gan/cuda_kernels.py::hidden_maps_plan); this file only checks
// that it is consistent.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "vec_io.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kUnroll = 4;  // pixels a thread loads before it stores
constexpr int kMaxNorms = 4;

template <typename T>
struct HiddenArgs {
  const T* h;  // [B, H, W, C] contiguous
  const T* bias;  // [C]
  const T* terms;  // [B, 9, C] with unit channel stride, or null
  T* out;  // the norms' maps, [B, H, W, F_k] each, one after another
  int H, W, C, lanes, norms;
  int start[kMaxNorms + 1];  // norm k's channels: start[k] .. start[k + 1]
  long long t_bstride, t_rstride;
};

template <typename T, int V, bool kTerms>
__global__ void __launch_bounds__(kMaxThreads) hidden_maps_kernel(const HiddenArgs<T> a) {
  const int c = (blockIdx.y * a.lanes + threadIdx.x % a.lanes) * V;
  if (c >= a.C) return;  // the ragged last tile of the scalar path
  const int hw = a.H * a.W;  // < 2^31 (plan_ok)
  const long long b = blockIdx.z;
  // this thread's norm's channels, lo .. hi (constant indices: no stack copy of the args)
  int lo = 0, hi = a.start[1];
#pragma unroll
  for (int k = 1; k < kMaxNorms; ++k) {
    if (k < a.norms && c >= a.start[k]) {
      lo = a.start[k];
      hi = a.start[k + 1];
    }
  }
  const int F = hi - lo;
  const T* in = a.h + b * hw * a.C + c;
  T* out = a.out + (long long)gridDim.z * hw * lo + b * hw * F + (c - lo);
  float base[V];  // bias + full, once for this image and these channels
  load_vec<T, V>(a.bias + c, base);
  const T* t = nullptr;
  if constexpr (kTerms) {
    t = a.terms + b * a.t_bstride + c;
    float full[V];
    load_vec<T, V>(t, full);
#pragma unroll
    for (int v = 0; v < V; ++v) base[v] += full[v];
  }
  const int rows = blockDim.x / a.lanes;
  const int step = gridDim.x * rows;
  for (int q0 = blockIdx.x * rows + threadIdx.x / a.lanes; q0 < hw; q0 += kUnroll * step) {
    float xv[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = q0 + u * step;
      if (q < hw) load_vec<T, V>(in + (long long)q * a.C, xv[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = q0 + u * step;
      if (q >= hw) continue;
      float r[V];
#pragma unroll
      for (int v = 0; v < V; ++v) r[v] = xv[u][v] + base[v];
      if constexpr (kTerms) {
        const int y = q / a.W, x = q - y * a.W;
        const bool top = y == 0, bot = y == a.H - 1, left = x == 0, right = x == a.W - 1;
        if (top || bot || left || right) {  // in _add_const_map's order
          auto term = [&](int row, bool add) {
            float tv[V];
            load_vec<T, V>(t + row * a.t_rstride, tv);
#pragma unroll
            for (int v = 0; v < V; ++v) r[v] = add ? r[v] + tv[v] : r[v] - tv[v];
          };
          if (top) term(1, false);
          if (bot) term(2, false);
          if (left) term(3, false);
          if (right) term(4, false);
          if (top && left) term(5, true);
          if (top && right) term(6, true);
          if (bot && left) term(7, true);
          if (bot && right) term(8, true);
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) r[v] = r[v] < 0.f ? 0.f : r[v];  // NaN stays NaN, as relu
      store_vec<T, V>(out + (long long)q * F, r);
    }
  }
}

// The plan's consistency with this kernel: whole pixel rows of threads, a
// tile that covers C, widths that sum to C, and the vector path only on
// whole vectors of one norm.
bool plan_ok(int batch, int H, int W, int C, const int* widths, int norms, int width, int lanes,
             int threads, int grid, int c_tiles) {
  if (batch <= 0 || batch > 65535 || H <= 0 || W <= 0 || C <= 0 || C % width != 0) return false;
  if ((long long)H * W > 0x7fffffffLL / kMaxThreads) return false;  // int pixel indices
  if (norms <= 0 || norms > kMaxNorms) return false;
  long long sum = 0;
  for (int k = 0; k < norms; ++k) {
    if (widths[k] <= 0 || widths[k] % width != 0) return false;
    sum += widths[k];
  }
  if (sum != C || lanes <= 0 || threads <= 0 || threads > kMaxThreads) return false;
  if (threads % lanes != 0 || grid <= 0 || c_tiles <= 0 || c_tiles > 65535) return false;
  return (long long)c_tiles * lanes * width >= C && (long long)(c_tiles - 1) * lanes * width < C;
}

template <typename T, int V, bool kTerms>
cudaError_t launch(const HiddenArgs<T>& a, int batch, int threads, int grid, int c_tiles,
                   cudaStream_t stream) {
  hidden_maps_kernel<T, V, kTerms><<<dim3(grid, c_tiles, batch), threads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t hidden_maps(const void* h, const void* bias, const void* terms, void* out, int batch,
                        int H, int W, int C, long long t_bstride, long long t_rstride,
                        const int* widths, int norms, int vec, int lanes, int threads,
                        int grid, int c_tiles, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (!plan_ok(batch, H, W, C, widths, norms, vec ? V : 1, lanes, threads, grid, c_tiles))
    return cudaErrorInvalidValue;
  HiddenArgs<T> a{static_cast<const T*>(h), static_cast<const T*>(bias),
                  static_cast<const T*>(terms), static_cast<T*>(out), H, W, C, lanes, norms,
                  {}, t_bstride, t_rstride};
  for (int k = 0; k < norms; ++k) a.start[k + 1] = a.start[k] + widths[k];
  if (terms != nullptr)
    return vec ? launch<T, V, true>(a, batch, threads, grid, c_tiles, stream)
               : launch<T, 1, true>(a, batch, threads, grid, c_tiles, stream);
  return vec ? launch<T, V, false>(a, batch, threads, grid, c_tiles, stream)
             : launch<T, 1, false>(a, batch, threads, grid, c_tiles, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for h, bias, terms and out alike; terms
// (the constant-map terms, [B, 9, C] with unit channel stride and the given
// batch and row strides) may be null. w0..w3 are the norms' widths (the
// first `norms` of them). vec ... c_tiles are the launch plan
// (cuda_kernels.py::hidden_maps_plan). Returns the launch's cudaError_t;
// cudaErrorInvalidValue for a plan this file cannot run.
extern "C" int s2p_hidden_maps(const void* h, const void* bias, const void* terms, void* out,
                               int batch, int H, int W, int C, long long t_bstride,
                               long long t_rstride, int w0, int w1, int w2, int w3, int norms,
                               int dtype, int vec, int lanes, int threads, int grid, int c_tiles,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int widths[kMaxNorms] = {w0, w1, w2, w3};
  if (dtype == 0)
    return hidden_maps<float>(h, bias, terms, out, batch, H, W, C, t_bstride, t_rstride, widths,
                              norms, vec, lanes, threads, grid, c_tiles, s);
  if (dtype == 1)
    return hidden_maps<__nv_bfloat16>(h, bias, terms, out, batch, H, W, C, t_bstride, t_rstride,
                                      widths, norms, vec, lanes, threads, grid, c_tiles, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
