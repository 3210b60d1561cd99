// StyleGAN's layer epilogue before the instance norm, for Hopper (sm_90a),
// in one pass, in place:
//   x = lrelu(x + noise * strength[c] + bias[c], slope)
// computed in f32 as fmaf(noise, strength, x) + bias, then the leaky ReLU,
// rounded once to x's type.
//
// Replaces no TPU kernel (the JAX package has no StyleGAN); it replaces the
// eager epilogue of networks_stylegan.py's layer_epilogue (apply_noise,
// apply_bias, the leaky ReLU): three passes over the activation, two of
// them PyTorch's broadcasting elementwise kernel, which does not vectorize
// a [1, C, 1, 1] or [B, 1, H, W] operand against a channels_last map.
//
// Layout. x is NHWC and contiguous ([B, H, W, C], channels the unit-stride
// axis); noise is one float32 value a pixel ([B, H, W], contiguous: the
// [B, 1, H, W] map StyleGAN draws); strength and bias are [C] of x's type.
//
// Bound. 4 flops per element against 2 elements moved (read x, write x) and
// 4 bytes of noise a pixel: bytes bound it, B*H*W*(2*C*itemsize + 4) at
// 3.35 TB/s.
//
// Design. A thread owns one 16-byte vector of channels (8 bf16 or 4 f32; one
// channel on the scalar path) of one pixel and walks the tensor in a
// grid-stride loop, kUnroll vectors a step: it issues the loads of all of
// them (x and the pixel's noise; the threads of one pixel read the same
// noise word, which L1 serves) before the first store, then reads the
// channels' strength and bias (L1 hits after the first pass). The vector
// path needs C a multiple of the vector and 16-byte aligned x, strength and
// bias; else the scalar variant runs. The plan (vector path, grid) is
// computed by the Python wrapper (gan/cuda_kernels.py::style_epilogue_plan);
// this file only checks that it is consistent.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "vec_io.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // vectors a thread loads before it stores

template <typename T>
struct EpilogueArgs {
  T* x;  // [B, H, W, C] contiguous, read and written
  const float* noise;  // [B, H, W] contiguous
  const T* strength;  // [C]
  const T* bias;  // [C]
  long long vectors;  // B*H*W*C / V
  int vpp;  // vectors a pixel: C / V
  float slope;
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) style_epilogue_kernel(const EpilogueArgs<T> a) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i0 = (long long)blockIdx.x * kThreads + threadIdx.x; i0 < a.vectors;
       i0 += stride * kUnroll) {
    float xv[kUnroll][V], nz[kUnroll];
    int c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * stride;
      if (i < a.vectors) {
        const long long p = i / a.vpp;
        c[u] = static_cast<int>(i - p * a.vpp) * V;
        load_vec<T, V>(a.x + i * V, xv[u]);
        nz[u] = a.noise[p];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * stride;
      if (i < a.vectors) {
        float s[V], b[V], r[V];
        load_vec<T, V>(a.strength + c[u], s);
        load_vec<T, V>(a.bias + c[u], b);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float t = fmaf(nz[u], s[v], xv[u][v]) + b[v];
          r[v] = t > 0.f ? t : t * a.slope;
        }
        store_vec<T, V>(a.x + i * V, r);
      }
    }
  }
}

bool plan_ok(long long elems, int C, int width, int grid) {
  return elems > 0 && C > 0 && elems % C == 0 && C % width == 0 && grid > 0;
}

template <typename T>
cudaError_t epilogue(void* x, const void* noise, const void* strength, const void* bias,
                     long long elems, int C, float slope, int vec, int grid,
                     cudaStream_t stream) {
  constexpr int W = 16 / sizeof(T);
  const int width = vec ? W : 1;
  if (!plan_ok(elems, C, width, grid)) return cudaErrorInvalidValue;
  const EpilogueArgs<T> a{static_cast<T*>(x), static_cast<const float*>(noise),
                          static_cast<const T*>(strength), static_cast<const T*>(bias),
                          elems / width, C / width, slope};
  if (vec) style_epilogue_kernel<T, W><<<grid, kThreads, 0, stream>>>(a);
  else style_epilogue_kernel<T, 1><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for x, strength and bias; noise is
// float32. elems = B*H*W*C. vec and grid are the launch plan
// (cuda_kernels.py::style_epilogue_plan). Returns the launch's cudaError_t;
// cudaErrorInvalidValue for a plan this file cannot run.
extern "C" int s2p_style_epilogue(void* x, const void* noise, const void* strength,
                                  const void* bias, long long elems, int C, float slope,
                                  int dtype, int vec, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return epilogue<float>(x, noise, strength, bias, elems, C, slope, vec, grid, s);
  if (dtype == 1)
    return epilogue<__nv_bfloat16>(x, noise, strength, bias, elems, C, slope, vec, grid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
