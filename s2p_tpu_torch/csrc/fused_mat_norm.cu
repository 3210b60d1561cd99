// Fused MAT norm for Hopper (sm_90a): instance-norm statistics plus the
// MAT modulation, out = (x - mean) * rsqrt(var + eps) * (1 + gamma) + beta.
//
// Replaces s2p_tpu/gan/pallas_kernels.py::fused_mat_norm (the TPU kernel,
// pl.pallas_call at l.78). It computes that module's _plain (l.41-45):
// mean and population variance over H*W per (image, channel), in f32,
// with the result cast back to x's type.
//
// Layout. x and out are NHWC and contiguous, so channels are the unit-stride
// axis. gamma and beta share x's shape and keep a unit channel stride, but
// take their own batch and pixel strides: on the fast path they are the two
// channel halves of one gamma||beta conv output (pixel stride 2C), read in
// place with no copy.
//
// Grid. One block per (image, tile of 32 channels). threadIdx.x walks the
// channels of the tile, so each warp row reads 32 consecutive channels of
// one pixel (coalesced); threadIdx.y strides over the H*W pixels. Ragged
// channel tiles (C not a multiple of 32) and pixel counts that do not divide
// by the block's rows are masked.
//
// Statistics. Two passes in f32: the mean first, then the centred sum of
// squares, so the variance stays exact when |mean| >> std, where
// E[x^2] - mean^2 (the Pallas body, l.68) cancels. The first pass sums
// x - x[pixel 0] (a shift near the mean) so that the sum of a large mean
// keeps its low bits. Each thread sums its pixels; the block adds its rows
// in shared memory. A third sweep normalises, modulates and stores.
//
// Bound. The kernel must read x, gamma and beta once and write out once:
// 4 * B*H*W*C elements. It does ~10 flops per element, far below the
// card's ~295 flops per byte, so it is bound by bytes: at 3.35 TB/s the 13
// norms of one 64px/ngf=64 generator step (1,114,112 elements per frame) at
// batch 256 in bf16 need >= 0.68 ms. This design reads x three times (two
// statistics passes, then the normalising sweep): the re-reads hit L2 for
// small images and cost device-memory bandwidth for large ones.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kTileC = 32;  // channels per block (threadIdx.x)
constexpr int kRows = 16;   // pixel rows per block (threadIdx.y)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kTileC * kRows)
fused_mat_norm_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                      const T* __restrict__ beta, T* __restrict__ out,
                      int hw, int C, int c_tiles,
                      long long g_bstride, long long g_pstride,
                      long long b_bstride, long long b_pstride, float eps) {
  __shared__ float s_part[kRows][kTileC];
  __shared__ float s_stat[2][kTileC];

  const int b = blockIdx.x / c_tiles;
  const int c = (blockIdx.x % c_tiles) * kTileC + threadIdx.x;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const bool active = c < C;

  const long long x_base = (long long)b * hw * C + c;

  // pass 1: mean, from sums shifted by the channel's first pixel
  const float shift = active ? to_f32(x[x_base]) : 0.f;
  float acc = 0.f;
  if (active) {
    for (int p = ty; p < hw; p += kRows) acc += to_f32(x[x_base + (long long)p * C]) - shift;
  }
  s_part[ty][tx] = acc;
  __syncthreads();
  if (ty == 0) {
    float tot = 0.f;
    for (int r = 0; r < kRows; ++r) tot += s_part[r][tx];
    s_stat[0][tx] = shift + tot / (float)hw;
  }
  __syncthreads();
  const float mu = s_stat[0][tx];

  // pass 2: population variance from the centred sum of squares
  acc = 0.f;
  if (active) {
    for (int p = ty; p < hw; p += kRows) {
      const float d = to_f32(x[x_base + (long long)p * C]) - mu;
      acc += d * d;
    }
  }
  s_part[ty][tx] = acc;
  __syncthreads();
  if (ty == 0) {
    float tot = 0.f;
    for (int r = 0; r < kRows; ++r) tot += s_part[r][tx];
    s_stat[1][tx] = rsqrtf(tot / (float)hw + eps);
  }
  __syncthreads();
  if (!active) return;

  // pass 3: normalise, modulate, store
  const float rstd = s_stat[1][tx];
  const T* g = gamma + (long long)b * g_bstride + c;
  const T* be = beta + (long long)b * b_bstride + c;
  for (int p = ty; p < hw; p += kRows) {
    const long long xi = x_base + (long long)p * C;
    const float gv = to_f32(g[(long long)p * g_pstride]);
    const float bv = to_f32(be[(long long)p * b_pstride]);
    const float v = (to_f32(x[xi]) - mu) * rstd * (1.f + gv) + bv;
    from_f32(v, out + xi);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* beta, void* out,
                   int batch, int hw, int C, long long g_bstride, long long g_pstride,
                   long long b_bstride, long long b_pstride, float eps,
                   cudaStream_t stream) {
  const int c_tiles = (C + kTileC - 1) / kTileC;
  const dim3 block(kTileC, kRows);
  const dim3 grid((unsigned)batch * (unsigned)c_tiles);
  fused_mat_norm_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<T*>(out), hw, C, c_tiles,
      g_bstride, g_pstride, b_bstride, b_pstride, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int s2p_fused_mat_norm(const void* x, const void* gamma, const void* beta,
                                  void* out, int batch, int hw, int C,
                                  long long g_bstride, long long g_pstride,
                                  long long b_bstride, long long b_pstride, int dtype,
                                  float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, gamma, beta, out, batch, hw, C, g_bstride, g_pstride,
                         b_bstride, b_pstride, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, gamma, beta, out, batch, hw, C, g_bstride,
                                 g_pstride, b_bstride, b_pstride, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
