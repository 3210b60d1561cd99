// Fused MAT norm for Hopper (sm_90a): instance-norm statistics plus the
// MAT modulation, out = (x - mean) * rsqrt(var + eps) * (1 + gamma) + beta,
// and its backward.
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
// When the caller records a gradient, the forward also writes the f32
// per-(image, channel) mean and rstd, [B, C], for the backward; on the
// inference path those pointers are null and nothing more is written.
//
// Bound. The kernel must read x, gamma and beta once and write out once:
// 4 * B*H*W*C elements. It does ~10 flops per element, far below the
// card's ~295 flops per byte, so it is bound by bytes: at 3.35 TB/s the 13
// norms of one 64px/ngf=64 generator step (sum of H*W*C: 1,114,112 per
// frame; the bound counts four times that) at batch 256 in bf16 need
// >= 0.68 ms. This design reads x three times (two statistics passes, then
// the normalising sweep): the re-reads hit L2 for small images and cost
// device-memory bandwidth for large ones.
//
// Backward. The JAX package has no backward kernel (XLA differentiates the
// plain norm there); the port's MAT norm on the card is this kernel, so its
// gradient is one too. With xhat = (x - mean) * rstd and g = dy * (1 + gamma):
//   dbeta  = dy                     (no kernel: the wrapper returns dy)
//   dgamma = dy * xhat
//   dx     = rstd * (g - mean_HW(g) - xhat * mean_HW(g * xhat))
// Same grid as the forward. Pass 1 sums g and g*xhat over H*W in f32 (each
// thread its pixels, the block's rows in shared memory); pass 2 writes dx
// and dgamma. Its bound: one read of dy, x and gamma and one write of dx
// and dgamma, 5 * B*H*W*C elements, again bound by bytes: the 13 norms of a
// 100px/ngf=64 generator step (2,746,496 elements per frame) at batch 16
// need >= 0.131 ms in bf16 and >= 0.262 ms in f32. It reads dy, x and gamma
// twice.

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
                      float* __restrict__ mean_out, float* __restrict__ rstd_out,
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
    if (mean_out != nullptr && active) {  // saved for the backward
      mean_out[(long long)b * C + c] = s_stat[0][tx];
      rstd_out[(long long)b * C + c] = s_stat[1][tx];
    }
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
__global__ void __launch_bounds__(kTileC * kRows)
fused_mat_norm_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                          const T* __restrict__ gamma, const float* __restrict__ mean,
                          const float* __restrict__ rstd, T* __restrict__ dx,
                          T* __restrict__ dgamma, int hw, int C, int c_tiles,
                          long long g_bstride, long long g_pstride) {
  __shared__ float s_part[2][kRows][kTileC];
  __shared__ float s_stat[2][kTileC];

  const int b = blockIdx.x / c_tiles;
  const int c = (blockIdx.x % c_tiles) * kTileC + threadIdx.x;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const bool active = c < C;

  const long long x_base = (long long)b * hw * C + c;
  const T* g = gamma + (long long)b * g_bstride + c;
  const float mu = active ? mean[(long long)b * C + c] : 0.f;
  const float rs = active ? rstd[(long long)b * C + c] : 0.f;

  // pass 1: sums of g and g * xhat over H*W
  float sg = 0.f, sgx = 0.f;
  if (active) {
    for (int p = ty; p < hw; p += kRows) {
      const long long xi = x_base + (long long)p * C;
      const float gv = to_f32(dy[xi]) * (1.f + to_f32(g[(long long)p * g_pstride]));
      sg += gv;
      sgx += gv * ((to_f32(x[xi]) - mu) * rs);
    }
  }
  s_part[0][ty][tx] = sg;
  s_part[1][ty][tx] = sgx;
  __syncthreads();
  if (ty == 0) {
    float t0 = 0.f, t1 = 0.f;
    for (int r = 0; r < kRows; ++r) {
      t0 += s_part[0][r][tx];
      t1 += s_part[1][r][tx];
    }
    s_stat[0][tx] = t0 / (float)hw;
    s_stat[1][tx] = t1 / (float)hw;
  }
  __syncthreads();
  if (!active) return;

  // pass 2: dx and dgamma
  const float mg = s_stat[0][tx], mgx = s_stat[1][tx];
  for (int p = ty; p < hw; p += kRows) {
    const long long xi = x_base + (long long)p * C;
    const float dyv = to_f32(dy[xi]);
    const float gv = dyv * (1.f + to_f32(g[(long long)p * g_pstride]));
    const float xh = (to_f32(x[xi]) - mu) * rs;
    from_f32(rs * (gv - mg - xh * mgx), dx + xi);
    from_f32(dyv * xh, dgamma + xi);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* beta, void* out,
                   void* mean, void* rstd, int batch, int hw, int C,
                   long long g_bstride, long long g_pstride, long long b_bstride,
                   long long b_pstride, float eps, cudaStream_t stream) {
  const int c_tiles = (C + kTileC - 1) / kTileC;
  const dim3 block(kTileC, kRows);
  const dim3 grid((unsigned)batch * (unsigned)c_tiles);
  fused_mat_norm_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<T*>(out), static_cast<float*>(mean),
      static_cast<float*>(rstd), hw, C, c_tiles, g_bstride, g_pstride, b_bstride,
      b_pstride, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* dy, const void* x, const void* gamma, const void* mean,
                       const void* rstd, void* dx, void* dgamma, int batch, int hw, int C,
                       long long g_bstride, long long g_pstride, cudaStream_t stream) {
  const int c_tiles = (C + kTileC - 1) / kTileC;
  const dim3 block(kTileC, kRows);
  const dim3 grid((unsigned)batch * (unsigned)c_tiles);
  fused_mat_norm_bwd_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<T*>(dx), static_cast<T*>(dgamma), hw, C, c_tiles, g_bstride, g_pstride);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mean and rstd (f32 [B, C]) may both be
// null. Returns the launch's cudaError_t.
extern "C" int s2p_fused_mat_norm(const void* x, const void* gamma, const void* beta,
                                  void* out, void* mean, void* rstd, int batch, int hw,
                                  int C, long long g_bstride, long long g_pstride,
                                  long long b_bstride, long long b_pstride, int dtype,
                                  float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, gamma, beta, out, mean, rstd, batch, hw, C, g_bstride,
                         g_pstride, b_bstride, b_pstride, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, gamma, beta, out, mean, rstd, batch, hw, C,
                                 g_bstride, g_pstride, b_bstride, b_pstride, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dy, x, dx and dgamma are contiguous NHWC of one dtype (0 = float32,
// 1 = bfloat16); gamma has unit channel stride and the given batch and pixel
// strides; mean and rstd are the forward's f32 [B, C]. Returns the launch's
// cudaError_t.
extern "C" int s2p_fused_mat_norm_bwd(const void* dy, const void* x, const void* gamma,
                                      const void* mean, const void* rstd, void* dx,
                                      void* dgamma, int batch, int hw, int C,
                                      long long g_bstride, long long g_pstride, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(dy, x, gamma, mean, rstd, dx, dgamma, batch, hw, C,
                             g_bstride, g_pstride, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(dy, x, gamma, mean, rstd, dx, dgamma, batch, hw, C,
                                     g_bstride, g_pstride, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
