// Grouped expert matmul of a mixture-of-experts layer.
//
// Replaces the Pallas kernel `moe_gmm` (`_gmm_kernel`) of the JAX package's
// kernels/moe_gmm.py.  For every expert e:
//
//   out[e] = h[e] @ w[e],   h [E, C, D], w [E, D, F] -> out [E, C, F]
//
// h and w share one dtype (f32 | bf16); the sum over D is carried in f32 and
// rounded once to that dtype on the store, as the Pallas kernel's f32 VMEM
// accumulator is.  h and w take any strides along E and C (h) or E and D (w)
// with a unit stride on the last axis; out is contiguous.  Any E, C, D and F:
// every tile is bounds-checked (the Pallas kernel asserts multiples of its
// 128 / 128 / 512 blocks, a TPU tiling artefact).
//
// Bound on the card.  granite-moe-3b-a800m prefill (B 4 x S 512 tokens, top
// 8 of 40 experts, capacity 512): [40, 512, 1536] @ [40, 1536, 512] in bf16
// moves 146.8 MB (43.8 us at 3.35 TB/s) for 32.2 GFLOP (32.6 us on the bf16
// tensor cores): bytes, narrowly.  A decode step (capacity 8) reads every
// expert's weights, 64.2 MB for 0.25 GFLOP: bytes (19.2 us).
// Design, simple and right first: one block of 256 threads per (F tile,
// C tile, expert), 64 x 64 outputs, each thread a 4 x 4 register tile of
// f32 sums on the FMA pipes.  The loop over D stages a 64 x 16 tile of h
// (transposed, so a thread reads its 4 rows as one float4) and a 16 x 64
// tile of w in shared memory, widening bf16 to f32 on the load; zero fill
// past every edge.  On the f32 pipes it cannot reach the bf16 bound: the
// tensor cores (mma.sync, then wgmma fed by TMA) are the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { DT_F32 = 0, DT_BF16 = 1 };

constexpr int kBM = 64;       // rows of C per block
constexpr int kBN = 64;       // columns of F per block
constexpr int kBK = 16;       // step along D
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPad = 4;       // keeps the transposed h tile's rows 16-byte aligned

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gmm_fwd(const T* __restrict__ h, const T* __restrict__ w, T* __restrict__ out,
        int C, int D, int F, long long hse, long long hsc, long long wse,
        long long wsd) {
  __shared__ __align__(16) float hs[kBK][kBM + kPad];  // hs[k][m] = h[m][k]
  __shared__ __align__(16) float ws[kBK][kBN];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* hb = h + e * hse;
  const T* wb = w + e * wse;
  // loaders: h tile 64 rows x 16 (4 consecutive k a thread), w tile 16 rows
  // x 64 (4 consecutive n a thread)
  const int hm = tid / 4, hk = (tid % 4) * 4;
  const int wk = tid / 16, wn = (tid % 16) * 4;
  const bool h_row = m0 + hm < C;
  const T* hrow = hb + static_cast<long long>(m0 + hm) * hsc;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += kBK) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int gk = k0 + hk + u;
      hs[hk + u][hm] = (h_row && gk < D) ? to_f32(hrow[gk]) : 0.f;
    }
    const int gk = k0 + wk;
    const T* wrow = wb + static_cast<long long>(gk) * wsd;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int gn = n0 + wn + u;
      ws[wk][wn + u] = (gk < D && gn < F) ? to_f32(wrow[gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&hs[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  T* ob = out + static_cast<long long>(e) * C * F;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < F) store(ob + static_cast<long long>(row) * F + col,
                         acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* h, const void* w, void* out, int E, int C,
                   int D, int F, long long hse, long long hsc, long long wse,
                   long long wsd, cudaStream_t stream) {
  const dim3 grid((F + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
  gmm_fwd<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), static_cast<T*>(out),
      C, D, F, hse, hsc, wse, wsd);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Strides are in elements: hse, hsc of h along E and C; wse, wsd of w along
// E and D (the last axes have stride 1).  dtype: 0 f32, 1 bf16 (h, w and
// out alike).  Returns cudaGetLastError() after the launch;
// cudaErrorInvalidValue for a dtype without an instantiation or a grid the
// card cannot launch.
int moe_gmm_fwd(const void* h, const void* w, void* out, int E, int C, int D,
                int F, long long hse, long long hsc, long long wse,
                long long wsd, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (E <= 0 || C <= 0 || F <= 0) return 0;
  if (E > 65535 || (C + kBM - 1) / kBM > 65535 || D < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    err = launch<float>(h, w, out, E, C, D, F, hse, hsc, wse, wsd, s);
  else if (dtype == DT_BF16)
    err = launch<__nv_bfloat16>(h, w, out, E, C, D, F, hse, hsc, wse, wsd, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}

const char* moe_gmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
