// RG-LRU scan of Griffin / RecurrentGemma: a diagonal linear recurrence.
//
// Replaces the Pallas kernel `rglru_scan` (`_rglru_kernel`) of the JAX
// package's kernels/rglru.py.  Per lane (b, r), with an f32 carry:
//
//   a_t = exp(log_a_t),   h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) x_t
//
//   x [B, S, R] and log_a [B, S, R] (each f32 | bf16, a unit stride along R,
//   any strides along B and S); h0 [B, R] (f32 | bf16 | f16, a unit stride
//   along R) or null for zeros -> h [B, S, R] and h_last [B, R], contiguous,
//   in x's dtype.  Any S and R: the Pallas kernel's chunk and r_block
//   asserts are TPU tiling artefacts.
//
// Bound on the card: bytes.  At the model's call in recurrentgemma-2b
// prefill ([4, 512, 2560], f32 x and log a) a call reads 42 MB and writes
// 21 MB (h) plus 41 KB (h_last): 18.8 us at 3.35 TB/s.  About 8 operations
// an element are nothing against any peak.
// Design, simple and right first: the Pallas kernel's sequential grid axis
// over chunks becomes a loop over S inside one thread per (b, r) lane, the
// carry in a register.  Neighbouring threads take neighbouring r, so each
// load and store of a warp is one coalesced transaction.  A thread starts
// the loads of kUnroll time steps before it uses the first, so their memory
// latencies overlap; the recurrence itself is two dependent operations a
// step.  At the full shape that is 10,240 threads (160 blocks of 64 on 132
// SMs), too few to keep enough loads in flight to reach the memory rate:
// the kernel is latency-bound.  A chunked two-pass scan (each chunk's
// carry first, then a fix-up) is the way to more parallelism.
// expf/sqrtf, not the fast-math intrinsics; __fmul_rn/__fadd_rn keep the
// plain version's roundings of 1 - a^2 and of the update (no contraction
// to an FMA).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2 };

constexpr int kThreads = 64;  // lanes (r) per block
constexpr int kUnroll = 16;   // time steps whose loads are in flight at once

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float load_h0(const void* h0, int dtype,
                                         long long i) {
  if (dtype == DT_BF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(h0)[i]);
  if (dtype == DT_F16) return __half2float(static_cast<const __half*>(h0)[i]);
  return static_cast<const float*>(h0)[i];
}

__device__ __forceinline__ float step(float h, float la, float x) {
  const float a = expf(la);
  const float bx = __fmul_rn(sqrtf(fmaxf(1.f - __fmul_rn(a, a), 1e-12f)), x);
  return __fadd_rn(__fmul_rn(a, h), bx);
}

template <typename TX, typename TA>
__global__ void __launch_bounds__(kThreads)
rglru_fwd(const TX* __restrict__ x, const TA* __restrict__ la,
          const void* __restrict__ h0, int h0_dtype, long long h0sb,
          TX* __restrict__ h, TX* __restrict__ h_last, int S, int R,
          long long xsb, long long xss, long long asb, long long ass) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (r >= R) return;
  float carry = h0 ? load_h0(h0, h0_dtype, b * h0sb + r) : 0.f;
  const TX* xp = x + b * xsb + r;
  const TA* ap = la + b * asb + r;
  TX* hp = h + static_cast<long long>(b) * S * R + r;

  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float xv[kUnroll], av[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      xv[u] = to_f32(xp[(t + u) * xss]);
      av[u] = to_f32(ap[(t + u) * ass]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      carry = step(carry, av[u], xv[u]);
      store(hp + static_cast<long long>(t + u) * R, carry);
    }
  }
  for (; t < S; ++t) {  // the ragged tail
    carry = step(carry, to_f32(ap[t * ass]), to_f32(xp[t * xss]));
    store(hp + static_cast<long long>(t) * R, carry);
  }
  store(h_last + static_cast<long long>(b) * R + r, carry);
}

template <typename TX, typename TA>
cudaError_t launch(const void* x, const void* la, const void* h0,
                   int h0_dtype, long long h0sb, void* h, void* h_last, int B,
                   int S, int R, long long xsb, long long xss, long long asb,
                   long long ass, cudaStream_t stream) {
  const dim3 grid((R + kThreads - 1) / kThreads, B);
  rglru_fwd<TX, TA><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TA*>(la), h0, h0_dtype,
      h0sb, static_cast<TX*>(h), static_cast<TX*>(h_last), S, R, xsb, xss,
      asb, ass);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Strides are in elements, for the [B, S] index order (R has stride 1).
// x_dtype, la_dtype: 0 f32, 1 bf16; h0_dtype: 0 f32, 1 bf16, 2 f16 (h0 may
// be null).  Returns cudaGetLastError() after the launch;
// cudaErrorInvalidValue for a dtype without an instantiation.
int rglru_scan_fwd(const void* x, const void* la, const void* h0,
                   int h0_dtype, long long h0sb, void* h, void* h_last, int B,
                   int S, int R, long long xsb, long long xss, long long asb,
                   long long ass, int x_dtype, int la_dtype, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || R <= 0) return 0;
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RGLRU_LAUNCH(TX, TA)                                                 \
  err = launch<TX, TA>(x, la, h0, h0_dtype, h0sb, h, h_last, B, S, R, xsb, \
                       xss, asb, ass, s)
  if (x_dtype == DT_F32 && la_dtype == DT_F32) RGLRU_LAUNCH(float, float);
  else if (x_dtype == DT_F32 && la_dtype == DT_BF16)
    RGLRU_LAUNCH(float, __nv_bfloat16);
  else if (x_dtype == DT_BF16 && la_dtype == DT_F32)
    RGLRU_LAUNCH(__nv_bfloat16, float);
  else if (x_dtype == DT_BF16 && la_dtype == DT_BF16)
    RGLRU_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef RGLRU_LAUNCH
  return static_cast<int>(err);
}

const char* rglru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
