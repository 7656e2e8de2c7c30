// Wire codec for the cut-activation hop: per-block absmax quantization.
//
// Replaces the Pallas kernels of the JAX package's kernels/wire_codec.py:
// `encode_fused` (`_encode_kernel`) and `decode_fused` (`_decode_kernel`).
//
//   encode: x [rows, d] (bf16 | f32) -> q [rows, d/b, b] (int8 | fp8-e4m3),
//           scale [rows, d/b] f32, with b = wire_block(d) (largest divisor
//           of d <= 256), per block in f32:
//             amax  = max |x|
//             scale = max(amax / qmax, 1e-12)        qmax = 127 | 448
//             q     = clip(round_half_even(x / scale), -127, 127)  (int8)
//                   | e4m3(x / scale), round to nearest even, saturating
//   decode: out = (f32(q) * scale) cast to bf16 | f32 (round to nearest even)
//
// Contract: bit-identical to the plain PyTorch version
// (repro_torch/training/compress.py), which is bit-identical to the
// reference's host codec for int8.  Hence a correctly rounded division
// (__fdiv_rn, never a multiply by a reciprocal), rintf (half to even) and
// no fast-math flags.
//
// Bound on the card: memory.  Encode moves rows*d*(in_bytes + 1) +
// rows*(d/b)*4 bytes and does a handful of f32 operations per element, far
// below the ~20 operations per byte where H100's f32 pipes would take over.
// Design: one warp per block of b elements, so the block's absmax is a
// register reduction over __shfl_xor_sync and every element is read from
// device memory once.  At b = 256 (the main path: d = 2560) each lane owns
// 8 consecutive elements, loaded with 16-byte loads and stored as one
// 8-byte store; any other b (96, 200, a prime below 256) takes a masked,
// lane-strided loop that reads the block twice (the second read hits L1).
//
// Decode moves rows*d*(1 + out_bytes) + rows*(d/b)*4 bytes and does one
// product an element: bound by memory too.  Design, the mirror of encode:
// one warp per block of b elements, so the block's scale is one load a
// warp (the same address in every lane: one transaction, broadcast) and no
// thread divides an element index by b.  At b = 256 with the payload
// 8-byte and the output 16-byte aligned (route "warp256", the main path),
// each lane owns 8 consecutive payload bytes: one 8-byte load, 8 products,
// and one 16-byte store (bf16) or two (f32); fp8 converts in pairs
// (cvt.rn.f16x2.e4m3x2: e4m3 -> half -> float is exact).  Any other b, or
// a payload or output off those alignments, takes route "strided": the
// same warp per block, lanes striding over its elements.  kernels/
// wire_codec.py decode_route names the route before the launch.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { DT_F32 = 0, DT_BF16 = 1 };
enum { WIRE_INT8 = 0, WIRE_FP8 = 1 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int WIRE>
__device__ __forceinline__ uint8_t quantize(float x, float scale) {
  float v = __fdiv_rn(x, scale);
  if (WIRE == WIRE_INT8) {
    v = fminf(fmaxf(rintf(v), -127.f), 127.f);
    return static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(v)));
  } else {
    return static_cast<uint8_t>(
        __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3));
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float block_scale(float amax, float qmax) {
  return fmaxf(__fdiv_rn(amax, qmax), 1e-12f);
}

// Any block size: lane-strided loop over the block's b elements.
template <typename T, int WIRE>
__global__ void __launch_bounds__(kThreads)
encode_strided(const T* __restrict__ x, uint8_t* __restrict__ q,
               float* __restrict__ scale, int64_t nblocks, int b,
               float qmax) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (w >= nblocks) return;  // warp-uniform
  const T* xb = x + w * b;
  uint8_t* qb = q + w * b;
  float amax = 0.f;
  for (int i = lane; i < b; i += 32) amax = fmaxf(amax, fabsf(to_f32(xb[i])));
  const float s = block_scale(warp_max(amax), qmax);
  for (int i = lane; i < b; i += 32) qb[i] = quantize<WIRE>(to_f32(xb[i]), s);
  if (lane == 0) scale[w] = s;
}

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 c = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// b == 256 with 16-byte aligned rows: lane owns elements [8*lane, 8*lane+8).
template <typename T, int WIRE>
__global__ void __launch_bounds__(kThreads)
encode_256(const T* __restrict__ x, uint8_t* __restrict__ q,
           float* __restrict__ scale, int64_t nblocks, float qmax) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (w >= nblocks) return;  // warp-uniform
  float v[8];
  load8(x + w * 256 + lane * 8, v);
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
  const float s = block_scale(warp_max(amax), qmax);
  uint8_t out[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = quantize<WIRE>(v[j], s);
  uint2 packed;
  packed.x = out[0] | (out[1] << 8) | (out[2] << 16) | (uint32_t(out[3]) << 24);
  packed.y = out[4] | (out[5] << 8) | (out[6] << 16) | (uint32_t(out[7]) << 24);
  *reinterpret_cast<uint2*>(q + w * 256 + lane * 8) = packed;
  if (lane == 0) scale[w] = s;
}

template <int WIRE>
__device__ __forceinline__ float dequant(uint8_t v) {
  if (WIRE == WIRE_INT8) return static_cast<float>(static_cast<int8_t>(v));
  __half_raw h = __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(v),
                                         __NV_E4M3);
  return __half2float(__half(h));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 8 payload bytes (little-endian in p) -> their exact values
template <int WIRE>
__device__ __forceinline__ void dequant8(uint2 p, float v[8]) {
  const uint32_t w[2] = {p.x, p.y};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (WIRE == WIRE_INT8) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[4 * k + j] = static_cast<float>(
            static_cast<int8_t>(static_cast<uint8_t>(w[k] >> (8 * j))));
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const __half2 hh = __half2(__nv_cvt_fp8x2_to_halfraw2(
            static_cast<__nv_fp8x2_storage_t>(w[k] >> (16 * j)), __NV_E4M3));
        const float2 f = __half22float2(hh);
        v[4 * k + 2 * j] = f.x;
        v[4 * k + 2 * j + 1] = f.y;
      }
    }
  }
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(bf16x2_bits(v[0], v[1]), bf16x2_bits(v[2], v[3]),
                 bf16x2_bits(v[4], v[5]), bf16x2_bits(v[6], v[7]));
}

// b == 256, q 8-byte and out 16-byte aligned: lane owns elements
// [8*lane, 8*lane+8) of its warp's block.
template <typename T, int WIRE>
__global__ void __launch_bounds__(kThreads)
decode_256(const uint8_t* __restrict__ q, const float* __restrict__ scale,
           T* __restrict__ out, int64_t nblocks) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (w >= nblocks) return;  // warp-uniform
  const uint2 p = *reinterpret_cast<const uint2*>(q + w * 256 + lane * 8);
  const float s = scale[w];
  float v[8];
  dequant8<WIRE>(p, v);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __fmul_rn(v[j], s);
  store8(out + w * 256 + lane * 8, v);
}

// Any block size and alignment: lane-strided loop over the block.
template <typename T, int WIRE>
__global__ void __launch_bounds__(kThreads)
decode_strided(const uint8_t* __restrict__ q, const float* __restrict__ scale,
               T* __restrict__ out, int64_t nblocks, int b) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (w >= nblocks) return;  // warp-uniform
  const float s = scale[w];
  const uint8_t* qb = q + w * b;
  T* ob = out + w * b;
  for (int i = lane; i < b; i += 32)
    store(ob + i, __fmul_rn(dequant<WIRE>(qb[i]), s));
}

template <typename T, int WIRE>
void launch_encode(const void* x, void* q, void* scale, int64_t nblocks,
                   int b, float qmax, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((nblocks + kWarps - 1) / kWarps);
  const bool vec = b == 256 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 8 == 0;
  if (vec) {
    encode_256<T, WIRE><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<uint8_t*>(q),
        static_cast<float*>(scale), nblocks, qmax);
  } else {
    encode_strided<T, WIRE><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<uint8_t*>(q),
        static_cast<float*>(scale), nblocks, b, qmax);
  }
}

template <typename T, int WIRE>
void launch_decode(const void* q, const void* scale, void* out, int64_t n,
                   int b, cudaStream_t stream) {
  const int64_t nblocks = n / b;
  const unsigned grid = static_cast<unsigned>((nblocks + kWarps - 1) / kWarps);
  const bool vec = b == 256 && reinterpret_cast<uintptr_t>(q) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    decode_256<T, WIRE><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint8_t*>(q), static_cast<const float*>(scale),
        static_cast<T*>(out), nblocks);
  } else {
    decode_strided<T, WIRE><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint8_t*>(q), static_cast<const float*>(scale),
        static_cast<T*>(out), nblocks, b);
  }
}

}  // namespace

extern "C" {

// x: [nblocks * b] contiguous (dtype DT_*); q: [nblocks * b] bytes;
// scale: [nblocks] f32.  Returns cudaGetLastError() after the launch.
int wire_encode(const void* x, void* q, void* scale, long long nblocks, int b,
                int x_dtype, int wire, float qmax, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nblocks <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == DT_BF16) {
    if (wire == WIRE_INT8)
      launch_encode<__nv_bfloat16, WIRE_INT8>(x, q, scale, nblocks, b, qmax, s);
    else
      launch_encode<__nv_bfloat16, WIRE_FP8>(x, q, scale, nblocks, b, qmax, s);
  } else {
    if (wire == WIRE_INT8)
      launch_encode<float, WIRE_INT8>(x, q, scale, nblocks, b, qmax, s);
    else
      launch_encode<float, WIRE_FP8>(x, q, scale, nblocks, b, qmax, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// q: [n] bytes; scale: [n / b] f32; out: [n] (dtype DT_*); b divides n.
int wire_decode(const void* q, const void* scale, void* out, long long n,
                int b, int wire, int out_dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  if (b <= 0 || n % b != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == DT_BF16) {
    if (wire == WIRE_INT8)
      launch_decode<__nv_bfloat16, WIRE_INT8>(q, scale, out, n, b, s);
    else
      launch_decode<__nv_bfloat16, WIRE_FP8>(q, scale, out, n, b, s);
  } else {
    if (wire == WIRE_INT8)
      launch_decode<float, WIRE_INT8>(q, scale, out, n, b, s);
    else
      launch_decode<float, WIRE_FP8>(q, scale, out, n, b, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* wire_codec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
