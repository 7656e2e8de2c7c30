// Flash attention forward: blocked online softmax, positional masks.
//
// Replaces the Pallas kernel of the JAX package's
// kernels/flash_attention.py: `flash_attention` (`_flash_kernel`).
//
//   q [B, Hq, Sq, dh], k/v [B, Hkv, Skv, dh] (bf16 | f32, any strides with
//   a unit stride along dh) -> o [B, Hq, Sq, dh] in q's dtype.
//   q is pre-scaled by 1/sqrt(dh); running max m and denominator l in f32;
//   masked entries are -1e30 (as in the Pallas body); out = acc / max(l, 1e-30).
//   Masks are positional from 0 on both sides: causal k <= q, window
//   k > q - window.  GQA reads kv head h / (Hq / Hkv); grouped K/V are never
//   materialized.  Any Sq and Skv: the ragged edge is masked here (the
//   Pallas divisibility assert is a TPU tiling artefact).
//
// Bound on the card: at the main path's shape (B=4, H=20, S=512, dh=128,
// causal, bf16) one call needs ~5.4 GFLOP (~5.4 us at 989 TFLOP/s bf16)
// and moves ~21 MB (~6.3 us at 3.35 TB/s), so its bound is the bytes.
// Design, simple and right first: one 256-thread block per (q tile of 64
// rows, head, batch); the Q tile and each 64-key K/V tile are staged in
// shared memory as f32, so every input byte is read from device memory
// once per q tile; both products run on the f32 pipes (not the tensor
// cores) with a 4x4 (QK^T) and 4x(dh/16) (PV) register tile per thread,
// which holds f32 inputs to the 2e-4 contract that TF32 tensor cores
// would break.  kv tiles wholly above the causal diagonal or wholly left
// of the window are skipped; q tiles are scheduled heaviest first.
// mma.sync / wgmma and TMA are the next step for the bf16 path.
// Head dim 256 (recurrentgemma-2b's local attention: 10 q heads, one kv
// head, window 2048) is the same kernel: its tiles take 213,760 B of shared
// memory (the opt-in limit is 232,448 B, one block per SM) and a 4x16 f32
// PV tile per thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum { DT_F32 = 0, DT_BF16 = 1 };

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per kv tile
constexpr int kThreads = 256;  // 16 x 16 threads: ty owns rows, tx columns
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// max / sum across the 16 lanes that share one query row
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Strides {
  long long b, h, s;
};

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (DH + 1) + kBK * (DH + 1) + kBK * DH + kBQ * (kBK + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
          int Sq, int Skv, Strides qs, Strides ks, Strides vs, Strides os,
          float scale, int causal, int window) {
  constexpr int RQ = kBQ / 16;  // rows per thread
  constexpr int CK = kBK / 16;  // key columns per thread
  constexpr int CD = DH / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kBQ][DH + 1]
  float* Ks = Qs + kBQ * (DH + 1);     // [kBK][DH + 1]
  float* Vs = Ks + kBK * (DH + 1);     // [kBK][DH]
  float* Ps = Vs + kBK * DH;           // [kBQ][kBK + 1]

  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int h = blockIdx.y;
  const int bb = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const T* qp = q + bb * qs.b + h * qs.h;
  const T* kp = k + bb * ks.b + hk * ks.h;
  const T* vp = v + bb * vs.b + hk * vs.h;
  T* op = o + bb * os.b + h * os.h;

  for (int e = tid; e < kBQ * DH; e += kThreads) {
    const int r = e / DH, c = e % DH;
    const int qi = q0 + r;
    Qs[r * (DH + 1) + c] = qi < Sq ? to_f32(qp[qi * qs.s + c]) * scale : 0.f;
  }

  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.f;
  }

  int kt_end = (Skv + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, (min(q0 + kBQ, Sq) - 1) / kBK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kBK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBK * DH; e += kThreads) {
      const int r = e / DH, c = e % DH;
      const int ki = k0 + r;
      const bool in = ki < Skv;
      Ks[r * (DH + 1) + c] = in ? to_f32(kp[ki * ks.s + c]) : 0.f;
      Vs[r * DH + c] = in ? to_f32(vp[ki * vs.s + c]) : 0.f;
    }
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DH; ++c) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = Qs[(ty + 16 * i) * (DH + 1) + c];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = Ks[(tx + 16 * j) * (DH + 1) + c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kj = k0 + tx + 16 * j;
        bool keep = true;
        if (causal) keep = keep && kj <= qi;
        if (window > 0) keep = keep && kj > qi - window;
        if (kj >= Skv) s[i][j] = -INFINITY;   // ragged edge: no weight
        else if (!keep) s[i][j] = kMasked;     // the Pallas body's mask
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
        psum += p;
      }
      l[i] = l[i] * alpha + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CD; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = Ps[(ty + 16 * i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < CD; ++j) {
        const float vv = Vs[kk * DH + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < CD; ++j)
      store(op + qi * os.s + tx + 16 * j, __fdiv_rn(acc[i][j], denom));
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Skv, Strides qs, Strides ks,
           Strides vs, Strides os, float scale, int causal, int window,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_fwd<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Skv, qs, ks,
      vs, os, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(int dh, const void* q, const void* k, const void* v, void* o,
                int B, int Hq, int Hkv, int Sq, int Skv, Strides qs,
                Strides ks, Strides vs, Strides os, float scale, int causal,
                int window, cudaStream_t stream) {
  switch (dh) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os,
                           scale, causal, window, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os,
                           scale, causal, window, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os,
                           scale, causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os,
                            scale, causal, window, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os,
                            scale, causal, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Strides are in elements, for the [B, H, S, dh] index order.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a head
// dim without an instantiation: 16, 32, 64, 128 and 256 are built).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int Hq, int Hkv, int Sq, int Skv, int dh,
                        int dtype, long long qsb, long long qsh, long long qss,
                        long long ksb, long long ksh, long long kss,
                        long long vsb, long long vsh, long long vss,
                        long long osb, long long osh, long long oss,
                        float scale, int causal, int window, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || Hq <= 0 || Sq <= 0 || Skv <= 0) return 0;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return dispatch_dh<__nv_bfloat16>(dh, q, k, v, o, B, Hq, Hkv, Sq, Skv, qs,
                                      ks, vs, os, scale, causal, window, s);
  return dispatch_dh<float>(dh, q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs,
                            os, scale, causal, window, s);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
