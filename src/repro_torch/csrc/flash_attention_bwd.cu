// Flash attention backward: dQ, dK and dV from q, k, v, the forward's
// output O, the output's gradient dO and the forward's per-row log-sum-exp.
//
// No Pallas kernel has this job: the JAX package differentiates its jnp
// attention, models/common.py `_attend_block` (under jax.checkpoint) inside
// `chunked_attention`.  This is that gradient, in the algebra of
// kernels/flash_attention.py `attention_bwd_plain`:
//
//   q [B, Hq, Sq, dh], k/v [B, Hkv, Skv, dh], o/dO [B, Hq, Sq, dh] (bf16 |
//   f32, any strides with a unit stride along dh), lse [B, Hq, Sq] f32
//   -> dq, dk, dv in the inputs' dtype, written with the strides given.
//   S = q k^T / sqrt(dh) under the forward's masks (causal k <= q, window
//   k > q - window, positions from 0 on both sides); P = exp(S - lse) where
//   a key is seen, 0 where it is not; D = rowsum(dO * O); dV = P^T dO;
//   dP = dO V^T; dS = P * (dP - D); dQ = dS K / sqrt(dh);
//   dK = dS^T Q / sqrt(dh); dK and dV sum over the Hq / Hkv query heads of
//   each kv head.  A query row without any key (q - window + 1 >= Skv) takes
//   the uniform P = 1 / Skv in the forward (every logit is the mask value):
//   it adds dO / Skv to every row of dV and nothing to dQ or dK, because the
//   mask blocks its logits' gradient; its lse is never read.
//
// Two kernels, launched one after the other on the caller's stream:
// * `flash_bwd_dq`: one 256-thread block per (q tile of 64 rows, q head,
//   batch), heaviest tiles first.  It computes D for its rows and writes it
//   to a scratch row the wrapper allocates, then walks the kv tiles its
//   rows see (the forward's causal and window skipping) and sums dQ in
//   registers, written once.
// * `flash_bwd_dkv`: one block per (kv tile of 64 keys, kv head, batch).
//   It walks the query heads of its GQA group and the q tiles that see its
//   kv tile (from the causal diagonal down to the window's last row, and the
//   tiles holding rows without a key), reads D, and sums dK and dV in
//   registers, written once.
// No float atomics: each output element is one thread's sum in a fixed
// order, so two calls on the same inputs give the same bits.
//
// Bound on the card: at qwen1.5-4b's training call ([2, 20, 512, 128] bf16,
// causal) the function reads q, k, v, O, dO and lse and writes dq, dk, dv
// once, ~42 MB (~0.0125 ms at 3.35 TB/s), against ~6.7 GFLOP of products
// (five of the causal half of [512, 512] x 128 per head; ~0.007 ms on the
// bf16 tensor cores): the bytes bound it.  This version runs every product
// on the f32 pipes, tiled like the forward's SIMT kernel (flash_attention.cu
// `flash_fwd`): the tiles are staged in shared memory as f32 (row pitch
// dh + 1, so a column read by 16 threads hits 16 banks) and each thread
// holds a 4 x 4 tile of S and dP and a 4 x (dh / 16) tile of its outputs,
// so f32 inputs keep the 2e-4 contract.  Its floor is the f32 rate, ~0.1 ms
// for those 6.7 GFLOP at 67 TFLOP/s: the tensor-core version is later work.
// Head dims 16, 32, 64 and 128 are built; at 256 four f32 tiles of 64 rows
// (263 KB) pass the 227 KB a block may hold, and the wrapper refuses it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum { DT_F32 = 0, DT_BF16 = 1 };

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads: ty owns rows, tx columns

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Strides {
  long long b, h, s;
};

// The tensors of one call, in the [B, H, S, dh] index order.
template <typename T>
struct Args {
  const T *q, *k, *v, *o, *dO;
  const float* lse;
  float* D;  // [B, Hq, Sq] scratch: flash_bwd_dq writes it, dkv reads it
  T *dq, *dk, *dv;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int Hq, Hkv, Sq, Skv, causal, window;
  float scale;  // 1 / sqrt(dh)
};

__device__ __forceinline__ bool sees(int qi, int kj, int causal, int window) {
  return (!causal || kj <= qi) && (window <= 0 || kj > qi - window);
}

// Query row qi sees no key at all (then its softmax is uniform).
__device__ __forceinline__ bool no_key(int qi, int Skv, int window) {
  return window > 0 && qi - window + 1 >= Skv;
}

// Rows r0 .. r0 + 63 of a [S, DH] slab with row stride `stride` into a
// [64][DH + 1] f32 tile, times `mul`; rows at or past S are zero.
template <typename T, int DH>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long stride, int r0, int S,
                                      float mul) {
  for (int e = threadIdx.x; e < 64 * DH; e += kThreads) {
    const int r = e / DH, c = e % DH;
    dst[r * (DH + 1) + c] =
        r0 + r < S ? to_f32(src[(r0 + r) * stride + c]) * mul : 0.f;
  }
}

template <int DH>
constexpr size_t dq_smem() {  // Q, dO, K, V tiles; dS; lse and D
  return sizeof(float) *
         (2 * kBQ * (DH + 1) + 2 * kBK * (DH + 1) + kBQ * (kBK + 1) + 2 * kBQ);
}

template <int DH>
constexpr size_t dkv_smem() {  // K, V, Q, dO tiles; P^T and dS^T; lse, D
  return sizeof(float) *
         (2 * kBK * (DH + 1) + 2 * kBQ * (DH + 1) + 2 * kBK * (kBQ + 1) +
          2 * kBQ);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(Args<T> a) {
  constexpr int RQ = kBQ / 16;  // query rows per thread
  constexpr int CK = kBK / 16;  // keys per thread
  constexpr int CD = DH / 16;   // dQ columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                  // [kBQ][DH + 1], q / sqrt(dh)
  float* dOs = Qs + kBQ * (DH + 1);  // [kBQ][DH + 1]
  float* Ks = dOs + kBQ * (DH + 1);  // [kBK][DH + 1]
  float* Vs = Ks + kBK * (DH + 1);   // [kBK][DH + 1]
  float* dSs = Vs + kBK * (DH + 1);  // [kBQ][kBK + 1]
  float* Ls = dSs + kBQ * (kBK + 1); // [kBQ] lse
  float* Ds = Ls + kBQ;              // [kBQ] D

  const int n_qt = (a.Sq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int h = blockIdx.y, bb = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long row0 = (static_cast<long long>(bb) * a.Hq + h) * a.Sq;

  const T* kp = a.k + bb * a.ks.b + hk * a.ks.h;
  const T* vp = a.v + bb * a.vs.b + hk * a.vs.h;
  stage<T, DH>(Qs, a.q + bb * a.qs.b + h * a.qs.h, a.qs.s, q0, a.Sq,
               a.scale);
  stage<T, DH>(dOs, a.dO + bb * a.dos.b + h * a.dos.h, a.dos.s, q0, a.Sq,
               1.f);
  __syncthreads();
  {  // D = rowsum(dO * O): four neighbouring lanes a row, dh / 4 each
    const int r = tid >> 2, part = tid & 3, qi = q0 + r;
    float d = 0.f;
    if (qi < a.Sq) {
      const T* orow = a.o + bb * a.os.b + h * a.os.h + qi * a.os.s;
      for (int c = part; c < DH; c += 4)
        d = fmaf(dOs[r * (DH + 1) + c], to_f32(orow[c]), d);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (part == 0) {
      Ds[r] = d;
      Ls[r] = qi < a.Sq ? a.lse[row0 + qi] : 0.f;
      if (qi < a.Sq) a.D[row0 + qi] = d;
    }
  }

  // kv tiles the block's rows see; a row without a key sees none, and
  // its dQ stays 0
  const int q_last = min(q0 + kBQ, a.Sq) - 1;
  int kt_end = (a.Skv + kBK - 1) / kBK;
  if (a.causal) kt_end = min(kt_end, q_last / kBK + 1);
  const int kt_begin = a.window > 0 ? max(q0 - a.window + 1, 0) / kBK : 0;

  float acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    stage<T, DH>(Ks, kp, a.ks.s, k0, a.Skv, 1.f);
    stage<T, DH>(Vs, vp, a.vs.s, k0, a.Skv, 1.f);
    __syncthreads();

    float s[RQ][CK], dp[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DH; ++c) {
      float qv[RQ], gv[RQ], kv[CK], vv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        qv[i] = Qs[(ty + 16 * i) * (DH + 1) + c];
        gv[i] = dOs[(ty + 16 * i) * (DH + 1) + c];
      }
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        kv[j] = Ks[(tx + 16 * j) * (DH + 1) + c];
        vv[j] = Vs[(tx + 16 * j) * (DH + 1) + c];
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty + 16 * i, qi = q0 + r;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kj = k0 + tx + 16 * j;
        float ds = 0.f;
        if (qi < a.Sq && kj < a.Skv && sees(qi, kj, a.causal, a.window))
          ds = expf(s[i][j] - Ls[r]) * (dp[i][j] - Ds[r]);
        dSs[r * (kBK + 1) + tx + 16 * j] = ds;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float dsv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) dsv[i] = dSs[(ty + 16 * i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < CD; ++j) {
        const float kv = Ks[kk * (DH + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
  }

  T* dqp = a.dq + bb * a.dqs.b + h * a.dqs.h;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= a.Sq) continue;
#pragma unroll
    for (int j = 0; j < CD; ++j)
      store(dqp + qi * a.dqs.s + tx + 16 * j, acc[i][j] * a.scale);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv(Args<T> a) {
  constexpr int RK = kBK / 16;  // keys per thread
  constexpr int CQ = kBQ / 16;  // query rows per thread
  constexpr int CD = DH / 16;   // dK / dV columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;                   // [kBK][DH + 1]
  float* Vs = Ks + kBK * (DH + 1);    // [kBK][DH + 1]
  float* Qs = Vs + kBK * (DH + 1);    // [kBQ][DH + 1], q / sqrt(dh)
  float* dOs = Qs + kBQ * (DH + 1);   // [kBQ][DH + 1]
  float* Pt = dOs + kBQ * (DH + 1);   // [kBK][kBQ + 1], P^T
  float* dSt = Pt + kBK * (kBQ + 1);  // [kBK][kBQ + 1], dS^T
  float* Ls = dSt + kBK * (kBQ + 1);  // [kBQ] lse
  float* Ds = Ls + kBQ;               // [kBQ] D

  const int k0 = blockIdx.x * kBK;    // causal: the heaviest tile first
  const int hk = blockIdx.y, bb = blockIdx.z;
  const int rep = a.Hq / a.Hkv;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  // q tiles that see this kv tile: qt_lo .. qt_hi by the masks (rows from
  // the causal diagonal to the window's reach past the tile's last key),
  // then from qt_nokey on the tiles that hold rows without a key
  const int n_qt = (a.Sq + kBQ - 1) / kBQ;
  const int k_last = min(k0 + kBK, a.Skv) - 1;
  const int qt_lo = a.causal ? k0 / kBQ : 0;
  const long long reach = a.window > 0
                              ? static_cast<long long>(k_last) + a.window - 1
                              : static_cast<long long>(a.Sq) - 1;
  const int qt_hi =
      static_cast<int>(min(reach, static_cast<long long>(a.Sq) - 1) / kBQ);
  const long long first_no_key =
      static_cast<long long>(a.Skv) + a.window - 1;
  const int qt_nokey = a.window > 0 && first_no_key < a.Sq
                           ? static_cast<int>(first_no_key / kBQ)
                           : n_qt;
  const float uniform = __fdiv_rn(1.f, static_cast<float>(a.Skv));

  stage<T, DH>(Ks, a.k + bb * a.ks.b + hk * a.ks.h, a.ks.s, k0, a.Skv, 1.f);
  stage<T, DH>(Vs, a.v + bb * a.vs.b + hk * a.vs.h, a.vs.s, k0, a.Skv, 1.f);

  float dk[RK][CD], dv[RK][CD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    const long long row0 = (static_cast<long long>(bb) * a.Hq + h) * a.Sq;
    const T* qp = a.q + bb * a.qs.b + h * a.qs.h;
    const T* dop = a.dO + bb * a.dos.b + h * a.dos.h;
    for (int qt = qt_lo; qt < n_qt; ++qt) {
      if (qt > qt_hi && qt < qt_nokey) continue;
      const int q0 = qt * kBQ;
      __syncthreads();  // the previous tile's readers are done
      stage<T, DH>(Qs, qp, a.qs.s, q0, a.Sq, a.scale);
      stage<T, DH>(dOs, dop, a.dos.s, q0, a.Sq, 1.f);
      if (tid < kBQ) {
        const bool in = q0 + tid < a.Sq;
        Ls[tid] = in ? a.lse[row0 + q0 + tid] : 0.f;
        Ds[tid] = in ? a.D[row0 + q0 + tid] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T: keys ty + 16 i, query rows tx + 16 j
      float s[RK][CQ], dp[RK][CQ];
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < CQ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < DH; ++c) {
        float kv[RK], vv[RK], qv[CQ], gv[CQ];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          kv[i] = Ks[(ty + 16 * i) * (DH + 1) + c];
          vv[i] = Vs[(ty + 16 * i) * (DH + 1) + c];
        }
#pragma unroll
        for (int j = 0; j < CQ; ++j) {
          qv[j] = Qs[(tx + 16 * j) * (DH + 1) + c];
          gv[j] = dOs[(tx + 16 * j) * (DH + 1) + c];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < CQ; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const int kr = ty + 16 * i, kj = k0 + kr;
#pragma unroll
        for (int j = 0; j < CQ; ++j) {
          const int r = tx + 16 * j, qi = q0 + r;
          float p = 0.f, ds = 0.f;
          if (qi < a.Sq && kj < a.Skv) {
            if (sees(qi, kj, a.causal, a.window)) {
              p = expf(s[i][j] - Ls[r]);
              ds = p * (dp[i][j] - Ds[r]);
            } else if (no_key(qi, a.Skv, a.window)) {
              p = uniform;
            }
          }
          Pt[kr * (kBQ + 1) + r] = p;
          dSt[kr * (kBQ + 1) + r] = ds;
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T (q / sqrt(dh))
#pragma unroll 4
      for (int qq = 0; qq < kBQ; ++qq) {
        float pv[RK], dsv[RK];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pv[i] = Pt[(ty + 16 * i) * (kBQ + 1) + qq];
          dsv[i] = dSt[(ty + 16 * i) * (kBQ + 1) + qq];
        }
#pragma unroll
        for (int j = 0; j < CD; ++j) {
          const float gv = dOs[qq * (DH + 1) + tx + 16 * j];
          const float qv = Qs[qq * (DH + 1) + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < RK; ++i) {
            dv[i][j] = fmaf(pv[i], gv, dv[i][j]);
            dk[i][j] = fmaf(dsv[i], qv, dk[i][j]);
          }
        }
      }
    }
  }

  T* dkp = a.dk + bb * a.dks.b + hk * a.dks.h;
  T* dvp = a.dv + bb * a.dvs.b + hk * a.dvs.h;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= a.Skv) continue;
#pragma unroll
    for (int j = 0; j < CD; ++j) {
      store(dkp + kj * a.dks.s + tx + 16 * j, dk[i][j]);
      store(dvp + kj * a.dvs.s + tx + 16 * j, dv[i][j]);
    }
  }
}

template <typename T, int DH>
int launch(const Args<T>& a, int B, cudaStream_t stream) {
  constexpr size_t smem_dq = dq_smem<DH>(), smem_dkv = dkv_smem<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_dq));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkv<T, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_dkv));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_dq((a.Sq + kBQ - 1) / kBQ, a.Hq, B);
  flash_bwd_dq<T, DH><<<grid_dq, kThreads, smem_dq, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_dkv((a.Skv + kBK - 1) / kBK, a.Hkv, B);
  flash_bwd_dkv<T, DH><<<grid_dkv, kThreads, smem_dkv, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(int dh, const Args<T>& a, int B, cudaStream_t stream) {
  switch (dh) {
    case 16:
      return launch<T, 16>(a, B, stream);
    case 32:
      return launch<T, 32>(a, B, stream);
    case 64:
      return launch<T, 64>(a, B, stream);
    case 128:
      return launch<T, 128>(a, B, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* o,
        const void* dO, const float* lse, float* D, void* dq, void* dk,
        void* dv, int B, int Hq, int Hkv, int Sq, int Skv, int dh,
        const long long* st, float scale, int causal, int window,
        cudaStream_t stream) {
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.o = static_cast<const T*>(o);
  a.dO = static_cast<const T*>(dO);
  a.lse = lse;
  a.D = D;
  a.dq = static_cast<T*>(dq);
  a.dk = static_cast<T*>(dk);
  a.dv = static_cast<T*>(dv);
  Strides* all[8] = {&a.qs, &a.ks, &a.vs, &a.os, &a.dos, &a.dqs, &a.dks,
                     &a.dvs};
  for (int t = 0; t < 8; ++t) *all[t] = {st[3 * t], st[3 * t + 1],
                                         st[3 * t + 2]};
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Skv = Skv;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  return dispatch_dh<T>(dh, a, B, stream);
}

}  // namespace

extern "C" {

// strides: 24 element strides, the batch, head and sequence strides of q,
// k, v, o, dO, dq, dk and dv in that order (the [B, H, S, dh] index order;
// the stride along dh is 1).  D: [B, Hq, Sq] f32 scratch.  Launches
// flash_bwd_dq, then flash_bwd_dkv, on `stream`; returns
// cudaGetLastError() (cudaErrorInvalidValue for a head dim without an
// instantiation: 16, 32, 64 and 128 are built).
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dO, const float* lse,
                        float* D, void* dq, void* dk, void* dv, int B, int Hq,
                        int Hkv, int Sq, int Skv, int dh, int dtype,
                        const long long* strides, float scale, int causal,
                        int window, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Sq <= 0 || Skv <= 0) return 0;
  if (Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return run<__nv_bfloat16>(q, k, v, o, dO, lse, D, dq, dk, dv, B, Hq, Hkv,
                              Sq, Skv, dh, strides, scale, causal, window, s);
  if (dtype == DT_F32)
    return run<float>(q, k, v, o, dO, lse, D, dq, dk, dv, B, Hq, Hkv, Sq, Skv,
                      dh, strides, scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
