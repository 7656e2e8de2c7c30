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
//   S = q k^T / sqrt(dh) under the forward's masks (causal k <= q or
//   k < prefix, the prefix-LM's bidirectional prefix; window k > q - window
//   on top; positions from 0 on both sides); P = exp(S - lse) where
//   a key is seen, 0 where it is not; D = rowsum(dO * O); dV = P^T dO;
//   dP = dO V^T; dS = P * (dP - D); dQ = dS K / sqrt(dh);
//   dK = dS^T Q / sqrt(dh); dK and dV sum over the Hq / Hkv query heads of
//   each kv head.  A query row without any key (q - window + 1 >= Skv) takes
//   the uniform P = 1 / Skv in the forward (every logit is the mask value):
//   it adds dO / Skv to every row of dV and nothing to dQ or dK, because the
//   mask blocks its logits' gradient; its lse is never read.
//
// Two kernels, launched one after the other on the caller's stream (the
// SIMT route's names; the mma route's end in `_mma`):
// * `flash_bwd_dq`: one block per (q tile of 64 rows, q head, batch),
//   heaviest tiles first.  It computes D for its rows and writes it to a
//   scratch row the wrapper allocates, then walks the kv tiles its rows see
//   (the forward's causal, prefix and window skipping) and sums dQ in
//   registers, written once.
// * `flash_bwd_dkv`: one block per (kv tile of 64 keys, kv head, batch).
//   It walks the query heads of its GQA group and the q tiles that see its
//   kv tile (from the causal diagonal, or from the first row for a tile
//   that holds a prefix key, down to the window's last row, and the tiles
//   holding rows without a key), reads D, and sums dK and dV in registers,
//   written once.
// No float atomics: each output element is one thread's sum in a fixed
// order, so two calls on the same inputs give the same bits.
//
// Bound on the card: at qwen1.5-4b's training call ([2, 20, 512, 128] bf16,
// causal) the function reads q, k, v, O, dO and lse and writes dq, dk, dv
// once, ~42 MB (~0.0125 ms at 3.35 TB/s), against ~6.7 GFLOP of products
// (five of the causal half of [512, 512] x 128 per head; ~0.007 ms on the
// bf16 tensor cores): the bytes bound it.
//
// Two routes, chosen by the caller before the launch (kernels/
// flash_attention.py `bwd_route`), never by a failure:
// * "mma" (bf16 at head dims 64, 128 and 256 whose eight tensors have
//   16-byte aligned bases and strides): `bwd_mma::flash_bwd_dq_mma` and
//   `bwd_mma::flash_bwd_dkv_mma` at 64 and 128, `bwd256::
//   flash_bwd_dq_mma256` and `bwd256::flash_bwd_dkv_mma256` (and
//   `bwd256::sum_groups`) at 256, every product on the bf16 tensor cores
//   with the tiles streamed by cp.async (their own comments below).
// * "simt" (f32, bf16 that cp.async cannot load 16 bytes at a time, and
//   head dims 16 and 32): `flash_bwd_dq` and `flash_bwd_dkv`, every product
//   on the f32 pipes, tiled like the forward's SIMT kernel (flash_attention.cu
//   `flash_fwd`): the tiles are staged in shared memory as f32 (row pitch
//   dh + 1, so a column read by 16 threads hits 16 banks) and each thread
//   holds a 4 x 4 tile of S and dP and a 4 x (dh / 16) tile of its outputs,
//   so f32 inputs keep the 2e-4 contract.  Its tiles are 64 rows, and 32
//   at head dim 256 (`bwd_tile`), where four f32 tiles of 64 rows (263 KB)
//   would pass the 227 KB a block may hold.
// Bound at recurrentgemma-2b's local attention ([2, 10, 4096, 256] on one
// kv head, causal, window 2048): five products of 2 x 256 operations for
// each of the 125.8 M (q, k) pairs inside the window, 322 GFLOP (0.326 ms
// at the bf16 tensor-core rate), against 0.18 GB of tensors: operations.
// The mma route does ten products where that bound counts five (P and dS
// enter theirs twice, as high and low parts).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_ptx.cuh"

namespace {

enum { DT_F32 = 0, DT_BF16 = 1 };

constexpr int kThreads = 256;  // 16 x 16 threads: ty owns rows, tx columns

// Query rows and keys of a SIMT tile: 64, and 32 at head dim 256, where
// the four f32 tiles of 64 rows (263 KB) would not fit the 227 KB a block
// may hold (32 rows: 136 KB and 140 KB).
__host__ __device__ constexpr int bwd_tile(int dh) { return dh > 128 ? 32 : 64; }

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
  int Hq, Hkv, Sq, Skv, causal, window, prefix;
  float scale;  // 1 / sqrt(dh)
};

__device__ __forceinline__ bool sees(int qi, int kj, int causal, int window,
                                     int prefix) {
  return (!causal || kj <= qi || kj < prefix) &&
         (window <= 0 || kj > qi - window);
}

// The last key a block of query rows .. q_last sees under a causal mask:
// q_last, or the prefix's last key where the prefix reaches past it.
__device__ __forceinline__ int causal_last(int q_last, int prefix) {
  return max(q_last, prefix - 1);
}

// A tile of `keys` keys from k0 that the causal mask cuts for query rows
// from q0: some key lies past the first row and past the prefix (a tile
// wholly inside the prefix is seen by every row).
__device__ __forceinline__ bool causal_cuts(int causal, int k0, int keys,
                                            int q0, int prefix) {
  return causal && k0 + keys - 1 > q0 && k0 + keys > prefix;
}

// The first q tile of `rows` rows that sees key tile k0 under the masks:
// the diagonal's, or 0 when the tile holds a prefix key (seen by every
// row) or no causal mask applies.
__device__ __forceinline__ int first_q_tile(int causal, int k0, int rows,
                                            int prefix) {
  return causal && k0 >= prefix ? k0 / rows : 0;
}

// Query row qi sees no key at all (then its softmax is uniform).
__device__ __forceinline__ bool no_key(int qi, int Skv, int window) {
  return window > 0 && qi - window + 1 >= Skv;
}

// Rows r0 .. r0 + ROWS - 1 of a [S, DH] slab with row stride `stride` into
// a [ROWS][DH + 1] f32 tile, times `mul`; rows at or past S are zero.
template <typename T, int DH, int ROWS>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long stride, int r0, int S,
                                      float mul) {
  for (int e = threadIdx.x; e < ROWS * DH; e += kThreads) {
    const int r = e / DH, c = e % DH;
    dst[r * (DH + 1) + c] =
        r0 + r < S ? to_f32(src[(r0 + r) * stride + c]) * mul : 0.f;
  }
}

template <int DH>
constexpr size_t dq_smem() {  // Q, dO, K, V tiles; dS; lse and D
  constexpr int kBQ = bwd_tile(DH), kBK = kBQ;
  return sizeof(float) *
         (2 * kBQ * (DH + 1) + 2 * kBK * (DH + 1) + kBQ * (kBK + 1) + 2 * kBQ);
}

template <int DH>
constexpr size_t dkv_smem() {  // K, V, Q, dO tiles; P^T and dS^T; lse, D
  constexpr int kBQ = bwd_tile(DH), kBK = kBQ;
  return sizeof(float) *
         (2 * kBK * (DH + 1) + 2 * kBQ * (DH + 1) + 2 * kBK * (kBQ + 1) +
          2 * kBQ);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(Args<T> a) {
  constexpr int kBQ = bwd_tile(DH), kBK = kBQ;
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
  stage<T, DH, kBQ>(Qs, a.q + bb * a.qs.b + h * a.qs.h, a.qs.s, q0, a.Sq,
                    a.scale);
  stage<T, DH, kBQ>(dOs, a.dO + bb * a.dos.b + h * a.dos.h, a.dos.s, q0,
                    a.Sq, 1.f);
  __syncthreads();
  {  // D = rowsum(dO * O): kLpr neighbouring lanes a row, dh / kLpr each
    constexpr int kLpr = kThreads / kBQ;
    const int r = tid / kLpr, part = tid % kLpr, qi = q0 + r;
    float d = 0.f;
    if (qi < a.Sq) {
      const T* orow = a.o + bb * a.os.b + h * a.os.h + qi * a.os.s;
      for (int c = part; c < DH; c += kLpr)
        d = fmaf(dOs[r * (DH + 1) + c], to_f32(orow[c]), d);
    }
#pragma unroll
    for (int o = 1; o < kLpr; o *= 2) d += __shfl_xor_sync(0xffffffffu, d, o);
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
  if (a.causal) kt_end = min(kt_end, causal_last(q_last, a.prefix) / kBK + 1);
  const int kt_begin = a.window > 0 ? max(q0 - a.window + 1, 0) / kBK : 0;

  float acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    stage<T, DH, kBK>(Ks, kp, a.ks.s, k0, a.Skv, 1.f);
    stage<T, DH, kBK>(Vs, vp, a.vs.s, k0, a.Skv, 1.f);
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
        if (qi < a.Sq && kj < a.Skv &&
            sees(qi, kj, a.causal, a.window, a.prefix))
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
  constexpr int kBQ = bwd_tile(DH), kBK = kBQ;
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
  const int qt_lo = first_q_tile(a.causal, k0, kBQ, a.prefix);
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

  stage<T, DH, kBK>(Ks, a.k + bb * a.ks.b + hk * a.ks.h, a.ks.s, k0, a.Skv,
                    1.f);
  stage<T, DH, kBK>(Vs, a.v + bb * a.vs.b + hk * a.vs.h, a.vs.s, k0, a.Skv,
                    1.f);

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
      stage<T, DH, kBQ>(Qs, qp, a.qs.s, q0, a.Sq, a.scale);
      stage<T, DH, kBQ>(dOs, dop, a.dos.s, q0, a.Sq, 1.f);
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
            if (sees(qi, kj, a.causal, a.window, a.prefix)) {
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

// ------------------------------------------- bf16 on the tensor cores (mma)
//
// The same two kernels, split and walk on mma.sync m16n8k16 (bf16 in, f32
// sums), built like the forward's `flash_fwd_mma`: 4 warps a block, each
// owning 16 rows of the block's tile; tiles of 16-byte rows staged by
// cp.async, XOR-swizzled in 16-byte chunks so that ldmatrix reads them
// without bank conflicts; the streamed tiles in a double-buffered ring.
// Grids run (heads, batch, tiles) with the heaviest tiles in the first
// blocks, so that under a causal mask the long blocks start first.
// * `flash_bwd_dq_mma`: 64 query rows a block.  Q and dO are staged once;
//   Q is held in registers as A fragments, dO's are read from shared
//   memory at each tile (held too, they push dh 128 past 255 registers
//   into spills).  D is summed from the staged dO and O read 16 bytes at a
//   time.  Each kv tile of BK keys gives S = Q K^T and dP = dO V^T (K, V
//   as B fragments by ldmatrix); P and dS live in registers, where the C
//   fragments of S are already dS's A fragments, and dQ += dS K takes K's
//   B fragments by ldmatrix.trans.
// * `flash_bwd_dkv_mma`: 64 keys a block, K and V staged once.  Each q tile
//   of BQ rows (GQA heads and tiles walked as `flash_bwd_dkv` walks them)
//   streams Q, dO, lse and D through the ring and gives S^T = K Q^T and
//   dP^T = V dO^T (K, V as A fragments, Q, dO as B); dV += P^T dO and
//   dK += dS^T Q take dO and Q by ldmatrix.trans.
// Precision: a bf16 P or dS (2^-9 of its size) moves an output by many
// times its own bf16 rounding where the sum cancels, past the element
// gate |g - p| <= 1e-3 + 2^-7 |p| (tests/test_torch_flash_bwd_tiles.py
// emulates both); so P and dS enter each of their products as a bf16 high
// part plus a bf16 low part (ptx::split2), two mma a fragment: 10 products
// for the 7 of the split, every sum in f32, in a fixed order (no atomics).
// Registers bound the tiles: at dh 128 a dkv warp holds dK and dV (two
// 16 x 128 f32 blocks, 128 registers a thread), so its q tiles take 32 rows.
namespace bwd_mma {

using namespace ptx;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kTile = 16 * kWarps;  // query rows (dq) or keys (dkv) a block
constexpr int kThreadsMma = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct Cfg {
  static constexpr int BK = 64;                   // keys a kv tile (dq)
  static constexpr int BQ = DH == 128 ? 32 : 64;  // query rows a q tile (dkv)
  static constexpr int NCH = DH / 8;              // 16-byte chunks in a row
  static constexpr int MASK = (NCH < 8 ? NCH : 8) - 1;
  // Q, dO, 2 x (K, V); lse and D
  static constexpr int SMEM_DQ = (2 * kTile + 4 * BK) * DH * 2 + 2 * kTile * 4;
  // K, V, 2 x (Q, dO); 2 x (lse, D)
  static constexpr int SMEM_DKV =
      (2 * kTile + 4 * BQ) * DH * 2 + 4 * BQ * 4;
};

// Element offset of 16-byte chunk c of row r in a [rows][DH] tile.
template <int DH>
__device__ __forceinline__ int swz(int r, int c) {
  return r * DH + ((c ^ (r & Cfg<DH>::MASK)) << 3);
}

// Rows row0 .. row0 + ROWS - 1 of a [S, DH] slab with row stride `stride`
// into a swizzled tile by a block of THREADS; rows at or past S are
// zero-filled.
template <int DH, int ROWS, int THREADS = kThreadsMma>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int row0, int S) {
  constexpr int NCH = Cfg<DH>::NCH;
  static_assert(ROWS * NCH % THREADS == 0, "whole passes of the block");
#pragma unroll
  for (int n = 0; n < ROWS * NCH / THREADS; ++n) {
    const int i = threadIdx.x + n * THREADS;
    const int r = i / NCH, c = i % NCH;
    const bool ok = row0 + r < S;
    const bf16* g =
        ok ? src + static_cast<long long>(row0 + r) * stride + c * 8 : src;
    cp_async16(dst + swz<DH>(r, c), g, ok);
  }
}

// A fragments (row-major 16 x 16, rows 16 w .. 16 w + 15 of the tile) of
// dh slice kk; B fragments of n8 blocks 2 nb and 2 nb + 1 whose rows are
// n (non-transposed: S-like products) and of k16 slice kb whose rows are k
// (ldmatrix.trans: the products into dQ, dK and dV).
template <int DH>
__device__ __forceinline__ void frag_a(uint32_t (&r)[4], const bf16* t,
                                       int w, int kk) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(r, t + swz<DH>(w * 16 + (lane & 15), 2 * kk + (lane >> 4)));
}
template <int DH>
__device__ __forceinline__ void frag_b(uint32_t (&r)[4], const bf16* t,
                                       int nb, int kk) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(r, t + swz<DH>(nb * 16 + (lane & 7) + ((lane >> 4) << 3),
                         2 * kk + ((lane >> 3) & 1)));
}
template <int DH>
__device__ __forceinline__ void frag_bt(uint32_t (&r)[4], const bf16* t,
                                        int kb, int db) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_t(r, t + swz<DH>(kb * 16 + (lane & 15), 2 * db + (lane >> 4)));
}

// acc[ND] += (hi + lo of the C fragments c[2 kb], c[2 kb + 1]) x B, for
// every k16 slice kb of c; B's slice kb is rows 16 kb .. of the tile t.
template <int DH, int NC>
__device__ __forceinline__ void product_hi_lo(float (&acc)[DH / 8][4],
                                              const float (&c)[NC][4],
                                              const bf16* t) {
#pragma unroll
  for (int kb = 0; kb < NC / 2; ++kb) {
    uint32_t hi[4], lo[4];
    split2(c[2 * kb][0], c[2 * kb][1], hi[0], lo[0]);
    split2(c[2 * kb][2], c[2 * kb][3], hi[1], lo[1]);
    split2(c[2 * kb + 1][0], c[2 * kb + 1][1], hi[2], lo[2]);
    split2(c[2 * kb + 1][2], c[2 * kb + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int db = 0; db < DH / 16; ++db) {
      uint32_t b[4];
      frag_bt<DH>(b, t, kb, db);
      mma16816(acc[2 * db], hi, b[0], b[1]);
      mma16816(acc[2 * db + 1], hi, b[2], b[3]);
      mma16816(acc[2 * db], lo, b[0], b[1]);
      mma16816(acc[2 * db + 1], lo, b[2], b[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
}

// Rows r, r + 8 of a [16 x DH] C-fragment block times `mul` as bf16 pairs
// at row pointers p0 (row r) and p1 (row r + 8), where they are in range.
template <int DH>
__device__ __forceinline__ void store_rows(bf16* p0, bf16* p1, bool ok0,
                                           bool ok1,
                                           const float (&acc)[DH / 8][4],
                                           float mul) {
  const int col = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    if (ok0)
      *reinterpret_cast<__nv_bfloat162*>(p0 + 8 * j + col) =
          pack2(acc[j][0] * mul, acc[j][1] * mul);
    if (ok1)
      *reinterpret_cast<__nv_bfloat162*>(p1 + 8 * j + col) =
          pack2(acc[j][2] * mul, acc[j][3] * mul);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreadsMma)
flash_bwd_dq_mma(Args<bf16> a) {
  using Cf = Cfg<DH>;
  constexpr int BK = Cf::BK, NB = BK / 8, ND = DH / 8, KQ = DH / 16;
  constexpr int NCH = Cf::NCH;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kTile][DH]
  bf16* dOs = Qs + kTile * DH;                   // [kTile][DH]
  bf16* Ks = dOs + kTile * DH;                   // [2][BK][DH]
  bf16* Vs = Ks + 2 * BK * DH;                   // [2][BK][DH]
  float* Ls = reinterpret_cast<float*>(Vs + 2 * BK * DH);  // [kTile], log2
  float* Ds = Ls + kTile;                                   // [kTile]

  // grid (Hq, B, q tiles): the blocks of the heaviest tiles start first
  const int n_qt = (a.Sq + kTile - 1) / kTile;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.z)) * kTile;
  const int h = blockIdx.x, bb = blockIdx.y;
  const int hk = h / (a.Hq / a.Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row0 = (static_cast<long long>(bb) * a.Hq + h) * a.Sq;
  const bf16* kp = a.k + bb * a.ks.b + hk * a.ks.h;
  const bf16* vp = a.v + bb * a.vs.b + hk * a.vs.h;

  // kv tiles the block's rows see; a row without a key sees none, and its
  // dQ stays 0
  const int q_last = min(q0 + kTile, a.Sq) - 1;
  int kt_end = (a.Skv + BK - 1) / BK;
  if (a.causal) kt_end = min(kt_end, causal_last(q_last, a.prefix) / BK + 1);
  const int kt_begin = a.window > 0 ? max(q0 - a.window + 1, 0) / BK : 0;

  load_tile<DH, kTile>(Qs, a.q + bb * a.qs.b + h * a.qs.h, a.qs.s, q0, a.Sq);
  load_tile<DH, kTile>(dOs, a.dO + bb * a.dos.b + h * a.dos.h, a.dos.s, q0,
                       a.Sq);
  cp_commit();
  if (kt_begin < kt_end) {
    load_tile<DH, BK>(Ks, kp, a.ks.s, kt_begin * BK, a.Skv);
    load_tile<DH, BK>(Vs, vp, a.vs.s, kt_begin * BK, a.Skv);
  }
  cp_commit();
  cp_wait<1>();  // Q and dO have landed
  __syncthreads();

  {  // D = rowsum(dO * O): two neighbouring lanes a row, 16 bytes a load
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1, qi = q0 + r;
    float d = 0.f;
    if (qi < a.Sq) {
      const bf16* orow = a.o + bb * a.os.b + h * a.os.h + qi * a.os.s;
#pragma unroll
      for (int c = half * NCH / 2; c < (half + 1) * NCH / 2; ++c) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + 8 * c);
        const uint4 gv = *reinterpret_cast<const uint4*>(dOs + swz<DH>(r, c));
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]);
          const float2 gf = __bfloat1622float2(g2[e]);
          d = fmaf(gf.x, of.x, d);
          d = fmaf(gf.y, of.y, d);
        }
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) {
      Ds[r] = d;
      Ls[r] = qi < a.Sq ? a.lse[row0 + qi] * kLog2e : 0.f;
      if (qi < a.Sq) a.D[row0 + qi] = d;
    }
  }

  uint32_t qf[KQ][4];  // Q's A fragments
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk) {
    frag_a<DH>(qf[kk], Qs, warp, kk);
  }
  __syncthreads();  // Ls and Ds are written
  // this lane's rows in S / dQ: r and r + 8
  const int rl = warp * 16 + (lane >> 2), r0 = q0 + rl;
  const float lse2[2] = {Ls[rl], Ls[rl + 8]};
  const float dd[2] = {Ds[rl], Ds[rl + 8]};
  const float scale_log2 = a.scale * kLog2e;

  float acc[ND][4];
  zero(acc);
  for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
    const int st = it & 1;
    if (kt + 1 < kt_end) {
      load_tile<DH, BK>(Ks + (st ^ 1) * BK * DH, kp, a.ks.s, (kt + 1) * BK,
                        a.Skv);
      load_tile<DH, BK>(Vs + (st ^ 1) * BK * DH, vp, a.vs.s, (kt + 1) * BK,
                        a.Skv);
    }
    cp_commit();
    cp_wait<1>();  // tile kt has landed
    __syncthreads();
    const bf16* Kt = Ks + st * BK * DH;
    const bf16* Vt = Vs + st * BK * DH;

    float s[NB][4], ds[NB][4];  // S, then P; dP, then dS
    zero(s);
    zero(ds);
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t g[4];  // dO's A fragment: from shared memory, see above
      frag_a<DH>(g, dOs, warp, kk);
#pragma unroll
      for (int nb = 0; nb < NB / 2; ++nb) {
        uint32_t b[4];
        frag_b<DH>(b, Kt, nb, kk);
        mma16816(s[2 * nb], qf[kk], b[0], b[1]);
        mma16816(s[2 * nb + 1], qf[kk], b[2], b[3]);
        frag_b<DH>(b, Vt, nb, kk);
        mma16816(ds[2 * nb], g, b[0], b[1]);
        mma16816(ds[2 * nb + 1], g, b[2], b[3]);
      }
    }

    // s[j][c]: row r0 + 8 (c >> 1), key k0 + 8 j + 2 (lane & 3) + (c & 1).
    // Rows past Sq have zero dO and D, so their dS is 0 unmasked.
    const int k0 = kt * BK;
    const bool edge = causal_cuts(a.causal, k0, BK, q0, a.prefix) ||
                      (a.window > 0 && k0 <= q0 + kTile - 1 - a.window) ||
                      k0 + BK > a.Skv;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float p = exp2f(fmaf(s[j][c], scale_log2, -lse2[c >> 1]));
        if (edge) {
          const int kj = k0 + 8 * j + 2 * (lane & 3) + (c & 1);
          const int qi = r0 + 8 * (c >> 1);
          if (kj >= a.Skv || !sees(qi, kj, a.causal, a.window, a.prefix))
            p = 0.f;
        }
        ds[j][c] = p * (ds[j][c] - dd[c >> 1]);
      }
    product_hi_lo<DH>(acc, ds, Kt);  // dQ += dS K
    __syncthreads();  // every warp is done with stage st before it refills
  }

  bf16* dqp = a.dq + bb * a.dqs.b + h * a.dqs.h;
  store_rows<DH>(dqp + r0 * a.dqs.s, dqp + (r0 + 8) * a.dqs.s, r0 < a.Sq,
                 r0 + 8 < a.Sq, acc, a.scale);
}

// The q tile the walk of one query head takes at or after qt: the tiles
// from the causal diagonal to the window's reach (.. qt_hi), then those
// holding rows without a key (qt_nokey ..).
__device__ __forceinline__ int walk_from(int qt, int qt_hi, int qt_nokey) {
  return qt > qt_hi && qt < qt_nokey ? qt_nokey : qt;
}

template <int DH>
__global__ void __launch_bounds__(kThreadsMma)
flash_bwd_dkv_mma(Args<bf16> a) {
  using Cf = Cfg<DH>;
  constexpr int BQ = Cf::BQ, NQ = BQ / 8, ND = DH / 8, KQ = DH / 16;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [kTile][DH]
  bf16* Vs = Ks + kTile * DH;                    // [kTile][DH]
  bf16* Qs = Vs + kTile * DH;                    // [2][BQ][DH]
  bf16* dOs = Qs + 2 * BQ * DH;                  // [2][BQ][DH]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BQ * DH);  // [2][BQ]
  float* Ds = Ls + 2 * BQ;                                   // [2][BQ]

  // grid (Hkv, B, kv tiles): under a causal mask the blocks of the
  // heaviest tiles (the first keys) start first
  const int k0 = blockIdx.z * kTile;
  const int hk = blockIdx.x, bb = blockIdx.y;
  const int rep = a.Hq / a.Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // the q tiles of each query head, as flash_bwd_dkv walks them
  const int n_qt = (a.Sq + BQ - 1) / BQ;
  const int k_last = min(k0 + kTile, a.Skv) - 1;
  const int qt_lo = first_q_tile(a.causal, k0, BQ, a.prefix);
  const long long reach = a.window > 0
                              ? static_cast<long long>(k_last) + a.window - 1
                              : static_cast<long long>(a.Sq) - 1;
  const int qt_hi =
      static_cast<int>(min(reach, static_cast<long long>(a.Sq) - 1) / BQ);
  const long long first_no_key =
      static_cast<long long>(a.Skv) + a.window - 1;
  const int qt_nokey = a.window > 0 && first_no_key < a.Sq
                           ? static_cast<int>(first_no_key / BQ)
                           : n_qt;
  const int qt_first = walk_from(qt_lo, qt_hi, qt_nokey);
  const float uniform = __fdiv_rn(1.f, static_cast<float>(a.Skv));
  const float scale_log2 = a.scale * kLog2e;

  // Q, dO, lse and D of query head hk * rep + hh, tile qt, into stage st
  auto load_q = [&](int st, int hh, int qt) {
    const int h = hk * rep + hh, q0 = qt * BQ;
    const long long row0 = (static_cast<long long>(bb) * a.Hq + h) * a.Sq;
    load_tile<DH, BQ>(Qs + st * BQ * DH, a.q + bb * a.qs.b + h * a.qs.h,
                      a.qs.s, q0, a.Sq);
    load_tile<DH, BQ>(dOs + st * BQ * DH, a.dO + bb * a.dos.b + h * a.dos.h,
                      a.dos.s, q0, a.Sq);
    for (int i = threadIdx.x; i < BQ; i += kThreadsMma) {
      const bool ok = q0 + i < a.Sq;
      const long long at = ok ? row0 + q0 + i : 0;
      cp_async4(Ls + st * BQ + i, a.lse + at, ok);
      cp_async4(Ds + st * BQ + i, a.D + at, ok);
    }
  };

  load_tile<DH, kTile>(Ks, a.k + bb * a.ks.b + hk * a.ks.h, a.ks.s, k0,
                       a.Skv);
  load_tile<DH, kTile>(Vs, a.v + bb * a.vs.b + hk * a.vs.h, a.vs.s, k0,
                       a.Skv);
  const bool any = qt_first < n_qt;
  if (any) load_q(0, 0, qt_first);
  cp_commit();

  float dk[ND][4], dv[ND][4];
  zero(dk);
  zero(dv);
  // this lane's keys in S^T / dK / dV: kr and kr + 8
  const int kr = k0 + warp * 16 + (lane >> 2);

  int hh = 0, qt = qt_first;
  for (int it = 0; any && hh < rep; ++it) {
    const int st = it & 1;
    int nhh = hh, nqt = walk_from(qt + 1, qt_hi, qt_nokey);
    if (nqt >= n_qt) {
      ++nhh;
      nqt = qt_first;
    }
    if (nhh < rep) load_q(st ^ 1, nhh, nqt);
    cp_commit();
    cp_wait<1>();  // K, V and this tile have landed
    __syncthreads();
    const bf16* Qt = Qs + st * BQ * DH;
    const bf16* dOt = dOs + st * BQ * DH;
    const float* Lt = Ls + st * BQ;
    const float* Dt = Ds + st * BQ;

    float s[NQ][4], ds[NQ][4];  // S^T, then P^T; dP^T, then dS^T
    zero(s);
    zero(ds);
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t ka[4], va[4];
      frag_a<DH>(ka, Ks, warp, kk);
      frag_a<DH>(va, Vs, warp, kk);
#pragma unroll
      for (int nb = 0; nb < NQ / 2; ++nb) {
        uint32_t b[4];
        frag_b<DH>(b, Qt, nb, kk);
        mma16816(s[2 * nb], ka, b[0], b[1]);
        mma16816(s[2 * nb + 1], ka, b[2], b[3]);
        frag_b<DH>(b, dOt, nb, kk);
        mma16816(ds[2 * nb], va, b[0], b[1]);
        mma16816(ds[2 * nb + 1], va, b[2], b[3]);
      }
    }

    // s[j][c]: key kr + 8 (c >> 1), query row q0 + 8 j + 2 (lane & 3) +
    // (c & 1)
    const int q0 = qt * BQ;
    const bool edge = causal_cuts(a.causal, k0, kTile, q0, a.prefix) ||
                      (a.window > 0 && k0 <= q0 + BQ - 1 - a.window) ||
                      k0 + kTile > a.Skv || q0 + BQ > a.Sq;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      const float2 l2 = *reinterpret_cast<const float2*>(Lt + col);
      const float2 d2 = *reinterpret_cast<const float2*>(Dt + col);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float lse = c & 1 ? l2.y : l2.x, d = c & 1 ? d2.y : d2.x;
        float p = exp2f(fmaf(s[j][c], scale_log2, -lse * kLog2e));
        float g = p * (ds[j][c] - d);
        if (edge) {
          const int kj = kr + 8 * (c >> 1), qi = q0 + col + (c & 1);
          if (qi >= a.Sq || kj >= a.Skv) {
            p = g = 0.f;
          } else if (!sees(qi, kj, a.causal, a.window, a.prefix)) {
            g = 0.f;
            p = no_key(qi, a.Skv, a.window) ? uniform : 0.f;
          }
        }
        s[j][c] = p;
        ds[j][c] = g;
      }
    }
    product_hi_lo<DH>(dv, s, dOt);  // dV += P^T dO
    product_hi_lo<DH>(dk, ds, Qt);  // dK += dS^T Q
    __syncthreads();  // every warp is done with stage st before it refills
    hh = nhh;
    qt = nqt;
  }

  bf16* dkp = a.dk + bb * a.dks.b + hk * a.dks.h;
  bf16* dvp = a.dv + bb * a.dvs.b + hk * a.dvs.h;
  store_rows<DH>(dkp + kr * a.dks.s, dkp + (kr + 8) * a.dks.s, kr < a.Skv,
                 kr + 8 < a.Skv, dk, a.scale);
  store_rows<DH>(dvp + kr * a.dvs.s, dvp + (kr + 8) * a.dvs.s, kr < a.Skv,
                 kr + 8 < a.Skv, dv, 1.f);
}

template <int DH>
int launch(const Args<bf16>& a, int B, cudaStream_t stream) {
  constexpr int smem_dq = Cfg<DH>::SMEM_DQ, smem_dkv = Cfg<DH>::SMEM_DKV;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkv_mma<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dkv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_dq(a.Hq, B, (a.Sq + kTile - 1) / kTile);
  flash_bwd_dq_mma<DH><<<grid_dq, kThreadsMma, smem_dq, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_dkv(a.Hkv, B, (a.Skv + kTile - 1) / kTile);
  flash_bwd_dkv_mma<DH><<<grid_dkv, kThreadsMma, smem_dkv, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd_mma

// ------------------------------ bf16 at head dim 256 on the tensor cores
//
// The mma route's algebra and precision at dh 256, where `bwd_mma`'s
// warps cannot hold their tiles: a dkv warp would keep dK and dV as two
// 16 x 256 f32 blocks (256 registers a thread), and a dq warp's Q
// fragments alone would take 64.  So the blocks have 8 warps and split
// every output along dh: warp w owns 16 rows (dq) or keys (dkv), group
// w % 4, and the dh half w / 4, one 16 x 128 f32 block of dQ, or of dK and
// of dV (64 registers each).  Each tile runs in two phases:
// * phase 1: the 8 warps share S and dP (dq) or S^T and dP^T (dkv) of the
//   64 x 64 tile, 16 rows by 32 keys (or 16 keys by 32 rows) a warp, each
//   computed once, with Q, dO, K and V read from shared memory (ldmatrix)
//   at every tile and held in no register; the warp turns its part into P
//   and dS and writes them to shared memory as bf16 high and low parts
//   (`ptx::split2`), in [64][64] tiles swizzled like the operand tiles;
// * phase 2: each warp reads the parts of its 16 rows back as A fragments
//   over all 64 columns and adds hi x B and lo x B into its dh half.
// Rather than two passes over the dh halves, which would compute S and dP
// twice, the products are computed once and their P and dS shared.
// Shared memory: the dq kernel holds Q and dO (64 rows, 32 KB each), a
// 2-stage ring of K and V tiles of 64 keys (128 KB) and dS' parts (16 KB),
// 208.5 KB; the dkv kernel K and V (64 keys), a 2-stage ring of Q and dO
// tiles of 64 rows (128 KB) and the parts of P^T and dS^T (32 KB), 225 KB:
// one block an SM.
// Filling the card at one kv head: recurrentgemma-2b's local layers have
// 10 q heads on 1 kv head, so a grid of (kv tiles, kv heads, batch) is 128
// blocks of 10 heads each, one uneven wave: under the causal mask and the
// window a block's work runs from 33 q tiles a head (the first 32 kv
// tiles) down to 1.  The dkv grid splits each GQA group's heads over
// `groups` blocks (kernels/flash_attention.py `dkv_groups`: the fewest,
// dividing the group, that give 528 blocks, four waves; 5 groups of 2
// heads here, where 2 groups would leave a second wave of heavy blocks
// behind the light ones), each of which writes its f32 sums of dK and
// dV to a scratch the wrapper allocates; `sum_groups` then adds the
// groups' partials in order, scales dK and rounds once, so two calls give
// the same bits.  One group writes bf16 at once.
namespace bwd256 {

using namespace ptx;
using bf16 = __nv_bfloat16;
using bwd_mma::frag_a;
using bwd_mma::frag_b;
using bwd_mma::frag_bt;
using bwd_mma::load_tile;
using bwd_mma::store_rows;
using bwd_mma::swz;
using bwd_mma::walk_from;
using bwd_mma::zero;

constexpr int DH = 256;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 64;          // query rows (dq) or keys (dkv) a block
constexpr int kKeys = 64;          // keys a kv tile (dq)
constexpr int kQRows = 64;         // query rows a q tile (dkv)
constexpr int kTile = 64 * DH;     // elements of a [64][DH] tile
constexpr int kPart = 64 * 64;     // elements of a [64][64] part of P or dS
constexpr float kLog2e = 1.4426950408889634f;
// Q, dO, 2 x (K, V), dS hi and lo; lse and D
constexpr int SMEM_DQ = (6 * kTile + 2 * kPart) * 2 + 2 * kRows * 4;
// K, V, 2 x (Q, dO), P^T and dS^T hi and lo; 2 x (lse, D)
constexpr int SMEM_DKV = (6 * kTile + 4 * kPart) * 2 + 4 * kQRows * 4;
static_assert(SMEM_DQ <= 232448 && SMEM_DKV <= 232448,
              "the 227 KB a block may hold");

// The bf16 high and low parts of the pair (x0, x1) at element `off` of the
// parts hi and lo.
__device__ __forceinline__ void put_hi_lo(bf16* hi, bf16* lo, int off,
                                          float x0, float x1) {
  uint32_t h, l;
  split2(x0, x1, h, l);
  *reinterpret_cast<uint32_t*>(hi + off) = h;
  *reinterpret_cast<uint32_t*>(lo + off) = l;
}

// acc (a 16 x 128 block, the dh half `hf`) += (hi + lo) x t: the parts'
// rows 16 w .. 16 w + 15 as A fragments over their 64 columns, times rows
// 0 .. 63 of the [64][DH] tile t (ldmatrix.trans), hi then lo, f32 sums.
__device__ __forceinline__ void product_parts(float (&acc)[16][4],
                                              const bf16* hi, const bf16* lo,
                                              const bf16* t, int w,
                                              int hf) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    uint32_t ah[4], al[4];
    frag_a<64>(ah, hi, w, kb);
    frag_a<64>(al, lo, w, kb);
#pragma unroll
    for (int db = 0; db < 8; ++db) {
      uint32_t b[4];
      frag_bt<DH>(b, t, kb, 8 * hf + db);
      mma16816(acc[2 * db], ah, b[0], b[1]);
      mma16816(acc[2 * db + 1], ah, b[2], b[3]);
      mma16816(acc[2 * db], al, b[0], b[1]);
      mma16816(acc[2 * db + 1], al, b[2], b[3]);
    }
  }
}

// Rows r, r + 8 of a 16 x 128 C-fragment block as f32 pairs at row
// pointers p0 (row r) and p1 (row r + 8), where they are in range.
__device__ __forceinline__ void store_rows_f32(float* p0, float* p1,
                                               bool ok0, bool ok1,
                                               const float (&acc)[16][4]) {
  const int col = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (ok0)
      *reinterpret_cast<float2*>(p0 + 8 * j + col) =
          make_float2(acc[j][0], acc[j][1]);
    if (ok1)
      *reinterpret_cast<float2*>(p1 + 8 * j + col) =
          make_float2(acc[j][2], acc[j][3]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_mma256(Args<bf16> a) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [64][DH]
  bf16* dOs = Qs + kTile;                        // [64][DH]
  bf16* Ks = dOs + kTile;                        // [2][64][DH]
  bf16* Vs = Ks + 2 * kTile;                     // [2][64][DH]
  bf16* Sh = Vs + 2 * kTile;                     // dS hi [64 rows][64 keys]
  bf16* Sl = Sh + kPart;                         // dS lo
  float* Ls = reinterpret_cast<float*>(Sl + kPart);  // [64], log2
  float* Ds = Ls + kRows;                            // [64]

  // grid (Hq, B, q tiles): the blocks of the heaviest tiles start first
  const int n_qt = (a.Sq + kRows - 1) / kRows;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.z)) * kRows;
  const int h = blockIdx.x, bb = blockIdx.y;
  const int hk = h / (a.Hq / a.Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // rows 16 rg ..; keys 32 hf .. in phase 1, dh half hf in phase 2
  const int rg = warp & 3, hf = warp >> 2;
  const long long row0 = (static_cast<long long>(bb) * a.Hq + h) * a.Sq;
  const bf16* kp = a.k + bb * a.ks.b + hk * a.ks.h;
  const bf16* vp = a.v + bb * a.vs.b + hk * a.vs.h;

  // kv tiles the block's rows see; a row without a key sees none, and its
  // dQ stays 0
  const int q_last = min(q0 + kRows, a.Sq) - 1;
  int kt_end = (a.Skv + kKeys - 1) / kKeys;
  if (a.causal)
    kt_end = min(kt_end, causal_last(q_last, a.prefix) / kKeys + 1);
  const int kt_begin =
      a.window > 0 ? max(q0 - a.window + 1, 0) / kKeys : 0;

  load_tile<DH, kRows, kThreads>(Qs, a.q + bb * a.qs.b + h * a.qs.h,
                                 a.qs.s, q0, a.Sq);
  load_tile<DH, kRows, kThreads>(dOs, a.dO + bb * a.dos.b + h * a.dos.h,
                                 a.dos.s, q0, a.Sq);
  cp_commit();
  if (kt_begin < kt_end) {
    load_tile<DH, kKeys, kThreads>(Ks, kp, a.ks.s, kt_begin * kKeys, a.Skv);
    load_tile<DH, kKeys, kThreads>(Vs, vp, a.vs.s, kt_begin * kKeys, a.Skv);
  }
  cp_commit();
  cp_wait<1>();  // Q and dO have landed
  __syncthreads();

  {  // D = rowsum(dO * O): four neighbouring lanes a row, 16 bytes a load
    const int r = threadIdx.x >> 2, part = threadIdx.x & 3, qi = q0 + r;
    float d = 0.f;
    if (qi < a.Sq) {
      const bf16* orow = a.o + bb * a.os.b + h * a.os.h + qi * a.os.s;
#pragma unroll
      for (int c = part * DH / 32; c < (part + 1) * DH / 32; ++c) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + 8 * c);
        const uint4 gv = *reinterpret_cast<const uint4*>(dOs + swz<DH>(r, c));
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]);
          const float2 gf = __bfloat1622float2(g2[e]);
          d = fmaf(gf.x, of.x, d);
          d = fmaf(gf.y, of.y, d);
        }
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (part == 0) {
      Ds[r] = d;
      Ls[r] = qi < a.Sq ? a.lse[row0 + qi] * kLog2e : 0.f;
      if (qi < a.Sq) a.D[row0 + qi] = d;
    }
  }
  __syncthreads();  // Ls and Ds are written
  // this lane's rows in S / dQ: rl and rl + 8 of the block's
  const int rl = rg * 16 + (lane >> 2), r0 = q0 + rl;
  const float lse2[2] = {Ls[rl], Ls[rl + 8]};
  const float dd[2] = {Ds[rl], Ds[rl + 8]};
  const float scale_log2 = a.scale * kLog2e;

  float acc[16][4];  // dQ, columns 128 hf ..
  zero(acc);
  for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
    const int st = it & 1;
    if (kt + 1 < kt_end) {
      load_tile<DH, kKeys, kThreads>(Ks + (st ^ 1) * kTile, kp, a.ks.s,
                                     (kt + 1) * kKeys, a.Skv);
      load_tile<DH, kKeys, kThreads>(Vs + (st ^ 1) * kTile, vp, a.vs.s,
                                     (kt + 1) * kKeys, a.Skv);
    }
    cp_commit();
    cp_wait<1>();  // tile kt has landed
    __syncthreads();
    const bf16* Kt = Ks + st * kTile;
    const bf16* Vt = Vs + st * kTile;

    // phase 1: S and dP of rows 16 rg .. by keys 32 hf ..
    float s[4][4], dp[4][4];  // S, then P; dP, then dS
    zero(s);
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t qa[4], ga[4];
      frag_a<DH>(qa, Qs, rg, kk);
      frag_a<DH>(ga, dOs, rg, kk);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        uint32_t b[4];
        frag_b<DH>(b, Kt, 2 * hf + nb, kk);
        mma16816(s[2 * nb], qa, b[0], b[1]);
        mma16816(s[2 * nb + 1], qa, b[2], b[3]);
        frag_b<DH>(b, Vt, 2 * hf + nb, kk);
        mma16816(dp[2 * nb], ga, b[0], b[1]);
        mma16816(dp[2 * nb + 1], ga, b[2], b[3]);
      }
    }
    // s[j][c]: row r0 + 8 (c >> 1), key k0 + 32 hf + 8 j + 2 (lane & 3)
    // + (c & 1).  Rows past Sq have zero dO and D, so their dS is 0.
    const int k0 = kt * kKeys;
    const bool edge = causal_cuts(a.causal, k0, kKeys, q0, a.prefix) ||
                      (a.window > 0 && k0 <= q0 + kRows - 1 - a.window) ||
                      k0 + kKeys > a.Skv;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float p = exp2f(fmaf(s[j][c], scale_log2, -lse2[c >> 1]));
        if (edge) {
          const int kj = k0 + 32 * hf + 8 * j + 2 * (lane & 3) + (c & 1);
          const int qi = r0 + 8 * (c >> 1);
          if (kj >= a.Skv || !sees(qi, kj, a.causal, a.window, a.prefix))
            p = 0.f;
        }
        dp[j][c] = p * (dp[j][c] - dd[c >> 1]);
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        put_hi_lo(Sh, Sl, swz<64>(rl + 8 * i, 4 * hf + j) + 2 * (lane & 3),
                  dp[j][2 * i], dp[j][2 * i + 1]);
    __syncthreads();  // dS of the whole tile is written
    // phase 2: dQ += dS K over the tile's 64 keys, this warp's dh half
    product_parts(acc, Sh, Sl, Kt, rg, hf);
    __syncthreads();  // every warp is done with stage st and dS
  }

  bf16* dqp = a.dq + bb * a.dqs.b + h * a.dqs.h + 128 * hf;
  store_rows<128>(dqp + r0 * a.dqs.s, dqp + (r0 + 8) * a.dqs.s, r0 < a.Sq,
                  r0 + 8 < a.Sq, acc, a.scale);
}

// part: null, or the f32 scratch [2][groups][B][Hkv][Skv][DH] (dK's sums,
// then dV's) when the GQA group's heads are split over `groups` blocks.
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_mma256(Args<bf16> a, int groups, float* part) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [64][DH]
  bf16* Vs = Ks + kTile;                         // [64][DH]
  bf16* Qs = Vs + kTile;                         // [2][64][DH]
  bf16* dOs = Qs + 2 * kTile;                    // [2][64][DH]
  bf16* Ph = dOs + 2 * kTile;                    // P^T hi [64 keys][64 rows]
  bf16* Pl = Ph + kPart;                         // P^T lo
  bf16* Gh = Pl + kPart;                         // dS^T hi
  bf16* Gl = Gh + kPart;                         // dS^T lo
  float* Ls = reinterpret_cast<float*>(Gl + kPart);  // [2][64]
  float* Ds = Ls + 2 * kQRows;                       // [2][64]

  // grid (Hkv x groups, B, kv tiles): under a causal mask the blocks of
  // the heaviest tiles (the first keys) start first
  const int k0 = blockIdx.z * kRows;
  const int hk = blockIdx.x / groups, g = blockIdx.x % groups;
  const int bb = blockIdx.y;
  const int rep = a.Hq / a.Hkv, per = rep / groups;
  const int h_first = hk * rep + g * per;  // this block's query heads
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // keys 16 kg ..; rows 32 hf .. in phase 1, dh half hf in phase 2
  const int kg = warp & 3, hf = warp >> 2;

  // the q tiles of each query head, as flash_bwd_dkv walks them
  const int n_qt = (a.Sq + kQRows - 1) / kQRows;
  const int k_last = min(k0 + kRows, a.Skv) - 1;
  const int qt_lo = first_q_tile(a.causal, k0, kQRows, a.prefix);
  const long long reach = a.window > 0
                              ? static_cast<long long>(k_last) + a.window - 1
                              : static_cast<long long>(a.Sq) - 1;
  const int qt_hi =
      static_cast<int>(min(reach, static_cast<long long>(a.Sq) - 1) / kQRows);
  const long long first_no_key =
      static_cast<long long>(a.Skv) + a.window - 1;
  const int qt_nokey = a.window > 0 && first_no_key < a.Sq
                           ? static_cast<int>(first_no_key / kQRows)
                           : n_qt;
  const int qt_first = walk_from(qt_lo, qt_hi, qt_nokey);
  const float uniform = __fdiv_rn(1.f, static_cast<float>(a.Skv));
  const float scale_log2 = a.scale * kLog2e;

  // Q, dO, lse and D of query head h_first + hh, tile qt, into stage st
  auto load_q = [&](int st, int hh, int qt) {
    const int h = h_first + hh, q0 = qt * kQRows;
    const long long row0 = (static_cast<long long>(bb) * a.Hq + h) * a.Sq;
    load_tile<DH, kQRows, kThreads>(Qs + st * kTile,
                                    a.q + bb * a.qs.b + h * a.qs.h, a.qs.s,
                                    q0, a.Sq);
    load_tile<DH, kQRows, kThreads>(dOs + st * kTile,
                                    a.dO + bb * a.dos.b + h * a.dos.h,
                                    a.dos.s, q0, a.Sq);
    if (threadIdx.x < kQRows) {
      const int i = threadIdx.x;
      const bool ok = q0 + i < a.Sq;
      const long long at = ok ? row0 + q0 + i : 0;
      cp_async4(Ls + st * kQRows + i, a.lse + at, ok);
      cp_async4(Ds + st * kQRows + i, a.D + at, ok);
    }
  };

  load_tile<DH, kRows, kThreads>(Ks, a.k + bb * a.ks.b + hk * a.ks.h,
                                 a.ks.s, k0, a.Skv);
  load_tile<DH, kRows, kThreads>(Vs, a.v + bb * a.vs.b + hk * a.vs.h,
                                 a.vs.s, k0, a.Skv);
  const bool any = qt_first < n_qt;
  if (any) load_q(0, 0, qt_first);
  cp_commit();

  float dk[16][4], dv[16][4];  // columns 128 hf ..
  zero(dk);
  zero(dv);
  // this lane's keys in S^T / dK / dV: kl and kl + 8 of the block's
  const int kl = kg * 16 + (lane >> 2), kr = k0 + kl;

  int hh = 0, qt = qt_first;
  for (int it = 0; any && hh < per; ++it) {
    const int st = it & 1;
    int nhh = hh, nqt = walk_from(qt + 1, qt_hi, qt_nokey);
    if (nqt >= n_qt) {
      ++nhh;
      nqt = qt_first;
    }
    if (nhh < per) load_q(st ^ 1, nhh, nqt);
    cp_commit();
    cp_wait<1>();  // K, V and this tile have landed
    __syncthreads();
    const bf16* Qt = Qs + st * kTile;
    const bf16* dOt = dOs + st * kTile;
    const float* Lt = Ls + st * kQRows;
    const float* Dt = Ds + st * kQRows;

    // phase 1: S^T and dP^T of keys 16 kg .. by rows 32 hf ..
    float s[4][4], ds[4][4];  // S^T, then P^T; dP^T, then dS^T
    zero(s);
    zero(ds);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t ka[4], va[4];
      frag_a<DH>(ka, Ks, kg, kk);
      frag_a<DH>(va, Vs, kg, kk);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        uint32_t b[4];
        frag_b<DH>(b, Qt, 2 * hf + nb, kk);
        mma16816(s[2 * nb], ka, b[0], b[1]);
        mma16816(s[2 * nb + 1], ka, b[2], b[3]);
        frag_b<DH>(b, dOt, 2 * hf + nb, kk);
        mma16816(ds[2 * nb], va, b[0], b[1]);
        mma16816(ds[2 * nb + 1], va, b[2], b[3]);
      }
    }

    // s[j][c]: key kr + 8 (c >> 1), query row q0 + 32 hf + 8 j +
    // 2 (lane & 3) + (c & 1)
    const int q0 = qt * kQRows;
    const bool edge = causal_cuts(a.causal, k0, kRows, q0, a.prefix) ||
                      (a.window > 0 && k0 <= q0 + kQRows - 1 - a.window) ||
                      k0 + kRows > a.Skv || q0 + kQRows > a.Sq;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 32 * hf + 8 * j + 2 * (lane & 3);
      const float2 l2 = *reinterpret_cast<const float2*>(Lt + col);
      const float2 d2 = *reinterpret_cast<const float2*>(Dt + col);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float lse = c & 1 ? l2.y : l2.x, d = c & 1 ? d2.y : d2.x;
        float p = exp2f(fmaf(s[j][c], scale_log2, -lse * kLog2e));
        float gr = p * (ds[j][c] - d);
        if (edge) {
          const int kj = kr + 8 * (c >> 1), qi = q0 + col + (c & 1);
          if (qi >= a.Sq || kj >= a.Skv) {
            p = gr = 0.f;
          } else if (!sees(qi, kj, a.causal, a.window, a.prefix)) {
            gr = 0.f;
            p = no_key(qi, a.Skv, a.window) ? uniform : 0.f;
          }
        }
        s[j][c] = p;
        ds[j][c] = gr;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int off = swz<64>(kl + 8 * i, 4 * hf + j) + 2 * (lane & 3);
        put_hi_lo(Ph, Pl, off, s[j][2 * i], s[j][2 * i + 1]);
        put_hi_lo(Gh, Gl, off, ds[j][2 * i], ds[j][2 * i + 1]);
      }
    __syncthreads();  // P^T and dS^T of the whole tile are written
    // phase 2: this warp's dh half over the tile's 64 rows
    product_parts(dv, Ph, Pl, dOt, kg, hf);  // dV += P^T dO
    product_parts(dk, Gh, Gl, Qt, kg, hf);   // dK += dS^T Q
    __syncthreads();  // every warp is done with stage st and the parts
    hh = nhh;
    qt = nqt;
  }

  const bool ok0 = kr < a.Skv, ok1 = kr + 8 < a.Skv;
  if (part == nullptr) {
    bf16* dkp = a.dk + bb * a.dks.b + hk * a.dks.h + 128 * hf;
    bf16* dvp = a.dv + bb * a.dvs.b + hk * a.dvs.h + 128 * hf;
    store_rows<128>(dkp + kr * a.dks.s, dkp + (kr + 8) * a.dks.s, ok0, ok1,
                    dk, a.scale);
    store_rows<128>(dvp + kr * a.dvs.s, dvp + (kr + 8) * a.dvs.s, ok0, ok1,
                    dv, 1.f);
  } else {
    const long long n = static_cast<long long>(gridDim.y) * a.Hkv * a.Skv *
                        DH;  // one group's partial
    float* pk = part +
                ((static_cast<long long>(g) * gridDim.y + bb) * a.Hkv + hk) *
                    a.Skv * DH +
                128 * hf;
    float* pv = pk + groups * n;
    store_rows_f32(pk + static_cast<long long>(kr) * DH,
                   pk + static_cast<long long>(kr + 8) * DH, ok0, ok1, dk);
    store_rows_f32(pv + static_cast<long long>(kr) * DH,
                   pv + static_cast<long long>(kr + 8) * DH, ok0, ok1, dv);
  }
}

// dk = bf16(scale * sum of the groups' dK partials), dv = bf16(sum of their
// dV partials), the groups added in order 0, 1, ..: four elements a
// thread, over the grid's stride.
__global__ void __launch_bounds__(256)
sum_groups(Args<bf16> a, int B, int groups, const float* __restrict__ part) {
  const long long n4 = static_cast<long long>(B) * a.Hkv * a.Skv * (DH / 4);
  const long long n = 4 * n4;  // one group's partial
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < 2 * n4; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int t = i >= n4;            // 0: dK, 1: dV
    const long long j = i - t * n4;   // the float4 of one group's partial
    const int c = static_cast<int>(j % (DH / 4)) * 4;
    const long long row = j / (DH / 4);   // (b Hkv + hk) Skv + key
    const int key = static_cast<int>(row % a.Skv);
    const long long bh = row / a.Skv;
    const int hk = static_cast<int>(bh % a.Hkv);
    const int bb = static_cast<int>(bh / a.Hkv);
    const float* p = part + t * groups * n + 4 * j;
    float4 acc = *reinterpret_cast<const float4*>(p);
    for (int gi = 1; gi < groups; ++gi) {
      const float4 x = *reinterpret_cast<const float4*>(p + gi * n);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const float mul = t ? 1.f : a.scale;
    bf16* out = t ? a.dv + bb * a.dvs.b + hk * a.dvs.h + key * a.dvs.s + c
                  : a.dk + bb * a.dks.b + hk * a.dks.h + key * a.dks.s + c;
    *reinterpret_cast<__nv_bfloat162*>(out) =
        pack2(acc.x * mul, acc.y * mul);
    *reinterpret_cast<__nv_bfloat162*>(out + 2) =
        pack2(acc.z * mul, acc.w * mul);
  }
}

// dq with D, then dk and dv (and, for groups > 1, the sum of the groups'
// partials in `part`), on `stream`.
int launch(const Args<bf16>& a, int B, int groups, float* part,
           cudaStream_t stream) {
  if (groups < 1 || (a.Hq / a.Hkv) % groups != 0 ||
      (groups > 1 && part == nullptr) || a.Hkv * groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma256, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_DQ);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkv_mma256,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_DKV);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_dq(a.Hq, B, (a.Sq + kRows - 1) / kRows);
  flash_bwd_dq_mma256<<<grid_dq, kThreads, SMEM_DQ, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_dkv(a.Hkv * groups, B, (a.Skv + kRows - 1) / kRows);
  flash_bwd_dkv_mma256<<<grid_dkv, kThreads, SMEM_DKV, stream>>>(
      a, groups, groups > 1 ? part : nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess || groups == 1) return static_cast<int>(err);
  const long long work = 2LL * B * a.Hkv * a.Skv * (DH / 4);
  const long long blocks = (work + 255) / 256;
  sum_groups<<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256, 0,
               stream>>>(a, B, groups, part);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd256

template <typename T, int DH>
int launch(const Args<T>& a, int B, cudaStream_t stream) {
  constexpr int kBQ = bwd_tile(DH), kBK = kBQ;
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

enum { ROUTE_SIMT = 0, ROUTE_MMA = 1 };

// ROUTE_MMA launches bwd_mma::launch<DH> (bf16 at head dims 64 and 128) or
// bwd256::launch (bf16 at 256, the only one that splits GQA groups),
// ROUTE_SIMT launch<T, DH>.
template <typename T>
int dispatch_dh(int route, int dh, const Args<T>& a, int B, int groups,
                float* part, cudaStream_t stream) {
  if (route == ROUTE_MMA) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      if (dh == 256) return bwd256::launch(a, B, groups, part, stream);
      if (groups != 1) return static_cast<int>(cudaErrorInvalidValue);
      if (dh == 64) return bwd_mma::launch<64>(a, B, stream);
      if (dh == 128) return bwd_mma::launch<128>(a, B, stream);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (groups != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dh) {
    case 16:
      return launch<T, 16>(a, B, stream);
    case 32:
      return launch<T, 32>(a, B, stream);
    case 64:
      return launch<T, 64>(a, B, stream);
    case 128:
      return launch<T, 128>(a, B, stream);
    case 256:
      return launch<T, 256>(a, B, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* o,
        const void* dO, const float* lse, float* D, void* dq, void* dk,
        void* dv, int B, int Hq, int Hkv, int Sq, int Skv, int dh,
        const long long* st, float scale, int causal, int window, int prefix,
        int route, int groups, float* part, cudaStream_t stream) {
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
  a.prefix = prefix;
  a.scale = scale;
  return dispatch_dh<T>(route, dh, a, B, groups, part, stream);
}

}  // namespace

extern "C" {

// strides: 24 element strides, the batch, head and sequence strides of q,
// k, v, o, dO, dq, dk and dv in that order (the [B, H, S, dh] index order;
// the stride along dh is 1).  D: [B, Hq, Sq] f32 scratch.  prefix: under a
// causal mask keys below it are seen by every row (0: none; negative
// refused).  route: 0 the
// SIMT kernels (f32 or bf16), 1 the tensor-core kernels (bf16 at head dims
// 64, 128 and 256, bases and strides 16-byte aligned; kernels/
// flash_attention.py `bwd_route` checks this before the launch).  groups:
// the blocks each GQA group's query heads are split over in the dK/dV
// kernel, 1 except on route 1 at head dim 256, where groups > 1 needs
// `part`, f32 scratch of 2 x groups x B x Hkv x Skv x dh.  Launches the
// dQ kernel, then the dK/dV kernel (and the groups' sum), on `stream`;
// returns cudaGetLastError() (cudaErrorInvalidValue for a head dim without
// an instantiation: 16, 32, 64, 128 and 256 on SIMT, 64, 128 and 256 on
// mma; a route the dtype does not take; or groups that do not divide the
// GQA group).
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dO, const float* lse,
                        float* D, void* dq, void* dk, void* dv, int B, int Hq,
                        int Hkv, int Sq, int Skv, int dh, int dtype,
                        const long long* strides, float scale, int causal,
                        int window, int prefix, int route, int groups,
                        float* part, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Sq <= 0 || Skv <= 0) return 0;
  if (Hq % Hkv != 0 || prefix < 0 ||
      (route != ROUTE_SIMT && route != ROUTE_MMA))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return run<__nv_bfloat16>(q, k, v, o, dO, lse, D, dq, dk, dv, B, Hq, Hkv,
                              Sq, Skv, dh, strides, scale, causal, window,
                              prefix, route, groups, part, s);
  if (dtype == DT_F32)
    return run<float>(q, k, v, o, dO, lse, D, dq, dk, dv, B, Hq, Hkv, Sq, Skv,
                      dh, strides, scale, causal, window, prefix, route,
                      groups, part, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
