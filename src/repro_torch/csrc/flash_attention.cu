// Flash attention forward: blocked online softmax, positional masks.
//
// Replaces the Pallas kernel of the JAX package's
// kernels/flash_attention.py: `flash_attention` (`_flash_kernel`).
//
//   q [B, Hq, Sq, dh], k/v [B, Hkv, Skv, dh] (bf16 | f32, any strides with
//   a unit stride along dh) -> o [B, Hq, Sq, dh] in q's dtype.
//   scores scaled by 1/sqrt(dh); running max m and denominator l in f32;
//   masked entries are -1e30 (as in the Pallas body); out = acc / max(l, 1e-30).
//   Given a non-null `lse` [B, Hq, Sq] f32, both routes also write each
//   row's log-sum-exp m + log l in natural units, which the backward
//   (flash_attention_bwd.cu) recomputes P from; serving passes null.  A row
//   without any key writes -1e30 (its sum of exp(-1e30) terms), as the plain
//   version does.
//   Masks are positional from 0 on both sides: causal k <= q, or k < prefix
//   (the prefix-LM's bidirectional prefix; 0 for none), then window
//   k > q - window on top.  GQA reads kv head h / (Hq / Hkv); grouped K/V
//   are never materialized.  Any Sq and Skv: the ragged edge is masked here
//   (the Pallas divisibility assert is a TPU tiling artefact).
//
// Bound on the card: at the main path's shape (B=4, H=20, S=512, dh=128,
// causal, bf16) one call needs ~5.4 GFLOP (~5.4 us at 989 TFLOP/s bf16)
// and moves ~21 MB (~6.3 us at 3.35 TB/s), so its bound is the bytes.
//
// Two routes, chosen by the caller before the launch (kernels/
// flash_attention.py `route`), never by a failure:
// * "mma" (bf16 whose bases and strides are 16-byte aligned, every head
//   dim built): `mma::flash_fwd_mma`, both products on the bf16 tensor
//   cores with K/V streamed by cp.async (its own comment below).
// * "simt" (f32, and bf16 that cp.async cannot load 16 bytes at a time):
//   `flash_fwd`.  One 256-thread block per (q tile of 64
//   rows, head, batch); the Q tile and each 64-key K/V tile are staged in
//   shared memory as f32, and both products run on the f32 pipes with a
//   4x4 (QK^T) and 4x(dh/16) (PV) register tile per thread, which holds f32
//   inputs to the 2e-4 contract that TF32 tensor cores would break; q is
//   pre-scaled by 1/sqrt(dh) in f32.  At head dim 256 its tiles take
//   213,760 B of shared memory (the opt-in limit is 232,448 B).
// Both skip kv tiles wholly above the causal diagonal and past the prefix
// (`causal_end`) or wholly left of the window (unless a row of the block has
// no key: `first_tile`), and schedule q tiles heaviest first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_ptx.cuh"

namespace {

enum { DT_F32 = 0, DT_BF16 = 1 };
enum { ROUTE_SIMT = 0, ROUTE_MMA = 1 };

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

// The end of the kv tiles a block of query rows .. q_last sees under a causal
// mask: the tile past its last row's key, or past the prefix's last key
// where the prefix reaches further (capped at the n_tiles there are).
__device__ __forceinline__ int causal_end(int q_last, int prefix, int n_tiles,
                                          int tile) {
  return min(n_tiles, max(q_last, prefix - 1) / tile + 1);
}

// The first kv tile of a block of query rows q_first .. q_last: the tile
// of the first row's window start, or tile 0 when some row of the block
// has no key at all (q - window + 1 >= Skv).  Such a row scores every key
// kMasked, so its softmax is the mean of V over all Skv keys, as in the
// plain version, and the block must visit every tile; the rows of the
// block that do have keys drop those tiles' weights when their first
// unmasked score arrives (the running max rescales them by
// exp(-1e30 - m) = 0).  A prefix changes neither: the window still bounds
// every row's keys from below.
__device__ __forceinline__ int first_tile(int q_first, int q_last, int Skv,
                                          int window, int tile) {
  if (window <= 0 || q_last - window + 1 >= Skv) return 0;
  return max(q_first - window + 1, 0) / tile;
}

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (DH + 1) + kBK * (DH + 1) + kBK * DH + kBQ * (kBK + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
          int Hq, int Hkv, int Sq, int Skv, Strides qs, Strides ks,
          Strides vs, Strides os, float scale, int causal, int window,
          int prefix) {
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
  if (causal)
    kt_end = causal_end(min(q0 + kBQ, Sq) - 1, prefix, kt_end, kBK);
  const int kt_begin =
      first_tile(q0, min(q0 + kBQ, Sq) - 1, Skv, window, kBK);

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
        if (causal) keep = keep && (kj <= qi || kj < prefix);
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
    // m is in natural units here (q carries the scale); a row without a key
    // has m = -1e30, and -1e30 + log(Skv) rounds to -1e30
    if (lse != nullptr && tx == 0)
      lse[(static_cast<long long>(bb) * Hq + h) * Sq + qi] =
          m[i] + logf(l[i]);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Hq, int Hkv, int Sq, int Skv, Strides qs, Strides ks,
           Strides vs, Strides os, float scale, int causal, int window,
           int prefix, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_fwd<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Hq, Hkv, Sq, Skv, qs,
      ks, vs, os, scale, causal, window, prefix);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------- bf16 on the tensor cores (mma)
//
// FlashAttention-2's shape on mma.sync.m16n8k16 (bf16 in, f32 sums): one
// block of 4 warps per 64 query rows of one (batch, head); each warp owns 16
// rows.  Q is staged once in shared memory and, for head dims up to 128,
// held in registers as A fragments (ldmatrix); at 256 it is read again from
// shared memory each tile, which keeps the 16 x 256 f32 output block (128
// registers a thread) clear of spills.  K and V tiles of 64 keys (32 at
// head dim 256) stream through a double-buffered cp.async ring, rows
// XOR-swizzled in 16-byte chunks so that ldmatrix reads them without bank
// conflicts.  S = Q K^T sums in f32; the scale 1/sqrt(dh) (times log2 e,
// for exp2) is applied to S in f32, so q is never rounded again.  The
// masks and the online softmax run on the S fragments in registers (row
// max and sum across the 4 lanes of a quad); P is rounded to bf16 in
// registers, where S's accumulator layout is already P V's A fragment,
// and V's B fragments come from ldmatrix.trans.  Rounding P to bf16
// departs from the Pallas kernel's f32 P x V, as every fast flash kernel
// does: the bf16 contract is 5e-2 absolute against the plain version.
namespace mma {

using namespace ptx;

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;  // query rows per block
constexpr int kThreadsMma = 32 * kWarps;

template <int DH>
struct Cfg {
  static constexpr int BK = DH == 256 ? 32 : 64;  // keys per kv tile
  static constexpr bool QREG = DH <= 128;         // Q fragments in registers
  static constexpr int NCH = DH / 8;              // 16-byte chunks in a row
  static constexpr int MASK = (NCH < 8 ? NCH : 8) - 1;
  static constexpr int SMEM = (kRows + 4 * BK) * DH * 2;  // Q + 2 x (K, V)
};

// Element offset of 16-byte chunk c of row r in a [rows][DH] tile.
template <int DH>
__device__ __forceinline__ int swz(int r, int c) {
  return r * DH + ((c ^ (r & Cfg<DH>::MASK)) << 3);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = pack2(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows row0 .. row0 + ROWS - 1 of a [S, DH] slab with row stride `stride`
// into a swizzled tile; rows at or past S are zero-filled.
template <int DH, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int row0, int S) {
  constexpr int NCH = Cfg<DH>::NCH;
#pragma unroll
  for (int n = 0; n < (ROWS * NCH + kThreadsMma - 1) / kThreadsMma; ++n) {
    const int i = threadIdx.x + n * kThreadsMma;
    if (ROWS * NCH % kThreadsMma != 0 && i >= ROWS * NCH) break;
    const int r = i / NCH, c = i % NCH;
    const bool ok = row0 + r < S;
    const __nv_bfloat16* g =
        ok ? src + static_cast<long long>(row0 + r) * stride + c * 8 : src;
    cp_async16(dst + swz<DH>(r, c), g, ok);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreadsMma)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int Hq,
              int Hkv, int Sq, int Skv, Strides qs, Strides ks, Strides vs,
              Strides os, float scale_log2, int causal, int window,
              int prefix) {
  using Cf = Cfg<DH>;
  constexpr int BK = Cf::BK;
  constexpr int NB = BK / 8;   // n8 blocks of keys in S
  constexpr int ND = DH / 8;   // n8 blocks of dh in O
  constexpr int KQ = DH / 16;  // k16 slices of dh in Q K^T
  extern __shared__ __align__(128) uint8_t smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kRows * DH;  // [2][BK][DH]
  __nv_bfloat16* Vs = Ks + 2 * BK * DH;  // [2][BK][DH]

  const int n_qt = (Sq + kRows - 1) / kRows;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kRows;
  const int h = blockIdx.y;
  const int bb = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const __nv_bfloat16* qp = q + bb * qs.b + h * qs.h;
  const __nv_bfloat16* kp = k + bb * ks.b + hk * ks.h;
  const __nv_bfloat16* vp = v + bb * vs.b + hk * vs.h;
  __nv_bfloat16* op = o + bb * os.b + h * os.h;

  int kt_end = (Skv + BK - 1) / BK;
  if (causal)
    kt_end = causal_end(min(q0 + kRows, Sq) - 1, prefix, kt_end, BK);
  const int kt_begin =
      first_tile(q0, min(q0 + kRows, Sq) - 1, Skv, window, BK);

  load_tile<DH, kRows>(Qs, qp, qs.s, q0, Sq);
  cp_commit();
  if (kt_begin < kt_end) {
    load_tile<DH, BK>(Ks, kp, ks.s, kt_begin * BK, Skv);
    load_tile<DH, BK>(Vs, vp, vs.s, kt_begin * BK, Skv);
  }
  cp_commit();
  cp_wait<1>();  // Q has landed
  __syncthreads();

  // Q's A fragments: rows warp*16 + lane%16, 16-byte chunk 2 kk + lane/16.
  const int qrow = warp * 16 + (lane & 15);
  uint32_t qf[Cf::QREG ? KQ : 1][4];
  if constexpr (Cf::QREG) {
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk)
      ldsm_x4(qf[kk], Qs + swz<DH>(qrow, 2 * kk + (lane >> 4)));
  }

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
  float m[2] = {kMasked, kMasked};  // running max, log2 units
  float l[2] = {0.f, 0.f};          // this lane's part of the denominator
  // this lane's rows in S / O: r and r + 8
  const int r0 = q0 + warp * 16 + (lane >> 2);

  for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
    const int st = it & 1;
    if (kt + 1 < kt_end) {
      load_tile<DH, BK>(Ks + (st ^ 1) * BK * DH, kp, ks.s, (kt + 1) * BK,
                        Skv);
      load_tile<DH, BK>(Vs + (st ^ 1) * BK * DH, vp, vs.s, (kt + 1) * BK,
                        Skv);
    }
    cp_commit();
    cp_wait<1>();  // tile kt has landed
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + st * BK * DH;
    const __nv_bfloat16* Vt = Vs + st * BK * DH;

    // S = Q K^T: K rows are keys, so ldmatrix (no .trans) gives B
    // fragments; lanes 0-7 / 8-15 / 16-23 / 24-31 address keys n0 + 0-7
    // (chunks 2kk, 2kk+1) and n0 + 8-15 (chunks 2kk, 2kk+1).
    float s[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t a[4];
      if constexpr (Cf::QREG) {
#pragma unroll
        for (int x = 0; x < 4; ++x) a[x] = qf[kk][x];
      } else {
        ldsm_x4(a, Qs + swz<DH>(qrow, 2 * kk + (lane >> 4)));
      }
#pragma unroll
      for (int nb = 0; nb < NB / 2; ++nb) {
        uint32_t b[4];
        ldsm_x4(b, Kt + swz<DH>(nb * 16 + (lane & 7) + ((lane >> 4) << 3),
                                2 * kk + ((lane >> 3) & 1)));
        mma16816(s[2 * nb], a, b[0], b[1]);
        mma16816(s[2 * nb + 1], a, b[2], b[3]);
      }
    }

    // Scale, mask, online softmax.  s[j][c]: row r0 + 8 (c >> 1), key
    // k0 + 8 j + 2 (lane & 3) + (c & 1).  A tile wholly inside the prefix
    // is full under the causal mask even above the diagonal.
    const int k0 = kt * BK;
    const bool edge = (causal && k0 + BK - 1 > q0 && k0 + BK > prefix) ||
                      (window > 0 && k0 <= q0 + kRows - 1 - window) ||
                      k0 + BK > Skv;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[j][c] * scale_log2;
        if (edge) {
          const int kj = k0 + 8 * j + 2 * (lane & 3) + (c & 1);
          const int qi = r0 + 8 * (c >> 1);
          if (kj >= Skv)
            x = -INFINITY;  // ragged edge: no weight
          else if ((causal && kj > qi && kj >= prefix) ||
                   (window > 0 && kj <= qi - window))
            x = kMasked;    // the Pallas body's mask
        }
        s[j][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = exp2f(s[j][c] - m[c >> 1]);
        s[j][c] = p;
        l[c >> 1] += p;
      }
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] *= alpha[c >> 1];

    // O += P V: P's A fragment for keys 16 kb .. 16 kb + 15 is S blocks
    // 2 kb and 2 kb + 1; V rows are keys, so ldmatrix.trans gives B
    // fragments; lanes address keys 16 kb + 0-7 / 8-15 (chunk 2 db) and
    // 16 kb + 0-7 / 8-15 (chunk 2 db + 1).
#pragma unroll
    for (int kb = 0; kb < BK / 16; ++kb) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kb][0], s[2 * kb][1]),
                              pack_bf16(s[2 * kb][2], s[2 * kb][3]),
                              pack_bf16(s[2 * kb + 1][0], s[2 * kb + 1][1]),
                              pack_bf16(s[2 * kb + 1][2], s[2 * kb + 1][3])};
#pragma unroll
      for (int db = 0; db < ND / 2; ++db) {
        uint32_t b[4];
        ldsm_x4_t(b, Vt + swz<DH>(kb * 16 + (lane & 15), 2 * db + (lane >> 4)));
        mma16816(acc[2 * db], pa, b[0], b[1]);
        mma16816(acc[2 * db + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with stage st before it refills
  }

  // out = acc / max(l, 1e-30), l summed across the quad, rows < Sq.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + 8 * i;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = op + qi * os.s + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(__fdiv_rn(acc[j][2 * i], denom),
                                __fdiv_rn(acc[j][2 * i + 1], denom));
    // m is in log2 units: lse = (m + log2 l) ln 2.  The mask value is -1e30
    // in those units too, so a row without a key (m = -1e30) writes -1e30,
    // the natural-unit sum the plain version and the SIMT route give.
    if (lse != nullptr && (lane & 3) == 0)
      lse[(static_cast<long long>(bb) * Hq + h) * Sq + qi] =
          m[i] == kMasked ? kMasked
                          : (m[i] + log2f(l[i])) * 0.6931471805599453f;
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Hq, int Hkv, int Sq, int Skv, Strides qs, Strides ks,
           Strides vs, Strides os, float scale, int causal, int window,
           int prefix, cudaStream_t stream) {
  constexpr int smem = Cfg<DH>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kRows - 1) / kRows, Hq, B);
  flash_fwd_mma<DH><<<grid, kThreadsMma, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale * 1.4426950408889634f,
      causal, window, prefix);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mma

// ROUTE_MMA launches mma::launch<DH> (bf16 only), ROUTE_SIMT launch<T, DH>.
template <typename T>
int dispatch_dh(int route, int dh, const void* q, const void* k,
                const void* v, void* o, float* lse, int B, int Hq, int Hkv,
                int Sq, int Skv, Strides qs, Strides ks, Strides vs,
                Strides os, float scale, int causal, int window, int prefix,
                cudaStream_t stream) {
#define FLASH_CASE(DH)                                                     \
  case DH:                                                                 \
    return route == ROUTE_MMA                                              \
               ? mma::launch<DH>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, qs,  \
                                 ks, vs, os, scale, causal, window, prefix, \
                                 stream)                                   \
               : launch<T, DH>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, qs,    \
                               ks, vs, os, scale, causal, window, prefix,   \
                               stream);
  switch (dh) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    FLASH_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_CASE
}

}  // namespace

extern "C" {

// Strides are in elements, for the [B, H, S, dh] index order.  lse: null,
// or [B, Hq, Sq] f32 for each row's log-sum-exp.  prefix: under a causal
// mask keys below it are seen by every row (0: none; negative refused).
// route: 0
// the SIMT kernel (f32 or bf16), 1 the tensor-core kernel (bf16, bases and
// strides 16-byte aligned; kernels/flash_attention.py `route` checks this
// before the launch).  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a head dim without an instantiation: 16, 32,
// 64, 128 and 256 are built; or a route the dtype does not take).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int Hq, int Hkv, int Sq, int Skv,
                        int dh, int dtype, long long qsb, long long qsh,
                        long long qss,
                        long long ksb, long long ksh, long long kss,
                        long long vsb, long long vsh, long long vss,
                        long long osb, long long osh, long long oss,
                        float scale, int causal, int window, int prefix,
                        int route, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || Hq <= 0 || Sq <= 0 || Skv <= 0) return 0;
  if ((route != ROUTE_SIMT && route != ROUTE_MMA) || prefix < 0 ||
      (route == ROUTE_MMA && dtype != DT_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return dispatch_dh<__nv_bfloat16>(route, dh, q, k, v, o, lse, B, Hq, Hkv,
                                      Sq, Skv, qs, ks, vs, os, scale, causal,
                                      window, prefix, s);
  return dispatch_dh<float>(route, dh, q, k, v, o, lse, B, Hq, Hkv, Sq, Skv,
                            qs, ks, vs, os, scale, causal, window, prefix, s);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
