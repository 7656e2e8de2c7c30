// WKV6 recurrence of RWKV6 ("Finch"): forward and backward.
//
// Replaces the Pallas kernel `wkv6` (`_wkv6_kernel`) of the JAX package's
// kernels/rwkv6.py, a chunked reformulation for the TPU's matrix unit, and
// the autodiff of models/rwkv.py::wkv6_chunked.  Both routes compute the
// step-by-step recurrence of models/rwkv.py::wkv6_scan, per (batch, head),
// with the state S [dh, dh] in f32:
//
//   o_t[j]    = sum_i r_t[i] (S_{t-1}[i][j] + u[i] k_t[i] v_t[j])
//   S_t[i][j] = w_t[i] S_{t-1}[i][j] + k_t[i] v_t[j],     w_t = exp(logw_t)
//
// Layouts (all contiguous): r, k, v, out, dout, dr, dk, dv [B, T, H, dh]
// (bf16 | f32, one type for all); logw, dlogw [B, T, H, dh] f32; u [H, dh]
// f32; s0, sT, dsT, ds0 [B, H, dh, dh] f32, element (i, j) = S[i][j].
// The decay enters as log w so that its gradient is d log w, which stays
// finite where w underflows (dw = dlogw / w would not).
//
// Two routes, chosen by the caller before the launch (kernels/rwkv6.py
// `route`), never by a failure:
// * "chunked" (bf16 r/k/v at dh 64, 16-byte aligned bases): the chunked
//   form on the bf16 tensor cores, namespace `chunked` below (its own note).
// * "simt" (f32 under the 1e-4 contract, and bf16 at dh 16 and 32): the
//   step-by-step scan on the f32 pipes, described next.
//
// SIMT forward: one CTA per (b, h).  Each state column j belongs to SPLIT = 4
// neighbouring threads, each keeping dh/4 of its rows in registers (rows
// i = 4*ii + part, so the four read four neighbouring shared words); the
// column's output is their sum, two shuffles.  The inputs are staged in
// shared memory a chunk of steps at a time (r, k, w, u packed per row as
// one float4), double-buffered: one barrier per chunk, and the next
// chunk's loads are in flight while this chunk computes, so the loop over
// t -- the Pallas kernel's sequential grid axis -- never waits on device
// memory.  Any T (the last chunk is masked), dh in {16, 32, 64}.
//
// SIMT backward: the adjoint state dS_{t-1} = diag(w_t) dS_t + r_t do_t^T runs
// backwards from dS_T = dsT (or 0).  Three independent passes, one CTA
// each per (b, h) (grid.y = pass), all in one launch, staged as above:
//   pass 0, forward in time, state by rows (row i on 4 threads):
//           dr_t[i] = sum_j S_{t-1}[i][j] do_t[j] + u[i] k_t[i] (v_t . do_t)
//           du[i]  += r_t[i] k_t[i] (v_t . do_t)        (partial per b)
//           P_t[i]  = r_t[i] sum_j S_{t-1}[i][j] do_t[j],  F[i] = dsT[i] . S_T[i]
//   pass 1, reverse, adjoint by rows:
//           dk_t[i] = sum_j dS_t[i][j] v_t[j] + r_t[i] u[i] (v_t . do_t)
//           Q_t[i]  = k_t[i] sum_j dS_t[i][j] v_t[j];   ds0 = dS_0
//   pass 2, reverse, adjoint by columns:
//           dv_t[j] = sum_i k_t[i] dS_t[i][j] + do_t[j] sum_i r_t[i] u[i] k_t[i]
// then a second kernel, one thread per (b, h, i), turns P and Q into the
// decay's gradient by the cumulative-log-decay identity (the u-bonus
// diagonal excluded, which is why P and Q hold only the state terms):
//   dlogw_m[i] = sum_{t>m} P_t[i] - sum_{t>=m} Q_t[i] + F[i]
// No state is stored per step.
//
// The SIMT route is bound by f32 operations: ~5 per state element per
// step forward, ~12 backward; it is sequential in t, with B*H CTAs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_ptx.cuh"

namespace {

enum { DT_F32 = 0, DT_BF16 = 1 };
enum { ROUTE_SIMT = 0, ROUTE_CHUNKED = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int SPLIT = 4;       // threads per state column (row)
constexpr int CHUNK = 8;       // steps staged in shared memory at once
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float group_sum(float x) {  // over SPLIT lanes
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

// One chunk of C steps of the inputs, staged through registers: thread
// tid holds elements e = tid + m * NT, i.e. step e / DH, column e % DH.
template <typename T, int DH, int C, bool GRAD>
struct Chunk {
  static constexpr int NT = DH * SPLIT, E = C * DH / NT;
  float r[E], k[E], lw[E], v[E], d[E];

  __device__ void load(const T* rp, const T* kp, const T* vp,
                       const float* lwp, const T* dp, size_t base,
                       size_t stride, int t0, int tlen, int tid) {
#pragma unroll
    for (int m = 0; m < E; ++m) {
      const int e = tid + m * NT, t = t0 + e / DH;
      if (t < tlen) {
        const size_t off = base + t * stride + e % DH;
        r[m] = to_f32(rp[off]); k[m] = to_f32(kp[off]);
        v[m] = to_f32(vp[off]); lw[m] = lwp[off];
        if (GRAD) d[m] = to_f32(dp[off]);
      } else {                   // past the end: w = 1, nothing else
        r[m] = k[m] = v[m] = lw[m] = 0.f;
        if (GRAD) d[m] = 0.f;
      }
    }
  }

  // rkwu[c][i] = (r, k, w, u) of row i at step c; vd[c][j] = (v, do).
  __device__ void store(float4 (*rkwu)[DH], float2 (*vd)[DH],
                        const float* u, int tid) const {
#pragma unroll
    for (int m = 0; m < E; ++m) {
      const int e = tid + m * NT, c = e / DH, col = e % DH;
      rkwu[c][col] = make_float4(r[m], k[m], expf(lw[m]), u[col]);
      vd[c][col] = make_float2(v[m], GRAD ? d[m] : 0.f);
    }
  }
};

// ------------------------------------------------------------------ forward

template <typename T, int DH>
__global__ void __launch_bounds__(DH * SPLIT)
wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ logw,
                const float* __restrict__ u, const float* __restrict__ s0,
                T* __restrict__ out, float* __restrict__ s_out, int tlen,
                int heads) {
  constexpr int C = CHUNK, R = DH / SPLIT;
  __shared__ float4 rkwu[2][C][DH];
  __shared__ float2 vd[2][C][DH];
  const int bh = blockIdx.x, b = bh / heads, h = bh % heads;
  const int tid = threadIdx.x, j = tid / SPLIT, part = tid % SPLIT;
  const size_t stride = static_cast<size_t>(heads) * DH;
  const size_t base = (static_cast<size_t>(b) * tlen * heads + h) * DH;
  const size_t sbase = static_cast<size_t>(bh) * DH * DH;
  const float* uh = u + h * DH;
  float S[R];                        // S[ii * SPLIT + part][j]
#pragma unroll
  for (int ii = 0; ii < R; ++ii)
    S[ii] = s0 ? s0[sbase + (ii * SPLIT + part) * DH + j] : 0.f;

  Chunk<T, DH, C, false> st;
  const int nchunks = (tlen + C - 1) / C;
  if (nchunks > 0) {
    st.load(r, k, v, logw, nullptr, base, stride, 0, tlen, tid);
    st.store(rkwu[0], vd[0], uh, tid);
  }
  __syncthreads();
  for (int ci = 0; ci < nchunks; ++ci) {
    const int buf = ci & 1, t0 = ci * C;
    if (ci + 1 < nchunks)            // the next chunk's loads in flight
      st.load(r, k, v, logw, nullptr, base, stride, t0 + C, tlen, tid);
    const int steps = min(C, tlen - t0);
    for (int c = 0; c < steps; ++c) {
      const float vj = vd[buf][c][j].x;
      float o = 0.f;
#pragma unroll
      for (int ii = 0; ii < R; ++ii) {
        const float4 q = rkwu[buf][c][ii * SPLIT + part];  // r k w u
        const float kv = q.y * vj;
        o = fmaf(q.x, fmaf(q.w, kv, S[ii]), o);
        S[ii] = fmaf(q.z, S[ii], kv);
      }
      o = group_sum(o);
      if (part == 0) out[base + (t0 + c) * stride + j] = from_f32<T>(o);
    }
    if (ci + 1 < nchunks) st.store(rkwu[buf ^ 1], vd[buf ^ 1], uh, tid);
    __syncthreads();
  }
#pragma unroll
  for (int ii = 0; ii < R; ++ii)
    s_out[sbase + (ii * SPLIT + part) * DH + j] = S[ii];
}

// ----------------------------------------------------------------- backward

struct BwdArgs {
  const void *r, *k, *v, *dout;
  const float *logw, *u, *s0, *ds_t;
  void *dr, *dk, *dv;
  float *du_part, *ds0, *p, *q, *f;
  int tlen, heads;
};

template <typename T, int DH>
__global__ void __launch_bounds__(DH * SPLIT) wkv6_bwd_kernel(BwdArgs a) {
  constexpr int C = CHUNK, R = DH / SPLIT;
  __shared__ float4 rkwu[2][C][DH];
  __shared__ float2 vd[2][C][DH];
  const T* r = static_cast<const T*>(a.r);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
  const int tid = threadIdx.x, x = tid / SPLIT, part = tid % SPLIT;
  const int tlen = a.tlen, pass = blockIdx.y;
  const bool forward = pass == 0;
  const size_t stride = static_cast<size_t>(a.heads) * DH;
  const size_t base = (static_cast<size_t>(b) * tlen * a.heads + h) * DH;
  const size_t sbase = static_cast<size_t>(bh) * DH * DH;
  const float* uh = a.u + h * DH;
  // passes 0, 1: row x, columns jj * SPLIT + part; pass 2: column x, rows
  // ii * SPLIT + part.  M holds S (pass 0) or dS (passes 1, 2).
  float M[R];
  const float* init = forward ? a.s0 : a.ds_t;
#pragma unroll
  for (int n = 0; n < R; ++n) {
    const int y = n * SPLIT + part;
    M[n] = init ? init[sbase + (pass == 2 ? y * DH + x : x * DH + y)] : 0.f;
  }
  float du = 0.f;

  Chunk<T, DH, C, true> st;
  const int nchunks = (tlen + C - 1) / C;
  auto chunk_of = [&](int it) { return forward ? it : nchunks - 1 - it; };
  if (nchunks > 0) {
    st.load(r, k, v, a.logw, dout, base, stride, chunk_of(0) * C, tlen, tid);
    st.store(rkwu[0], vd[0], uh, tid);
  }
  __syncthreads();
  for (int it = 0; it < nchunks; ++it) {
    const int buf = it & 1, t0 = chunk_of(it) * C;
    if (it + 1 < nchunks)
      st.load(r, k, v, a.logw, dout, base, stride, chunk_of(it + 1) * C,
              tlen, tid);
    const int steps = min(C, tlen - t0);
    for (int s = 0; s < steps; ++s) {
      const int c = forward ? s : steps - 1 - s;
      const size_t off = base + (t0 + c) * stride + x;
      if (pass == 2) {
        const float2 mine = vd[buf][c][x];                 // v_j, do_j
        float acc = 0.f, ruk = 0.f;
#pragma unroll
        for (int ii = 0; ii < R; ++ii) {
          const float4 q = rkwu[buf][c][ii * SPLIT + part];  // r k w u
          acc = fmaf(q.y, M[ii], acc);
          ruk = fmaf(q.x * q.w, q.y, ruk);
          M[ii] = fmaf(q.z, M[ii], q.x * mine.y);
        }
        acc = group_sum(acc);
        ruk = group_sum(ruk);
        if (part == 0)
          static_cast<T*>(a.dv)[off] = from_f32<T>(fmaf(mine.y, ruk, acc));
      } else {
        const float4 me = rkwu[buf][c][x];                 // row x: r k w u
        float acc = 0.f, vdo = 0.f;
#pragma unroll
        for (int jj = 0; jj < R; ++jj) {
          const float2 q = vd[buf][c][jj * SPLIT + part];  // v_j, do_j
          vdo = fmaf(q.x, q.y, vdo);
          if (forward) {
            acc = fmaf(M[jj], q.y, acc);
            M[jj] = fmaf(me.z, M[jj], me.y * q.x);
          } else {
            acc = fmaf(M[jj], q.x, acc);
            M[jj] = fmaf(me.z, M[jj], me.x * q.y);
          }
        }
        acc = group_sum(acc);
        vdo = group_sum(vdo);
        if (forward) {
          du = fmaf(me.x * me.y, vdo, du);
          if (part == 0) {
            static_cast<T*>(a.dr)[off] =
                from_f32<T>(fmaf(me.w * me.y, vdo, acc));
            a.p[off] = me.x * acc;
          }
        } else if (part == 0) {
          static_cast<T*>(a.dk)[off] =
              from_f32<T>(fmaf(me.x * me.w, vdo, acc));
          a.q[off] = me.y * acc;
        }
      }
    }
    if (it + 1 < nchunks) st.store(rkwu[buf ^ 1], vd[buf ^ 1], uh, tid);
    __syncthreads();
  }
  if (pass == 0) {
    float f = 0.f;
    if (a.ds_t) {
#pragma unroll
      for (int jj = 0; jj < R; ++jj)
        f = fmaf(a.ds_t[sbase + x * DH + jj * SPLIT + part], M[jj], f);
    }
    f = group_sum(f);
    if (part == 0) {
      a.f[bh * DH + x] = f;
      a.du_part[bh * DH + x] = du;
    }
  } else if (pass == 1 && a.ds0) {
#pragma unroll
    for (int jj = 0; jj < R; ++jj)
      a.ds0[sbase + x * DH + jj * SPLIT + part] = M[jj];
  }
}

// dlogw_m = sum_{t>m} P_t - sum_{t>=m} Q_t + F, one thread per (b, h, i),
// the suffix sums in f64.
__global__ void __launch_bounds__(256)
wkv6_dlogw_kernel(const float* __restrict__ p, const float* __restrict__ q,
                  const float* __restrict__ f, float* __restrict__ dlogw,
                  int lanes, int tlen, int heads, int dh) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const int i = lane % dh, bh = lane / dh, b = bh / heads, h = bh % heads;
  const size_t stride = static_cast<size_t>(heads) * dh;
  const size_t base = (static_cast<size_t>(b) * tlen * heads + h) * dh + i;
  const double fi = f[lane];
  double run_p = 0.0, run_q = 0.0;
#pragma unroll 16
  for (int t = tlen - 1; t >= 0; --t) {
    const size_t off = base + t * stride;
    run_q += q[off];
    dlogw[off] = static_cast<float>(run_p - run_q + fi);
    run_p += p[off];
  }
}

template <typename T, int DH>
cudaError_t launch_fwd(const void* r, const void* k, const void* v,
                       const float* logw, const float* u, const float* s0,
                       void* out, float* s_out, int batch, int tlen,
                       int heads, cudaStream_t s) {
  wkv6_fwd_kernel<T, DH><<<batch * heads, DH * SPLIT, 0, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, s0, static_cast<T*>(out), s_out,
      tlen, heads);
  return cudaGetLastError();
}

// ------------------------------------- bf16 on the tensor cores ("chunked")
//
// The chunked form of the Pallas kernel, redesigned around the secondary
// chunking of gated linear attention kernels (Yang et al., "Gated Linear
// Attention Transformers with Hardware-Efficient Training", 2023): chunks
// of C = 64 steps, sub-chunks of 16.  With P_t the cumulative log-decay
// from the chunk's start (P_0 = 0, non-increasing in t, kept in log2 units
// in shared memory), every factor is e^{x} with x <= 0, so any decay is
// taken and exponents only underflow, to their true value 0:
//
//   state   S_out = diag(e^{P_C}) S_in + sum_j (k_j e^{P_C - P_{j+1}}) v_j^T
//   output  o_t = (r_t e^{P_t}) S_in + sum_{j<t} A[t][j] v_j
//                 + (r_t . (u * k_t)) v_t
//   A[t][j] = (r_t e^{P_t - P_s}) . (k_j e^{P_s - P_{j+1}}) for j before the
//             sub-chunk of t (s its start): one bf16 product on the tensor
//             cores; within the sub-chunk pairwise in f32 with
//             e^{P_t - P_{j+1}} <= 1.
//
// (The reference's single-level split around P_C / 2 overflows f32 once a
// chunk's |P_C| passes ~88; ROADMAP Queue 3, fault 7.)  Products run on
// mma.sync.m16n8k16 (bf16 in, f32 sums) from ldmatrix; tiles land by
// cp.async; each operand is rounded to bf16 once, after its decay factor
// is applied in f32.
//
// Parallelism.  Two kinds of kernel.  The state pass (`wkv6_state_kernel`)
// walks the chunks of one (b, h) in order, 80 CTAs at the training call,
// with two chunks of loads in flight (a 3-stage cp.async ring), and writes
// S at every chunk boundary to f32 scratch [B H, N + 1, dh, dh] (11.8 MB
// at the training call).  The output pass (`wkv6_out_kernel`) then runs
// one CTA per (chunk, h, b), 640 at the training call, each computing its
// [C, C] A once.  Chosen over CTAs that each walk the chunks for a tile of
// state columns (column j of S depends on v[:, j] alone): those recompute
// A and its ~45,000 exponentials once per column tile, and leave the whole
// of the work sequential along the chunks; here only the state's update is.
// The backward is the same pair: one launch of the state pass in both
// directions (grid.y: S forward from s0, the adjoint
//   dS_in = diag(e^{P_C}) dS_out + sum_t (r_t e^{P_t}) do_t^T
// in reverse from ds_T), then `wkv6_grad_kernel` per (chunk, h, b), 16
// warps: dr, dk, dv by the same two-level factors, du per chunk into
// partials [B N, H, dh] that the wrapper sums (no atomics, so the backward
// gives the same bits from run to run), and d log w by the identity of the
// SIMT backward taken inside the chunk,
//   dlogw_t = X_end + sum_{t'>t} r dr_state - sum_{t'>=t} k dk_state,
//   X_end[i] = sum_j dS_out[i][j] S_out[i][j],
// so nothing is carried across chunks.  Those two sums cancel to a small
// difference when the decay is strong, so the state terms of dr and dk take
// S_in and dS_out as a bf16 pair hi + lo (two products, f32 accuracy).
// Launches: 2 for the forward; 2 for the backward, and the wrapper's sum
// of du's partials.
//
// Bound on the card: bytes.  At the training call ([2, 512, 40, 64] bf16)
// the forward moves 32.8 MB (9.8 us at 3.35 TB/s) against 1.0 GFLOP of
// bf16 products (1.0 us at 989 TFLOP/s); the backward 57.7 MB (17 us)
// against 3.1 GFLOP (3.2 us).  The kernels stay well above it: the state
// pass is a chain of 8 chunk steps, and the gradient pass, at 197 KB of
// shared memory a CTA, holds one CTA an SM, so its loads and its pairwise
// f32 work (the diagonal blocks, ~60,000 exponentials a chunk) do not
// overlap; PERF.md section 6 has the times.
namespace chunked {

using namespace ptx;
using bf16 = __nv_bfloat16;
constexpr int C = 64;          // steps per chunk (the Pallas DEFAULT_CHUNK)
constexpr int SUB = 16;        // steps per sub-chunk
constexpr int NSUB = C / SUB;
constexpr int DH = 64;         // the head dim this route is built for
constexpr int NSTAGE = 3;      // chunks in flight in the state pass
constexpr int NT = 256;        // 8 warps: warp w owns the rows of sub-chunk
                               // w % 4 and, where it splits, half w / 4 of
                               // the columns
constexpr int NTG = 512;       // the gradient pass: 16 warps, w / 4 a quarter
constexpr int LD = DH + 8;     // bf16 tile row: 144 B, ldmatrix without conflicts
constexpr int LDP = DH + 4;    // f32 prefix row: 272 B
constexpr float LOG2E = 1.4426950408889634f;

// One warp: acc[n] += A[16 x 16 ks] B[16 ks x 8 n] for the first 2 np of
// the 2 NP n8 tiles.  A_KM: A is stored transposed, [k][m]; B_KN: B is
// stored [k][n] (else [n][k]).  `a` points at A's element (m 0, k 0) and
// `b` at B's (k 0, n 0), in tiles of row stride lda / ldb elements.
template <bool A_KM, bool B_KN, int NP>
__device__ __forceinline__ void gemm(float (&acc)[2 * NP][4], const bf16* a,
                                     int lda, const bf16* b, int ldb,
                                     int ksteps, int np) {
  const int lane = threadIdx.x & 31;
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t af[4];
    if (A_KM)
      ldsm_x4_t(af, a + (16 * ks + ((lane >> 4) << 3) + (lane & 7)) * lda +
                        (((lane >> 3) & 1) << 3));
    else
      ldsm_x4(af, a + (lane & 15) * lda + 16 * ks + ((lane >> 4) << 3));
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      if (p >= np) break;
      uint32_t bfr[4];
      if (B_KN)
        ldsm_x4_t(bfr, b + (16 * ks + (lane & 15)) * ldb + 16 * p +
                          ((lane >> 4) << 3));
      else
        ldsm_x4(bfr, b + (16 * p + (lane & 7) + ((lane >> 4) << 3)) * ldb +
                        16 * ks + (((lane >> 3) & 1) << 3));
      mma16816(acc[2 * p], af, bfr[0], bfr[1]);
      mma16816(acc[2 * p + 1], af, bfr[2], bfr[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[n][x] = 0.f;
}

// Rows t0 .. t0 + C - 1 of a [T, stride] slab (zero past tlen) into a
// [C][LDT] tile: NCH 16-byte chunks a row.  Any layout of 16-byte chunks.
template <int NCH, int LDT, int NTH = NT, typename E>
__device__ __forceinline__ void load_rows(E* dst, const E* src, size_t stride,
                                          int t0, int tlen) {
  constexpr int PER = 16 / sizeof(E);
  for (int e = threadIdx.x; e < C * NCH; e += NTH) {
    const int row = e / NCH, ch = e % NCH;
    const bool ok = t0 + row < tlen;
    cp_async16(dst + row * LDT + ch * PER,
               ok ? src + (t0 + row) * stride + ch * PER : src, ok);
  }
}

// p[0] = 0 and p[1 .. C] = log w of the chunk's rows become
// p[t] = log2(e) sum_{t' < t} log w_t', per channel: NTH / DH threads a
// channel scan their rows in registers and add the totals before them
// (`tot`, NTH floats of shared memory).
template <int NTH = NT>
__device__ __forceinline__ void prefix(float* p, float* tot) {
  constexpr int Q = NTH / DH, R = C / Q;
  const int i = threadIdx.x % DH, q = threadIdx.x / DH;
  float* col = p + (1 + R * q) * LDP + i;
  float x[R];
#pragma unroll
  for (int t = 0; t < R; ++t) x[t] = col[t * LDP];
#pragma unroll
  for (int t = 1; t < R; ++t) x[t] += x[t - 1];
  tot[q * DH + i] = x[R - 1];
  __syncthreads();
  float base = 0.f;
#pragma unroll
  for (int qq = 0; qq < Q - 1; ++qq)
    if (qq < q) base += tot[qq * DH + i];
#pragma unroll
  for (int t = 0; t < R; ++t) col[t * LDP] = (x[t] + base) * LOG2E;
  if (q == 0) p[i] = 0.f;
  __syncthreads();
}

// An f32 [DH][DH] state, this thread's share: fetched into registers at a
// kernel's start, put into shared memory where it is first needed, so that
// its loads run under the work in between.
template <int NTH = NT>
__device__ __forceinline__ void fetch_state(float4 (&x)[DH * DH / 4 / NTH],
                                            const float* src) {
  const float4* sg = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int m = 0; m < DH * DH / 4 / NTH; ++m) x[m] = sg[threadIdx.x + m * NTH];
}
template <int NTH = NT, typename F>
__device__ __forceinline__ void put_state(const float4 (&x)[DH * DH / 4 / NTH],
                                          F&& put) {
#pragma unroll
  for (int m = 0; m < DH * DH / 4 / NTH; ++m) {
    const int e = threadIdx.x + m * NTH;
    put(e / (DH / 4), 4 * (e % (DH / 4)), x[m]);
  }
}

// Sum over the TPR = NTH / C lanes of a row (neighbours in one warp).
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < TPR; o *= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Per step t = tid / TPR: sum_i x_t[i] y_t[i] z[i] (z null: 1), TPR
// threads a row.
template <int NTH = NT>
__device__ __forceinline__ float row_dot(const bf16* x, const bf16* y,
                                        const float* z) {
  constexpr int TPR = NTH / C, W = DH / TPR;
  const int t = threadIdx.x / TPR, i0 = W * (threadIdx.x % TPR);
  float acc = 0.f;
#pragma unroll
  for (int i = i0; i < i0 + W; i += 2) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(x + t * LD + i));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(y + t * LD + i));
    acc = fmaf(a.x * (z ? z[i] : 1.f), b.x, acc);
    acc = fmaf(a.y * (z ? z[i + 1] : 1.f), b.y, acc);
  }
  return row_sum<TPR>(acc);
}

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }
// 2^x for x <= 0 in one MUFU operation; results below 2^-126 flush to 0,
// as the true factors' contributions do at f32's precision.
__device__ __forceinline__ float exp2_neg(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float ex(const float* p, int a, int b, int i) {
  return exp2_neg(p[a * LDP + i] - p[b * LDP + i]);  // e^{P_a - P_b}, a >= b
}
// The same for channels i and i + 1 (i even), from two float2 loads.
__device__ __forceinline__ float2 ex2(const float* p, int a, int b, int i) {
  const float2 x = *reinterpret_cast<const float2*>(p + a * LDP + i);
  const float2 y = *reinterpret_cast<const float2*>(p + b * LDP + i);
  return make_float2(exp2_neg(x.x - y.x), exp2_neg(x.y - y.y));
}

// The pairwise 16 x 16 diagonal blocks of A (t > j in one sub-chunk) into
// the bf16 tile `am` [t][j], zeros on and above the diagonal:
// A[t][j] = sum_i r_t[i] k_j[i] e^{P_t[i] - P_{j+1}[i]}, in f32.
template <int NTH = NT>
__device__ __forceinline__ void diag_blocks(bf16* am, const bf16* r,
                                            const bf16* k, const float* p) {
  constexpr int PAIRS = SUB * (SUB - 1) / 2;
  for (int e = threadIdx.x; e < NSUB * PAIRS; e += NTH) {
    const int s = e / PAIRS;
    int mi = e % PAIRS, ti = 1;
    while (mi >= ti) mi -= ti++;
    const int t = SUB * s + ti, j = SUB * s + mi;
    const __nv_bfloat162* rr =
        reinterpret_cast<const __nv_bfloat162*>(r + t * LD);
    const __nv_bfloat162* kk =
        reinterpret_cast<const __nv_bfloat162*>(k + j * LD);
    const float2* pt = reinterpret_cast<const float2*>(p + t * LDP);
    const float2* pj = reinterpret_cast<const float2*>(p + (j + 1) * LDP);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i2 = 0; i2 < DH / 2; ++i2) {
      const float2 rf = __bfloat1622float2(rr[i2]);
      const float2 kf = __bfloat1622float2(kk[i2]);
      const float2 a = pt[i2], b = pj[i2];
      acc[i2 % 2] = fmaf(rf.x * kf.x, exp2_neg(a.x - b.x), acc[i2 % 2]);
      acc[2 + i2 % 2] = fmaf(rf.y * kf.y, exp2_neg(a.y - b.y), acc[2 + i2 % 2]);
    }
    am[t * LD + j] = __float2bfloat16_rn((acc[0] + acc[1]) + (acc[2] + acc[3]));
  }
  for (int e = threadIdx.x; e < NSUB * SUB * SUB; e += NTH) {
    const int s = e / (SUB * SUB), ti = (e / SUB) % SUB, mi = e % SUB;
    if (mi >= ti) am[(SUB * s + ti) * LD + SUB * s + mi] = __float2bfloat16_rn(0.f);
  }
}

// Rows of the key-side factors k_j e^{P_{s_a} - P_{j+1}}, j < s_a, for
// query sub-chunks a = 1, 2, 3: 16 + 32 + 48 rows from row kt_off(a).
__device__ __forceinline__ int kt_off(int a) { return SUB * a * (a - 1) / 2; }
// Rows of the query-side factors r_t e^{P_t - P_{e_b}}, t >= e_b = 16 (b + 1),
// for key sub-chunks b = 0, 1, 2: 48 + 32 + 16 rows from row rb_off(b).
__device__ __forceinline__ int rb_off(int b) {
  return b == 0 ? 0 : (b == 1 ? 48 : 80);
}
constexpr int KT_ROWS = 96;

// Every decayed operand of one chunk, each source row read once: thread
// (row j, channels i, i + 1) with P at the sub-chunk boundaries 0, 16, ..,
// 64 of its channels in registers.  s(j) is j's sub-chunk.
//   rt[j] = r_j e^{P_j - P_{16 s(j)}}
//   rs[j] = r_j e^{P_j}                                     (RS: forward)
//   kh[j] = k_j e^{P_C - P_{j+1}}                           (KH: backward)
//   kt[kt_off(a) + j] = k_j e^{P_{16 a} - P_{j+1}},  a > s(j)
//   rb[rb_off(b) + j - e_b] = r_j e^{P_j - P_{e_b}},  b < s(j)  (RB: backward)
template <int NTH, bool RS, bool KH, bool RB>
__device__ __forceinline__ void factors(const bf16* r, const bf16* k,
                                        const float* p, bf16* rt, bf16* rs,
                                        bf16* kt, bf16* kh, bf16* rb) {
  constexpr int STEP = NTH / (DH / 2);            // rows a pass: 8 or 16
  static_assert(STEP == 8 || STEP == 16, "a row's sub-chunk is m / (16 / STEP)");
  const int i = 2 * (threadIdx.x % (DH / 2)), j0 = threadIdx.x / (DH / 2);
  float2 pb[NSUB + 1], es[NSUB];
#pragma unroll
  for (int a = 0; a <= NSUB; ++a)
    pb[a] = *reinterpret_cast<const float2*>(p + SUB * a * LDP + i);
#pragma unroll
  for (int a = 0; a < NSUB; ++a)
    es[a] = make_float2(exp2_neg(pb[a].x), exp2_neg(pb[a].y));
  auto put = [](bf16* dst, float2 x, float2 f) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = pack2(x.x * f.x, x.y * f.y);
  };
  auto e2 = [](float2 hi, float2 lo) {
    return make_float2(exp2_neg(hi.x - lo.x), exp2_neg(hi.y - lo.y));
  };
#pragma unroll
  for (int m = 0; m < C / STEP; ++m) {
    const int j = j0 + STEP * m, sj = m / (SUB / STEP);
    const float2 pj = *reinterpret_cast<const float2*>(p + j * LDP + i);
    const float2 pj1 = *reinterpret_cast<const float2*>(p + (j + 1) * LDP + i);
    const float2 rf = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(r + j * LD + i));
    const float2 kf = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(k + j * LD + i));
    const float2 fq = e2(pj, pb[sj]);
    put(rt + j * LD + i, rf, fq);
    if (RS) put(rs + j * LD + i, rf, make_float2(fq.x * es[sj].x, fq.y * es[sj].y));
    if (KH) put(kh + j * LD + i, kf, e2(pb[NSUB], pj1));
#pragma unroll
    for (int a = sj + 1; a < NSUB; ++a)
      put(kt + (kt_off(a) + j) * LD + i, kf, e2(pb[a], pj1));
    if (RB) {
#pragma unroll
      for (int bb = 0; bb < sj; ++bb)
        put(rb + (rb_off(bb) + j - SUB * (bb + 1)) * LD + i, rf, e2(pj, pb[bb + 1]));
    }
  }
}

// ------------------------------------------------------------ state pass

struct StateArgs {
  const bf16* x[2];      // per direction: k (forward) or r (reverse)
  const bf16* y[2];      // v or dout
  const float* logw;
  const float* init[2];  // s0 or ds_T [B H, dh, dh], or null (zero)
  float* states[2];      // [B H, N + 1, dh, dh]: the state / adjoint at
                         // each chunk boundary
  float* last[2];        // s_T or ds0 [B H, dh, dh], or null
  int tlen, heads, nchunks;
};

constexpr int STAGE_BYTES = 2 * C * LD * 2 + (C + 1) * LDP * 4;
constexpr int STATE_SMEM = NSTAGE * STAGE_BYTES + 4 * DH * 4;

// One stage of the state pass: chunk c's x and y rows and log-decays.
__device__ __forceinline__ void load_stage(uint8_t* st, const bf16* xg,
                                           const bf16* yg, const float* lg,
                                           size_t stride, int c, int tlen) {
  load_rows<DH / 8, LD>(reinterpret_cast<bf16*>(st), xg, stride, c * C, tlen);
  load_rows<DH / 8, LD>(reinterpret_cast<bf16*>(st) + C * LD, yg, stride,
                        c * C, tlen);
  load_rows<DH / 4, LDP>(reinterpret_cast<float*>(st + 2 * C * LD * 2) + LDP,
                         lg, stride, c * C, tlen);
}

// The accumulators' rows and columns of the state into dst [DH][DH].
__device__ __forceinline__ void store_tile(float* dst, const float (&acc)[4][4],
                                           int row0, int col) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(dst + (row0 + 8 * hf) * DH + col + 8 * nt) =
          make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
}

// grid (B H, directions), NT threads: one (b, h), one direction, walking
// its chunks in order with NSTAGE - 1 chunks of loads in flight.  Warp w
// holds rows 16 (w % 4) .. + 15, columns 32 (w / 4) .. + 31 of the state
// in its accumulators.  x_hat overwrites x in its stage.
__global__ void __launch_bounds__(NT, 2) wkv6_state_kernel(StateArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* tot = reinterpret_cast<float*>(smem + NSTAGE * STAGE_BYTES);
  const int rev = blockIdx.y == 1, bh = blockIdx.x;
  const int b = bh / a.heads, h = bh % a.heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp % 4, wh = warp / 4;
  const int n = a.nchunks;
  const size_t stride = static_cast<size_t>(a.heads) * DH;
  const size_t base = (static_cast<size_t>(b) * a.tlen * a.heads + h) * DH;
  const bf16* xg = (rev ? a.x[1] : a.x[0]) + base;
  const bf16* yg = (rev ? a.y[1] : a.y[0]) + base;
  const float* lg = a.logw + base;
  float* out = (rev ? a.states[1] : a.states[0]) +
               static_cast<size_t>(bh) * (n + 1) * DH * DH;
  float* last = rev ? a.last[1] : a.last[0];

  const int row0 = 16 * wr + lane / 4, col = 32 * wh + 2 * (lane % 4);
  float acc[4][4];
  const float* init = rev ? a.init[1] : a.init[0];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      acc[nt][x] = init ? init[(static_cast<size_t>(bh) * DH + row0 + 8 * (x / 2)) * DH +
                               col + 8 * nt + x % 2]
                        : 0.f;
  // chunk of iteration it: rev ? n - 1 - it : it
#pragma unroll
  for (int it = 0; it < NSTAGE - 1; ++it) {
    if (it < n)
      load_stage(smem + it * STAGE_BYTES, xg, yg, lg, stride,
                 rev ? n - 1 - it : it, a.tlen);
    cp_commit();
  }
  for (int it = 0; it < n; ++it) {
    const int c = rev ? n - 1 - it : it;
    uint8_t* st = smem + (it % NSTAGE) * STAGE_BYTES;
    store_tile(out + static_cast<size_t>(rev ? c + 1 : c) * DH * DH, acc, row0, col);
    __syncthreads();                 // iteration it - 1 is done with its stage
    if (it + NSTAGE - 1 < n)
      load_stage(smem + ((it + NSTAGE - 1) % NSTAGE) * STAGE_BYTES, xg, yg, lg,
                 stride, rev ? c - (NSTAGE - 1) : c + NSTAGE - 1, a.tlen);
    cp_commit();
    cp_wait<NSTAGE - 1>();
    __syncthreads();
    bf16* xs = reinterpret_cast<bf16*>(st);
    const bf16* ys = xs + C * LD;
    float* p = reinterpret_cast<float*>(st + 2 * C * LD * 2);
    prefix(p, tot);
    // x_hat = k e^{P_C - P_{j+1}} (forward) or r e^{P_t} (reverse), in place
#pragma unroll 4
    for (int e = threadIdx.x; e < C * DH / 2; e += NT) {
      const int t = e / (DH / 2), i = 2 * (e % (DH / 2));
      __nv_bfloat162* xp = reinterpret_cast<__nv_bfloat162*>(xs + t * LD + i);
      const float2 xf = __bfloat1622float2(*xp);
      const int hi = rev ? t : C, lo = rev ? 0 : t + 1;   // P_0 = 0
      const float2 f = ex2(p, hi, lo, i);
      *xp = pack2(xf.x * f.x, xf.y * f.y);
    }
    __syncthreads();
    const float d0 = exp2_neg(p[C * LDP + row0]), d1 = exp2_neg(p[C * LDP + row0 + 8]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      acc[nt][0] *= d0; acc[nt][1] *= d0;
      acc[nt][2] *= d1; acc[nt][3] *= d1;
    }
    // S[i][j] += sum_t x_hat[t][i] y[t][j]: A = x_hat^T, B = y, both [t][.]
    gemm<true, true, 2>(acc, xs + 16 * wr, LD, ys + 32 * wh, LD, C / 16, 2);
  }
  store_tile(out + static_cast<size_t>(rev ? 0 : n) * DH * DH, acc, row0, col);
  if (last) store_tile(last + static_cast<size_t>(bh) * DH * DH, acc, row0, col);
}

// ----------------------------------------------------------- output pass

struct FwdSmem {
  bf16 r[C * LD], k[C * LD], v[C * LD];
  float p[(C + 1) * LDP];
  bf16 rt[C * LD];        // r_t e^{P_t - P_s}
  bf16 rs[C * LD];        // r_t e^{P_t}
  bf16 kt[KT_ROWS * LD];  // k_j e^{P_{s_a} - P_{j+1}}
  bf16 s[DH * LD];        // S_in [i][j]
  bf16 am[C * LD];        // A [t][j]
  float coef[C], tot[4 * DH];
};

// A's blocks left of the diagonal for the rows of sub-chunk wr >= 1:
// r_t e^{P_t - P_s} . k_j e^{P_s - P_{j+1}}, one warp, into am.
__device__ __forceinline__ void intra_off(bf16* am, const bf16* rt,
                                          const bf16* kt, int wr) {
  const int lane = threadIdx.x % 32;
  const int row0 = 16 * wr + lane / 4, col0 = 2 * (lane % 4);
  float acc[6][4];
  zero(acc);
  gemm<false, false, 3>(acc, rt + 16 * wr * LD, LD, kt + kt_off(wr) * LD, LD,
                        DH / 16, wr);
#pragma unroll
  for (int nt = 0; nt < 6; ++nt) {
    if (nt >= 2 * wr) break;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<__nv_bfloat162*>(am + (row0 + 8 * hf) * LD + 8 * nt + col0) =
          pack2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
  }
}

// grid (N, H, B), NT threads: one chunk of one (b, h).
__global__ void __launch_bounds__(NT, 2)
wkv6_out_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const float* __restrict__ logw,
                const float* __restrict__ u, const float* __restrict__ states,
                bf16* __restrict__ out, int tlen, int heads) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_raw);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n = gridDim.x, t0 = c * C, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, wr = warp % 4, wh = warp / 4;
  const size_t stride = static_cast<size_t>(heads) * DH;
  const size_t base = (static_cast<size_t>(b) * tlen * heads + h) * DH;
  load_rows<DH / 8, LD>(sm.r, r + base, stride, t0, tlen);
  load_rows<DH / 8, LD>(sm.k, k + base, stride, t0, tlen);
  load_rows<DH / 8, LD>(sm.v, v + base, stride, t0, tlen);
  load_rows<DH / 4, LDP>(sm.p + LDP, logw + base, stride, t0, tlen);
  cp_commit();
  float4 s_in[DH * DH / 4 / NT];
  fetch_state(s_in, states + ((static_cast<size_t>(b) * heads + h) * (n + 1) + c) * DH * DH);
  cp_wait<0>();
  __syncthreads();
  prefix(sm.p, sm.tot);
  {
    const float cf = row_dot(sm.r, sm.k, u + h * DH);
    if (tid % 4 == 0) sm.coef[tid / 4] = cf;
  }
  factors<NT, true, false, false>(sm.r, sm.k, sm.p, sm.rt, sm.rs, sm.kt, nullptr,
                                  nullptr);
  __syncthreads();
  if (wh == 0 && wr > 0) intra_off(sm.am, sm.rt, sm.kt, wr);
  diag_blocks(sm.am, sm.r, sm.k, sm.p);
  put_state(s_in, [&](int i, int j, float4 x) {
    *reinterpret_cast<__nv_bfloat162*>(sm.s + i * LD + j) = pack2(x.x, x.y);
    *reinterpret_cast<__nv_bfloat162*>(sm.s + i * LD + j + 2) = pack2(x.z, x.w);
  });
  __syncthreads();
  // o = A v + (r e^{P}) S_in + coef v: rows of sub-chunk wr, columns of half wh
  const int row0 = 16 * wr + lane / 4, col0 = 32 * wh + 2 * (lane % 4);
  float acc[4][4];
  zero(acc);
  gemm<false, true, 2>(acc, sm.am + 16 * wr * LD, LD, sm.v + 32 * wh, LD, wr + 1, 2);
  gemm<false, true, 2>(acc, sm.rs + 16 * wr * LD, LD, sm.s + 32 * wh, LD, DH / 16, 2);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int t = row0 + 8 * hf;
    if (t0 + t >= tlen) continue;
    const float cf = sm.coef[t];
    bf16* orow = out + base + (t0 + t) * stride;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int j = 8 * nt + col0;
      const float2 vf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(sm.v + t * LD + j));
      *reinterpret_cast<__nv_bfloat162*>(orow + j) =
          pack2(fmaf(cf, vf.x, acc[nt][2 * hf]), fmaf(cf, vf.y, acc[nt][2 * hf + 1]));
    }
  }
}

// --------------------------------------------------------- gradient pass

struct BwdSmem {
  bf16 r[C * LD], k[C * LD], v[C * LD], d[C * LD];
  float p[(C + 1) * LDP];
  bf16 rt[C * LD];         // r_t e^{P_t - P_s}
  bf16 kt[KT_ROWS * LD];   // k_j e^{P_{s_a} - P_{j+1}}, j < s_a
  bf16 rb[KT_ROWS * LD];   // r_t e^{P_t - P_{e_b}}, t >= e_b
  bf16 kh[C * LD];         // k_j e^{P_C - P_{j+1}}
  bf16 s_hi[DH * LD], s_lo[DH * LD];     // S_in = hi + lo
  bf16 ds_hi[DH * LD], ds_lo[DH * LD];   // dS_out = hi + lo
  bf16 am[C * LD];         // A [t][j]
  bf16 dv[C * LD];         // DV[t][j] = do_t . v_j, blocks left of the diagonal
  float dvd[NSUB][SUB][SUB];  // DV's diagonal blocks, j < t, in f32
  float drd[C * LDP];      // dr's diagonal part, then r dr_state
  float dkd[C * LDP];      // dk's diagonal part, then k dk_state
  float coef[C], vdo[C], xend[DH], u[DH], tot[NTG];
};

struct GradArgs {
  const bf16 *r, *k, *v, *dout;
  const float *logw, *u, *states, *dstates;
  bf16 *dr, *dk, *dv;
  float *dlogw, *du;       // du: [B N, H, dh], one partial per (b, chunk)
  int tlen, heads;
};

// Four f32 at (i, j .. j + 3) as bf16 pairs hi + lo of two tiles.
__device__ __forceinline__ void put_split(bf16* hi, bf16* lo, int i, int j,
                                          float4 x) {
  const __nv_bfloat162 h0 = pack2(x.x, x.y), h1 = pack2(x.z, x.w);
  const float2 f0 = __bfloat1622float2(h0), f1 = __bfloat1622float2(h1);
  *reinterpret_cast<__nv_bfloat162*>(hi + i * LD + j) = h0;
  *reinterpret_cast<__nv_bfloat162*>(hi + i * LD + j + 2) = h1;
  *reinterpret_cast<__nv_bfloat162*>(lo + i * LD + j) = pack2(x.x - f0.x, x.y - f0.y);
  *reinterpret_cast<__nv_bfloat162*>(lo + i * LD + j + 2) = pack2(x.z - f1.x, x.w - f1.y);
}

// grid (N, H, B), NTG threads: one chunk of one (b, h).  Warp w works on
// the rows of sub-chunk w % 4; w / 4 picks its quarter of the columns or of
// the work.
__global__ void __launch_bounds__(NTG, 1) wkv6_grad_kernel(GradArgs g) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(smem_raw);
  constexpr int TPR = NTG / C;              // threads a row or a channel
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n = gridDim.x, t0 = c * C, tid = threadIdx.x, tlen = g.tlen;
  const int warp = tid / 32, lane = tid % 32, wr = warp % 4, wq = warp / 4;
  const size_t stride = static_cast<size_t>(g.heads) * DH;
  const size_t base = (static_cast<size_t>(b) * tlen * g.heads + h) * DH;
  const size_t sbase = ((static_cast<size_t>(b) * g.heads + h) * (n + 1) + c) * DH * DH;
  load_rows<DH / 8, LD, NTG>(sm.r, g.r + base, stride, t0, tlen);
  load_rows<DH / 8, LD, NTG>(sm.k, g.k + base, stride, t0, tlen);
  load_rows<DH / 8, LD, NTG>(sm.v, g.v + base, stride, t0, tlen);
  load_rows<DH / 8, LD, NTG>(sm.d, g.dout + base, stride, t0, tlen);
  load_rows<DH / 4, LDP, NTG>(sm.p + LDP, g.logw + base, stride, t0, tlen);
  cp_commit();
  if (tid < DH) sm.u[tid] = g.u[h * DH + tid];
  // S_in, dS_out and S_out (for X_end[i] = sum_j dS_out[i][j] S_out[i][j]):
  // loads in flight until first needed
  constexpr int SP = DH * DH / 4 / NTG;
  float4 s_in[SP], ds_out[SP], s_out[SP];
  fetch_state<NTG>(s_in, g.states + sbase);
  fetch_state<NTG>(ds_out, g.dstates + sbase + DH * DH);
  fetch_state<NTG>(s_out, g.states + sbase + DH * DH);
  cp_wait<0>();
  __syncthreads();
  prefix<NTG>(sm.p, sm.tot);
  {                     // the bonus: r . (u * k) and v . do of each step
    const float cf = row_dot<NTG>(sm.r, sm.k, sm.u);
    const float vd = row_dot<NTG>(sm.v, sm.d, nullptr);
    if (tid % TPR == 0) {
      sm.coef[tid / TPR] = cf;
      sm.vdo[tid / TPR] = vd;
    }
  }
  factors<NTG, false, true, true>(sm.r, sm.k, sm.p, sm.rt, nullptr, sm.kt, sm.kh,
                                  sm.rb);
  put_state<NTG>(s_in, [&](int i, int j, float4 x) {
    put_split(sm.s_hi, sm.s_lo, i, j, x);
  });
  put_state<NTG>(ds_out, [&](int i, int j, float4 x) {
    put_split(sm.ds_hi, sm.ds_lo, i, j, x);
  });
  // X_end: this thread's float4 m is row (tid + NTG m) / 16 of the
  // states; the 16 threads of a row are neighbouring lanes
#pragma unroll
  for (int m = 0; m < SP; ++m) {
    const float4 x = ds_out[m], y = s_out[m];
    const float acc = row_sum<DH / 4>(
        fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, x.w * y.w))));
    if (tid % (DH / 4) == 0) sm.xend[(tid + NTG * m) / (DH / 4)] = acc;
  }
  __syncthreads();
  if (wq == 0) {
    if (wr > 0) intra_off(sm.am, sm.rt, sm.kt, wr);
    // DV[t][j] = do_t . v_j for j up to the end of t's sub-chunk
    const int row0 = 16 * wr + lane / 4, col0 = 2 * (lane % 4);
    float acc[8][4];
    zero(acc);
    gemm<false, false, 4>(acc, sm.d + 16 * wr * LD, LD, sm.v, LD, DH / 16, wr + 1);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt >= 2 * wr + 2) break;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = row0 + 8 * hf, j = 8 * nt + col0;
        if (nt < 2 * wr) {
          *reinterpret_cast<__nv_bfloat162*>(sm.dv + t * LD + j) =
              pack2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
        } else {
          const int ti = t - 16 * wr, ji = j - 16 * wr;
          sm.dvd[wr][ti][ji] = ji < ti ? acc[nt][2 * hf] : 0.f;
          sm.dvd[wr][ti][ji + 1] = ji + 1 < ti ? acc[nt][2 * hf + 1] : 0.f;
        }
      }
    }
  }
  diag_blocks<NTG>(sm.am, sm.r, sm.k, sm.p);
  __syncthreads();
  {
    // The diagonal blocks of dr and dk, pairwise: one (sub-chunk, channel)
    // a thread of each half, every exponential used for both; the first
    // half takes the rows t <= 10, the second the rest, and adds its dk
    // part after the first has written.
    constexpr int SPLIT_T = 10;
    const int item = tid % (NSUB * DH), second = tid >= NSUB * DH;
    const int s = item / DH, i = item % DH, t0s = SUB * s;
    float rr[SUB], kk[SUB], pp[SUB + 1], dra[SUB], dka[SUB];
#pragma unroll
    for (int q = 0; q < SUB; ++q) {
      rr[q] = bf(sm.r[(t0s + q) * LD + i]);
      kk[q] = bf(sm.k[(t0s + q) * LD + i]);
      dra[q] = dka[q] = 0.f;
    }
#pragma unroll
    for (int q = 0; q <= SUB; ++q) pp[q] = sm.p[(t0s + q) * LDP + i];
    if (!second) {
#pragma unroll
      for (int ti = 1; ti <= SPLIT_T; ++ti)
#pragma unroll
        for (int mi = 0; mi < ti; ++mi) {
          const float w = sm.dvd[s][ti][mi] * exp2_neg(pp[ti] - pp[mi + 1]);
          dra[ti] = fmaf(w, kk[mi], dra[ti]);
          dka[mi] = fmaf(w, rr[ti], dka[mi]);
        }
#pragma unroll
      for (int q = 0; q < SUB; ++q) {
        if (q <= SPLIT_T) sm.drd[(t0s + q) * LDP + i] = dra[q];
        sm.dkd[(t0s + q) * LDP + i] = dka[q];
      }
    } else {
#pragma unroll
      for (int ti = SPLIT_T + 1; ti < SUB; ++ti)
#pragma unroll
        for (int mi = 0; mi < ti; ++mi) {
          const float w = sm.dvd[s][ti][mi] * exp2_neg(pp[ti] - pp[mi + 1]);
          dra[ti] = fmaf(w, kk[mi], dra[ti]);
          dka[mi] = fmaf(w, rr[ti], dka[mi]);
        }
    }
    __syncthreads();
    if (second) {
#pragma unroll
      for (int q = 0; q < SUB; ++q) {
        if (q > SPLIT_T) sm.drd[(t0s + q) * LDP + i] = dra[q];
        if (q < SUB - 1) sm.dkd[(t0s + q) * LDP + i] += dka[q];
      }
    }
  }
  __syncthreads();
  const int sa = 16 * wr, ea = sa + SUB;
  const int row0 = sa + lane / 4, col0 = 2 * (lane % 4);
  const bool live[2] = {t0 + row0 < tlen, t0 + row0 + 8 < tlen};
  {
    // quarters 0, 1: dr; 2, 3: dk; each on 32 columns from cb
    const bool is_dr = wq < 2;
    const int cb = 32 * (wq & 1);
    float acc[4][4];
    zero(acc);
    if (is_dr) {
      // dr: e^{P_t - P_s} [e^{P_s} (do S_in^T) + DV kt] + diagonal; + bonus
      gemm<false, false, 2>(acc, sm.d + sa * LD, LD, sm.s_hi + cb * LD, LD, DH / 16, 2);
      gemm<false, false, 2>(acc, sm.d + sa * LD, LD, sm.s_lo + cb * LD, LD, DH / 16, 2);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float2 f = ex2(sm.p, sa, 0, cb + 8 * nt + col0);
        acc[nt][0] *= f.x; acc[nt][1] *= f.y; acc[nt][2] *= f.x; acc[nt][3] *= f.y;
      }
      if (wr > 0)
        gemm<false, true, 2>(acc, sm.dv + sa * LD, LD, sm.kt + kt_off(wr) * LD + cb,
                             LD, wr, 2);
    } else {
      // dk: e^{P_e - P_{j+1}} [e^{P_C - P_e} (v dS_out^T) + DV^T rb] + diagonal
      gemm<false, false, 2>(acc, sm.v + sa * LD, LD, sm.ds_hi + cb * LD, LD, DH / 16, 2);
      gemm<false, false, 2>(acc, sm.v + sa * LD, LD, sm.ds_lo + cb * LD, LD, DH / 16, 2);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float2 f = ex2(sm.p, C, ea, cb + 8 * nt + col0);
        acc[nt][0] *= f.x; acc[nt][1] *= f.y; acc[nt][2] *= f.x; acc[nt][3] *= f.y;
      }
      if (wr < NSUB - 1)
        gemm<true, true, 2>(acc, sm.dv + ea * LD + sa, LD,
                            sm.rb + rb_off(wr) * LD + cb, LD, NSUB - 1 - wr, 2);
    }
    float* part = is_dr ? sm.drd : sm.dkd;
    bf16* grad = is_dr ? g.dr : g.dk;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = row0 + 8 * hf;
      bf16* grow = grad + base + (t0 + t) * stride;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float o[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int i = cb + 8 * nt + col0 + x;
          const float rt = bf(sm.r[t * LD + i]), kt = bf(sm.k[t * LD + i]);
          const float f = is_dr ? ex(sm.p, t, sa, i) : ex(sm.p, ea, t + 1, i);
          const float st = fmaf(f, acc[nt][2 * hf + x], part[t * LDP + i]);
          part[t * LDP + i] = (is_dr ? rt : kt) * st;   // r dr_state, k dk_state
          o[x] = fmaf(sm.u[i] * (is_dr ? kt : rt), sm.vdo[t], st);   // + bonus
        }
        if (live[hf])
          *reinterpret_cast<__nv_bfloat162*>(grow + cb + 8 * nt + col0) = pack2(o[0], o[1]);
      }
    }
  }
  {
    // dv: A^T do + k_hat dS_out + bonus, quarter wq of the columns
    float acc[2][4];
    zero(acc);
    gemm<true, true, 1>(acc, sm.am + sa * LD + sa, LD, sm.d + sa * LD + 16 * wq, LD,
                        NSUB - wr, 1);
    gemm<false, true, 1>(acc, sm.kh + sa * LD, LD, sm.ds_hi + 16 * wq, LD, DH / 16, 1);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = row0 + 8 * hf;
      if (!live[hf]) continue;
      const float cf = sm.coef[t];
      bf16* grow = g.dv + base + (t0 + t) * stride;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int j = 16 * wq + 8 * nt + col0;
        const float2 df = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sm.d + t * LD + j));
        *reinterpret_cast<__nv_bfloat162*>(grow + j) =
            pack2(fmaf(cf, df.x, acc[nt][2 * hf]), fmaf(cf, df.y, acc[nt][2 * hf + 1]));
      }
    }
  }
  __syncthreads();
  {
    // d log w_t = X_end + sum_{t'>t} P_t' - sum_{t'>=t} Q_t' (P = drd, Q =
    // dkd) and du: TPR threads a channel, C / TPR steps each, the later
    // steps' sums through shared memory (tot).
    constexpr int R = C / TPR;
    const int i = tid % DH, q = tid / DH, tq = R * q;
    float pq[R], du = 0.f, sp = 0.f;
#pragma unroll
    for (int x = 0; x < R; ++x) {
      const int t = tq + x;
      pq[x] = sm.drd[t * LDP + i] - sm.dkd[t * LDP + i];
      sp += pq[x];
      du = fmaf(bf(sm.r[t * LD + i]) * bf(sm.k[t * LD + i]), sm.vdo[t], du);
    }
    sm.tot[q * DH + i] = sp;
    __syncthreads();
    float run = sm.xend[i];            // X_end + sum over the later steps
#pragma unroll
    for (int qq = 1; qq < TPR; ++qq)
      if (qq > q) run += sm.tot[qq * DH + i];
#pragma unroll
    for (int x = R - 1; x >= 0; --x) {
      const int t = tq + x;
      // run = X_end + sum_{t'>t} (P - Q); dlogw_t = run - Q_t
      if (t0 + t < tlen)
        g.dlogw[base + (t0 + t) * stride + i] = run - sm.dkd[t * LDP + i];
      run += pq[x];
    }
    __syncthreads();                   // every thread has read tot
    sm.tot[q * DH + i] = du;
    __syncthreads();
    if (q == 0) {
      float sum = 0.f;
#pragma unroll
      for (int qq = 0; qq < TPR; ++qq) sum += sm.tot[qq * DH + i];
      g.du[((static_cast<size_t>(b) * n + c) * g.heads + h) * DH + i] = sum;
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

cudaError_t launch_fwd(const void* r, const void* k, const void* v,
                       const float* logw, const float* u, const float* s0,
                       void* out, float* s_out, float* states, int batch,
                       int tlen, int heads, cudaStream_t s) {
  const int n = (tlen + C - 1) / C;
  StateArgs a{};
  a.x[0] = static_cast<const bf16*>(k);
  a.y[0] = static_cast<const bf16*>(v);
  a.logw = logw;
  a.init[0] = s0;
  a.states[0] = states;
  a.last[0] = s_out;
  a.tlen = tlen; a.heads = heads; a.nchunks = n;
  cudaError_t err = set_smem(wkv6_state_kernel, STATE_SMEM);
  if (err != cudaSuccess) return err;
  wkv6_state_kernel<<<dim3(batch * heads, 1), NT, STATE_SMEM, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) return err;
  err = set_smem(wkv6_out_kernel, sizeof(FwdSmem));
  if (err != cudaSuccess) return err;
  wkv6_out_kernel<<<dim3(n, heads, batch), NT, sizeof(FwdSmem), s>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), logw, u, states, static_cast<bf16*>(out),
      tlen, heads);
  return cudaGetLastError();
}

cudaError_t launch_bwd(const void* r, const void* k, const void* v,
                       const float* logw, const float* u, const float* s0,
                       const void* dout, const float* ds_t, void* dr, void* dk,
                       void* dv, float* dlogw, float* du, float* ds0,
                       float* states, float* dstates, int batch, int tlen,
                       int heads, cudaStream_t s) {
  const int n = (tlen + C - 1) / C;
  StateArgs a{};
  a.x[0] = static_cast<const bf16*>(k);
  a.y[0] = static_cast<const bf16*>(v);
  a.x[1] = static_cast<const bf16*>(r);
  a.y[1] = static_cast<const bf16*>(dout);
  a.logw = logw;
  a.init[0] = s0;
  a.init[1] = ds_t;
  a.states[0] = states;
  a.states[1] = dstates;
  a.last[1] = ds0;
  a.tlen = tlen; a.heads = heads; a.nchunks = n;
  cudaError_t err = set_smem(wkv6_state_kernel, STATE_SMEM);
  if (err != cudaSuccess) return err;
  wkv6_state_kernel<<<dim3(batch * heads, 2), NT, STATE_SMEM, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) return err;
  GradArgs g{static_cast<const bf16*>(r), static_cast<const bf16*>(k),
             static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
             logw, u, states, dstates, static_cast<bf16*>(dr),
             static_cast<bf16*>(dk), static_cast<bf16*>(dv), dlogw, du,
             tlen, heads};
  err = set_smem(wkv6_grad_kernel, sizeof(BwdSmem));
  if (err != cudaSuccess) return err;
  wkv6_grad_kernel<<<dim3(n, heads, batch), NTG, sizeof(BwdSmem), s>>>(g);
  return cudaGetLastError();
}

}  // namespace chunked

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue)
// for a head size that is not built or a route the arguments do not take.
// route: 0 the SIMT kernel, 1 the chunked tensor-core kernels (bf16, dh
// 64), which take `states`, f32 scratch [B, H, ceil(T / 64) + 1, dh, dh]
// (the state at each chunk boundary); the SIMT route ignores it.
int wkv6_fwd(const void* r, const void* k, const void* v, const float* logw,
             const float* u, const float* s0, void* out, float* s_out,
             float* states, int batch, int tlen, int heads, int dh,
             int dtype, int route, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch * heads == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_CHUNKED) {
    if (dtype != DT_BF16 || dh != chunked::DH || states == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(chunked::launch_fwd(
        r, k, v, logw, u, s0, out, s_out, states, batch, tlen, heads, s));
  }
  if (route != ROUTE_SIMT) return static_cast<int>(cudaErrorInvalidValue);
#define WKV6_FWD(T, D) \
  err = launch_fwd<T, D>(r, k, v, logw, u, s0, out, s_out, batch, tlen, heads, s)
  if (dtype == DT_BF16) {
    if (dh == 64) WKV6_FWD(__nv_bfloat16, 64);
    else if (dh == 32) WKV6_FWD(__nv_bfloat16, 32);
    else if (dh == 16) WKV6_FWD(__nv_bfloat16, 16);
    else return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (dh == 64) WKV6_FWD(float, 64);
    else if (dh == 32) WKV6_FWD(float, 32);
    else if (dh == 16) WKV6_FWD(float, 16);
    else return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WKV6_FWD
  return static_cast<int>(err);
}

// SIMT route: p, q: scratch [B, T, H, dh] f32; f: scratch [B, H, dh] f32;
// du_part [B, H, dh] f32 (the wrapper sums it over B).  Chunked route:
// states, dstates: scratch [B, H, N + 1, dh, dh] f32 (N = ceil(T / 64));
// du_part [B N, H, dh] f32, one partial per (b, chunk), which the wrapper
// sums over its first axis.  s0, ds_t and ds0 may be null; each route
// ignores the other's scratch.
int wkv6_bwd(const void* r, const void* k, const void* v, const float* logw,
             const float* u, const float* s0, const void* dout,
             const float* ds_t, void* dr, void* dk, void* dv, float* dlogw,
             float* du_part, float* ds0, float* p, float* q, float* f,
             float* states, float* dstates, int batch, int tlen, int heads,
             int dh, int dtype, int route, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch * heads == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_CHUNKED) {
    if (dtype != DT_BF16 || dh != chunked::DH || states == nullptr ||
        dstates == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(chunked::launch_bwd(
        r, k, v, logw, u, s0, dout, ds_t, dr, dk, dv, dlogw, du_part, ds0,
        states, dstates, batch, tlen, heads, s));
  }
  if (route != ROUTE_SIMT) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{r, k, v, dout, logw, u, s0, ds_t, dr, dk, dv,
            du_part, ds0, p, q, f, tlen, heads};
#define WKV6_BWD(T, D) \
  wkv6_bwd_kernel<T, D><<<dim3(batch * heads, 3), D * SPLIT, 0, s>>>(a)
  if (dtype == DT_BF16) {
    if (dh == 64) WKV6_BWD(__nv_bfloat16, 64);
    else if (dh == 32) WKV6_BWD(__nv_bfloat16, 32);
    else if (dh == 16) WKV6_BWD(__nv_bfloat16, 16);
    else return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (dh == 64) WKV6_BWD(float, 64);
    else if (dh == 32) WKV6_BWD(float, 32);
    else if (dh == 16) WKV6_BWD(float, 16);
    else return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WKV6_BWD
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int lanes = batch * heads * dh;
  wkv6_dlogw_kernel<<<(lanes + 255) / 256, 256, 0, s>>>(
      p, q, f, dlogw, lanes, tlen, heads, dh);
  return static_cast<int>(cudaGetLastError());
}

const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
