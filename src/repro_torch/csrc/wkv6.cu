// WKV6 recurrence of RWKV6 ("Finch"): forward and backward.
//
// Replaces the Pallas kernel `wkv6` (`_wkv6_kernel`) of the JAX package's
// kernels/rwkv6.py.  That kernel is a chunked reformulation for the TPU's
// matrix unit; this one computes the same function as the step-by-step
// recurrence of models/rwkv.py::wkv6_scan, per (batch, head), with the
// state S [dh, dh] in f32:
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
// Forward: one CTA per (b, h).  Each state column j belongs to SPLIT = 4
// neighbouring threads, each keeping dh/4 of its rows in registers (rows
// i = 4*ii + part, so the four read four neighbouring shared words); the
// column's output is their sum, two shuffles.  The inputs are staged in
// shared memory a chunk of steps at a time (r, k, w, u packed per row as
// one float4), double-buffered: one barrier per chunk, and the next
// chunk's loads are in flight while this chunk computes, so the loop over
// t -- the Pallas kernel's sequential grid axis -- never waits on device
// memory.  Any T (the last chunk is masked), dh in {16, 32, 64}.
//
// Backward: the adjoint state dS_{t-1} = diag(w_t) dS_t + r_t do_t^T runs
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
// Bound on the card: f32 operations.  At the main path's call
// ([2, 512, 40, 64], bf16 r/k/v) the forward does ~5 f32 operations per
// state element per step (0.84 GFLOP, 12.5 us at 67 TFLOP/s) against
// 32.8 MB moved (9.8 us at 3.35 TB/s); the backward ~12 (2.0 GFLOP, 30 us)
// against 57.7 MB (17 us).  This design stays on the f32 pipes and is
// sequential in t: B*H CTAs (80 at the main shape) leave part of the card
// idle.  A chunked tensor-core design is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { DT_F32 = 0, DT_BF16 = 1 };

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

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue)
// for a head size that is not built.
int wkv6_fwd(const void* r, const void* k, const void* v, const float* logw,
             const float* u, const float* s0, void* out, float* s_out,
             int batch, int tlen, int heads, int dh, int dtype, int device,
             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch * heads == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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

// p, q: scratch [B, T, H, dh] f32; f: scratch [B, H, dh] f32; du_part
// [B, H, dh] f32 (the wrapper sums it over B).  s0, ds_t and ds0 may be
// null.
int wkv6_bwd(const void* r, const void* k, const void* v, const float* logw,
             const float* u, const float* s0, const void* dout,
             const float* ds_t, void* dr, void* dk, void* dv, float* dlogw,
             float* du_part, float* ds0, float* p, float* q, float* f,
             int batch, int tlen, int heads, int dh, int dtype, int device,
             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch * heads == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
