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
//   in x's dtype.  Any S >= 0 and any R: the Pallas kernel's chunk and
//   r_block asserts are TPU tiling artefacts.
//
// Bound on the card: bytes.  At the model's call in recurrentgemma-2b
// prefill ([4, 512, 2560], f32 x and log a) a call reads 42 MB and writes
// 21 MB (h) plus 41 KB (h_last): 18.8 us at 3.35 TB/s.  About 8 operations
// an element are nothing against any peak.  The Pallas kernel walks S in
// order on one core; a thread per lane walking S would give 10,240 threads
// at that call, too few loads in flight to reach the memory rate.
//
// Design: one pass, chunks chained by look-back (the single-pass scan of
// CUB's decoupled look-back, over the recurrence's affine monoid).  Each
// step is the map h -> a h + bx; a run of steps composes into one such map
// (A, H) = (prod a, the run's end value from a zero carry), and
//   (A1, H1) then (A2, H2)  =  (A1 A2, A2 H1 + H2).
// The work is cut into tiles of kLanes lanes by chunks of kChunk steps, one
// CTA each (1,280 CTAs at the model's call).  A CTA
//   1. takes a ticket from a global counter; chunk-major tickets mean that
//      every chunk it will wait on belongs to a CTA that already runs or
//      has finished, whatever order the hardware starts CTAs in;
//   2. loads its [kChunk, kLanes] tile of x and log a once, coalesced along
//      R, into registers (kSubs threads a lane, kSteps steps each), forms
//      a and sqrt(1 - a^2) x, and each thread its run's (A, H);
//   3. folds the kSubs runs into the chunk's (A, H) and publishes it with a
//      flag (AGGREGATE);
//   4. looks back over earlier chunks of its tile to the nearest one that
//      has published its carry (INCLUSIVE), or to chunk 0, and folds the
//      aggregates after it forward, carry <- A carry + H; publishes its own
//      carry (INCLUSIVE); chunk 0 starts from h0 and publishes at once;
//   5. re-runs each thread's kSteps steps from its true carry on the values
//      it holds and writes h once; the thread holding step S - 1 writes
//      h_last.
// So x and log a are read once and h written once: the bytes the bound
// counts, plus 12 bytes a lane and chunk of scratch.  Every carry is the
// same sequential fold of the aggregates from h0, in one order, wherever a
// look-back stops (an INCLUSIVE carry is that fold's value), so two calls
// on the same inputs give the same bits.  With a <= 1 no aggregate can
// overflow.  The flags and the ticket are zeroed by the wrapper each call.
// Each flag is published with st.release.gpu after the writers' fences and
// read with ld.acquire.gpu; the scratch values behind it are read through
// L2 (ld.cg), never from a stale L1 line.
// expf/sqrtf, not the fast-math intrinsics; __fmul_rn/__fadd_rn keep the
// plain version's roundings of 1 - a^2 and of the update (no contraction
// to an FMA).  The composition differs from the plain sequential scan in
// the carry's rounding only: ~3e-7 relative to the largest value in f32.
//
// The backward (`rglru_chunked_bwd`; no Pallas kernel has this job, the
// reference differentiates its associative scan) is the same one-pass
// chunked look-back run from the last chunk to the first.  With
// c_t = sqrt(max(1 - a_t^2, 1e-12)), the gradient g_t of h_t is the
// reverse recurrence
//
//   g_t = dh_t + a_{t+1} g_{t+1},   g_{S-1} = dh_{S-1} + dh_last,
//
// the same affine monoid with the map g -> a_{t+1} g + dh_t at step t, and
//
//   dx_t = c_t g_t,   dlog_a_t = g_t (a_t h_{t-1} - [1 - a_t^2 > 1e-12]
//                                        a_t^2 x_t / c_t),
//   dh0 = a_0 g_0
//
// (h_{-1} = h0).  Tickets are chunk-major from the last chunk, which starts
// from dh_last and publishes only its carry; every other chunk publishes
// its aggregate, looks back over later chunks and publishes the carry it
// hands to the chunk before it.  A thread loads its 16 steps' log a and
// dh and the log a of the step after them, runs its aggregate, and once
// its carry is known re-runs its steps backwards, reading x_t and the
// forward's saved h_{t-1} to write dx and dlog a once.  Bound: bytes (x,
// log a, h, dh read, dx and dlog a written: 126 MB at recurrentgemma-2b's
// training call [2, 4096, 2560] f32, 37.6 us at 3.35 TB/s).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2 };
enum { EMPTY = 0, AGGREGATE = 1, INCLUSIVE = 2 };

constexpr int kLanes = 64;                 // r per tile (kernels/rglru.py LANES)
constexpr int kSubs = 4;                   // threads per lane
constexpr int kSteps = 16;                 // time steps per thread
constexpr int kChunk = kSubs * kSteps;     // kernels/rglru.py CHUNK
constexpr int kThreads = kLanes * kSubs;

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

// h -> a h + bx, as the plain version rounds it
__device__ __forceinline__ float apply(float a, float bx, float h) {
  return __fadd_rn(__fmul_rn(a, h), bx);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// The kLanes threads of sub-chunk 0 (warps 0 and 1) publish a flag once
// each has written its lane's value.
__device__ __forceinline__ void publish(int* flag, int state) {
  __threadfence();
  asm volatile("bar.sync 1, %0;" ::"n"(kLanes) : "memory");
  if (threadIdx.x == 0) st_release(flag, state);
}

// Four CTAs an SM (64 registers, no spills): more loads in flight than at
// the 78 registers ptxas picks unbounded, which fit three.
template <typename TX, typename TA>
__global__ void __launch_bounds__(kThreads, 4)
rglru_chunked(const TX* __restrict__ x, const TA* __restrict__ la,
              const void* __restrict__ h0, int h0_dtype, long long h0sb,
              TX* __restrict__ h, TX* __restrict__ h_last, int S, int R,
              int n_rt, long long n_tiles, int n_chunks, long long xsb,
              long long xss, long long asb, long long ass,
              int* __restrict__ status, float2* __restrict__ agg,
              float* __restrict__ carry_out) {
  __shared__ int s_ticket;
  __shared__ float s_a[kSubs][kLanes], s_h[kSubs][kLanes];
  __shared__ float s_carry[kSubs][kLanes];
  if (threadIdx.x == 0) s_ticket = atomicAdd(status, 1);
  __syncthreads();
  const int c = static_cast<int>(s_ticket / n_tiles);   // chunk-major
  const long long tile = s_ticket % n_tiles;
  const int b = static_cast<int>(tile / n_rt);
  const int lane = threadIdx.x % kLanes, sub = threadIdx.x / kLanes;
  const int r = static_cast<int>(tile % n_rt) * kLanes + lane;
  const bool live = r < R;
  const int t0 = c * kChunk + sub * kSteps;

  // 2. the tile's values, every load in flight before the first is used
  float av[kSteps], bx[kSteps];
  {
    const long long xo = live ? b * xsb + t0 * xss + r : 0;
    const long long ao = live ? b * asb + t0 * ass + r : 0;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const bool ok = live && t0 + u < S;
      bx[u] = ok ? to_f32(x[xo + u * xss]) : 0.f;
      av[u] = ok ? to_f32(la[ao + u * ass]) : 0.f;   // a = 1, bx = 0
    }
  }
  float A = 1.f, H = 0.f;
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const float a = expf(av[u]);
    bx[u] = __fmul_rn(sqrtf(fmaxf(1.f - __fmul_rn(a, a), 1e-12f)), bx[u]);
    av[u] = a;
    H = apply(a, bx[u], H);
    A = __fmul_rn(A, a);
  }
  s_a[sub][lane] = A;
  s_h[sub][lane] = H;
  __syncthreads();

  if (sub == 0) {
    // 3. the chunk's aggregate
    float CA = s_a[0][lane], CH = s_h[0][lane];
#pragma unroll
    for (int s = 1; s < kSubs; ++s) {
      CH = apply(s_a[s][lane], s_h[s][lane], CH);
      CA = __fmul_rn(CA, s_a[s][lane]);
    }
    int* flags = status + 1 + tile * n_chunks;
    const long long base = tile * n_chunks * kLanes + lane;
    float carry;
    if (c == 0) {
      carry = (h0 != nullptr && live) ? load_h0(h0, h0_dtype, b * h0sb + r)
                                      : 0.f;
    } else {
      agg[base + static_cast<long long>(c) * kLanes] = make_float2(CA, CH);
      publish(flags + c, AGGREGATE);
      // 4. back to the nearest published carry (chunk 0 publishes only
      // that), then the aggregates after it folded forward
      int p = c - 1;
      for (;;) {
        const int f = ld_acquire(flags + p);
        if (f == INCLUSIVE) break;
        if (f == AGGREGATE) --p;
      }
      carry = __ldcg(carry_out + base + static_cast<long long>(p) * kLanes);
      for (int q = p + 1; q < c; ++q) {
        const float2 g = __ldcg(agg + base + static_cast<long long>(q) * kLanes);
        carry = apply(g.x, g.y, carry);
      }
    }
    if (c + 1 < n_chunks) {
      carry_out[base + static_cast<long long>(c) * kLanes] =
          apply(CA, CH, carry);
      publish(flags + c, INCLUSIVE);
    }
    // each run's carry in
    s_carry[0][lane] = carry;
#pragma unroll
    for (int s = 1; s < kSubs; ++s) {
      carry = apply(s_a[s - 1][lane], s_h[s - 1][lane], carry);
      s_carry[s][lane] = carry;
    }
  }
  __syncthreads();

  // 5. the re-run from the true carry; masked steps are the identity
  float hc = s_carry[sub][lane];
  if (!live) return;
  TX* hp = h + (static_cast<long long>(b) * S + t0) * R + r;
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    hc = apply(av[u], bx[u], hc);
    if (t0 + u < S) store(hp + static_cast<long long>(u) * R, hc);
  }
  const bool holds_last =
      S == 0 ? sub == 0 : (t0 <= S - 1 && S - 1 < t0 + kSteps);
  if (holds_last) store(h_last + static_cast<long long>(b) * R + r, hc);
}

template <typename TX, typename TA>
cudaError_t launch(const void* x, const void* la, const void* h0,
                   int h0_dtype, long long h0sb, void* h, void* h_last,
                   int S, int R, int n_rt, int n_chunks, long long n_ctas,
                   long long xsb, long long xss, long long asb,
                   long long ass, int* status, float* scratch,
                   long long n_slots, cudaStream_t stream) {
  rglru_chunked<TX, TA><<<static_cast<unsigned>(n_ctas), kThreads, 0,
                          stream>>>(
      static_cast<const TX*>(x), static_cast<const TA*>(la), h0, h0_dtype,
      h0sb, static_cast<TX*>(h), static_cast<TX*>(h_last), S, R, n_rt,
      n_ctas / n_chunks, n_chunks, xsb, xss, asb, ass, status,
      reinterpret_cast<float2*>(scratch), scratch + 2 * n_slots);
  return cudaGetLastError();
}

// The backward: see the header.  x, la, h (the forward's output) and dh are
// [B, S, R] with a unit stride along R (h and dh contiguous), dh_last [B, R]
// contiguous or null; dx (x's dtype) and dla (la's dtype) contiguous; dh0
// [B, R] f32 or null.  h, dh and dh_last share x's dtype.
// Three CTAs an SM: the 33 values a thread holds spill ~100 bytes at the
// forward's 64 registers (four CTAs), less than half that at three.
template <typename TX, typename TA>
__global__ void __launch_bounds__(kThreads, 3)
rglru_chunked_bwd(const TX* __restrict__ x, const TA* __restrict__ la,
                  const void* __restrict__ h0, int h0_dtype, long long h0sb,
                  const TX* __restrict__ h, const TX* __restrict__ dh,
                  const TX* __restrict__ dh_last, TX* __restrict__ dx,
                  TA* __restrict__ dla, float* __restrict__ dh0, int S, int R,
                  int n_rt, long long n_tiles, int n_chunks, long long xsb,
                  long long xss, long long asb, long long ass,
                  int* __restrict__ status, float2* __restrict__ agg,
                  float* __restrict__ carry_out) {
  __shared__ int s_ticket;
  __shared__ float s_a[kSubs][kLanes], s_h[kSubs][kLanes];
  __shared__ float s_carry[kSubs][kLanes];
  if (threadIdx.x == 0) s_ticket = atomicAdd(status, 1);
  __syncthreads();
  const int c = n_chunks - 1 - static_cast<int>(s_ticket / n_tiles);
  const long long tile = s_ticket % n_tiles;
  const int b = static_cast<int>(tile / n_rt);
  const int lane = threadIdx.x % kLanes, sub = threadIdx.x / kLanes;
  const int r = static_cast<int>(tile % n_rt) * kLanes + lane;
  const bool live = r < R;
  const int t0 = c * kChunk + sub * kSteps;
  const long long hb = (static_cast<long long>(b) * S) * R + r;

  // av[u] = a_{t0+u} (1 past S), dg[u] = dh_{t0+u} (0 past S)
  float av[kSteps + 1], dg[kSteps];
  {
    const long long ao = live ? b * asb + t0 * ass + r : 0;
#pragma unroll
    for (int u = 0; u <= kSteps; ++u) {
      const bool ok = live && t0 + u < S;
      av[u] = ok ? to_f32(la[ao + u * ass]) : 0.f;
      if (u < kSteps)
        dg[u] = ok ? to_f32(dh[hb + static_cast<long long>(t0 + u) * R])
                   : 0.f;
    }
  }
  float A = 1.f, H = 0.f;
#pragma unroll
  for (int u = 0; u <= kSteps; ++u) av[u] = expf(av[u]);
#pragma unroll
  for (int u = kSteps - 1; u >= 0; --u) {
    H = apply(av[u + 1], dg[u], H);
    A = __fmul_rn(A, av[u + 1]);
  }
  s_a[sub][lane] = A;
  s_h[sub][lane] = H;
  __syncthreads();

  if (sub == 0) {
    float CA = s_a[kSubs - 1][lane], CH = s_h[kSubs - 1][lane];
#pragma unroll
    for (int s = kSubs - 2; s >= 0; --s) {
      CH = apply(s_a[s][lane], s_h[s][lane], CH);
      CA = __fmul_rn(CA, s_a[s][lane]);
    }
    int* flags = status + 1 + tile * n_chunks;
    const long long base = tile * n_chunks * kLanes + lane;
    float carry;
    if (c == n_chunks - 1) {
      carry = (dh_last != nullptr && live)
                  ? to_f32(dh_last[static_cast<long long>(b) * R + r])
                  : 0.f;
    } else {
      agg[base + static_cast<long long>(c) * kLanes] = make_float2(CA, CH);
      publish(flags + c, AGGREGATE);
      int p = c + 1;
      for (;;) {
        const int f = ld_acquire(flags + p);
        if (f == INCLUSIVE) break;
        if (f == AGGREGATE) ++p;
      }
      carry = __ldcg(carry_out + base + static_cast<long long>(p) * kLanes);
      for (int q = p - 1; q > c; --q) {
        const float2 g = __ldcg(agg + base + static_cast<long long>(q) * kLanes);
        carry = apply(g.x, g.y, carry);
      }
    }
    if (c > 0) {
      carry_out[base + static_cast<long long>(c) * kLanes] =
          apply(CA, CH, carry);
      publish(flags + c, INCLUSIVE);
    }
    s_carry[kSubs - 1][lane] = carry;
#pragma unroll
    for (int s = kSubs - 2; s >= 0; --s) {
      carry = apply(s_a[s + 1][lane], s_h[s + 1][lane], carry);
      s_carry[s][lane] = carry;
    }
  }
  __syncthreads();

  // the re-run from the true carry, backwards; masked steps are the identity
  float g = s_carry[sub][lane];
  if (!live) return;
  const long long xo = b * xsb + t0 * xss + r;
#pragma unroll
  for (int u = kSteps - 1; u >= 0; --u) {
    g = apply(av[u + 1], dg[u], g);
    const int t = t0 + u;
    if (t >= S) continue;
    const float a = av[u], a2 = __fmul_rn(a, a);
    const float one_m = 1.f - a2;
    const float cc = sqrtf(fmaxf(one_m, 1e-12f));
    const float xv = to_f32(x[xo + u * xss]);
    const float hp =
        t > 0 ? to_f32(h[hb + static_cast<long long>(t - 1) * R])
              : (h0 != nullptr ? load_h0(h0, h0_dtype, b * h0sb + r) : 0.f);
    const float dcx = one_m > 1e-12f ? __fdiv_rn(__fmul_rn(a2, xv), cc) : 0.f;
    const long long o = hb + static_cast<long long>(t) * R;
    store(dx + o, __fmul_rn(cc, g));
    store(dla + o, __fmul_rn(g, __fsub_rn(__fmul_rn(a, hp), dcx)));
  }
  // dh0 = a_0 g_0 (S = 0: every step is the identity, g is dh_last)
  if (dh0 != nullptr && t0 == 0)
    dh0[static_cast<long long>(b) * R + r] = __fmul_rn(av[0], g);
}

template <typename TX, typename TA>
cudaError_t launch_bwd(const void* x, const void* la, const void* h0,
                       int h0_dtype, long long h0sb, const void* h,
                       const void* dh, const void* dh_last, void* dx,
                       void* dla, float* dh0, int S, int R, int n_rt,
                       int n_chunks, long long n_ctas, long long xsb,
                       long long xss, long long asb, long long ass,
                       int* status, float* scratch, long long n_slots,
                       cudaStream_t stream) {
  rglru_chunked_bwd<TX, TA><<<static_cast<unsigned>(n_ctas), kThreads, 0,
                              stream>>>(
      static_cast<const TX*>(x), static_cast<const TA*>(la), h0, h0_dtype,
      h0sb, static_cast<const TX*>(h), static_cast<const TX*>(dh),
      static_cast<const TX*>(dh_last), static_cast<TX*>(dx),
      static_cast<TA*>(dla), dh0, S, R, n_rt, n_ctas / n_chunks, n_chunks,
      xsb, xss, asb, ass, status, reinterpret_cast<float2*>(scratch),
      scratch + 2 * n_slots);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Strides are in elements, for the [B, S] index order (R has stride 1).
// x_dtype, la_dtype: 0 f32, 1 bf16; h0_dtype: 0 f32, 1 bf16, 2 f16 (h0 may
// be null).  status: int32 [1 + tiles * chunks], zeroed by the caller
// (the ticket counter, then one flag per tile and chunk); scratch: f32
// [3 * tiles * chunks * kLanes], 8-byte aligned (each slot's aggregate,
// then its carry), with tiles = B * ceil(R / kLanes) and chunks =
// max(1, ceil(S / kChunk)).  Returns cudaGetLastError() after the launch;
// cudaErrorInvalidValue for a dtype without an instantiation, scratch too
// small or a grid past 2^31 - 1 CTAs.
int rglru_scan_fwd(const void* x, const void* la, const void* h0,
                   int h0_dtype, long long h0sb, void* h, void* h_last, int B,
                   int S, int R, long long xsb, long long xss, long long asb,
                   long long ass, int x_dtype, int la_dtype, void* status,
                   long long status_len, void* scratch, long long scratch_len,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || R <= 0 || S < 0) return 0;
  const int n_rt = (R + kLanes - 1) / kLanes;
  const int n_chunks = S > 0 ? (S + kChunk - 1) / kChunk : 1;
  const long long n_ctas = static_cast<long long>(B) * n_rt * n_chunks;
  const long long n_slots = n_ctas * kLanes;
  if (n_ctas > 0x7fffffffLL || status_len < 1 + n_ctas ||
      scratch_len < 3 * n_slots ||
      reinterpret_cast<uintptr_t>(scratch) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* st = static_cast<int*>(status);
  float* sc = static_cast<float*>(scratch);
#define RGLRU_LAUNCH(TX, TA)                                                 \
  err = launch<TX, TA>(x, la, h0, h0_dtype, h0sb, h, h_last, S, R, n_rt,   \
                       n_chunks, n_ctas, xsb, xss, asb, ass, st, sc,       \
                       n_slots, s)
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

// The backward of rglru_scan_fwd on the same grid and scratch (zeroed
// status, scratch as there): x, la, h0 as rglru_scan_fwd takes them; h
// (its output), dh (h's gradient, contiguous) and dh_last ([B, R],
// contiguous, or null for zeros) in x's dtype -> dx (x's dtype), dla (la's
// dtype), contiguous [B, S, R], and dh0 [B, R] f32 (null: not written).
int rglru_scan_bwd(const void* x, const void* la, const void* h0,
                   int h0_dtype, long long h0sb, const void* h,
                   const void* dh, const void* dh_last, void* dx, void* dla,
                   void* dh0, int B, int S, int R, long long xsb,
                   long long xss, long long asb, long long ass, int x_dtype,
                   int la_dtype, void* status, long long status_len,
                   void* scratch, long long scratch_len, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || R <= 0 || S < 0) return 0;
  const int n_rt = (R + kLanes - 1) / kLanes;
  const int n_chunks = S > 0 ? (S + kChunk - 1) / kChunk : 1;
  const long long n_ctas = static_cast<long long>(B) * n_rt * n_chunks;
  const long long n_slots = n_ctas * kLanes;
  if (n_ctas > 0x7fffffffLL || status_len < 1 + n_ctas ||
      scratch_len < 3 * n_slots ||
      reinterpret_cast<uintptr_t>(scratch) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* st = static_cast<int*>(status);
  float* sc = static_cast<float*>(scratch);
  float* g0 = static_cast<float*>(dh0);
#define RGLRU_BWD(TX, TA)                                                    \
  err = launch_bwd<TX, TA>(x, la, h0, h0_dtype, h0sb, h, dh, dh_last, dx,   \
                           dla, g0, S, R, n_rt, n_chunks, n_ctas, xsb, xss, \
                           asb, ass, st, sc, n_slots, s)
  if (x_dtype == DT_F32 && la_dtype == DT_F32) RGLRU_BWD(float, float);
  else if (x_dtype == DT_F32 && la_dtype == DT_BF16)
    RGLRU_BWD(float, __nv_bfloat16);
  else if (x_dtype == DT_BF16 && la_dtype == DT_F32)
    RGLRU_BWD(__nv_bfloat16, float);
  else if (x_dtype == DT_BF16 && la_dtype == DT_BF16)
    RGLRU_BWD(__nv_bfloat16, __nv_bfloat16);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef RGLRU_BWD
  return static_cast<int>(err);
}

const char* rglru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
