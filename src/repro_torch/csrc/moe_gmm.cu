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
// every tile is bounds-checked or zero-filled (the Pallas kernel asserts
// multiples of its 128 / 128 / 512 blocks, a TPU tiling artefact).
//
// Bound on the card.  granite-moe-3b-a800m prefill (B 4 x S 512 tokens, top
// 8 of 40 experts, capacity 512): [40, 512, 1536] @ [40, 1536, 512] in bf16
// moves 146.8 MB (43.8 us at 3.35 TB/s) for 32.2 GFLOP (32.6 us on the bf16
// tensor cores): bytes, narrowly.  A decode step (capacity 8) reads every
// expert's weights, 64.2 MB for 0.25 GFLOP: bytes (19.2 us).
//
// Three routes, chosen by the caller before the launch (kernels/moe_gmm.py
// `route`), never by a failure:
//
// * "wgmma" (bf16, TMA-legal strides): Hopper's tensor cores fed by TMA.
//   Output tiles of 128 rows of C by 128 columns of F, walked by a
//   persistent grid of two blocks an SM.  In each block a producer warp
//   keeps kStages stages of an h tile [128 C, 64 D] and a w tile
//   [64 D, 128 F] in flight with cp.async.bulk.tensor, 128-byte swizzled,
//   each stage completing on an mbarrier; two consumer warpgroups (64 rows
//   of C each) run wgmma m64n128k16 on each stage as it lands, keep the f32
//   sums in registers and hand the stage back through a second mbarrier.
//   The producer runs on into the next tile while the consumers store.
//   w[e] is the [D, F] slab as it lies in memory (F contiguous), so B is
//   MN-major in shared memory and wgmma reads it transposed: w is never
//   copied.  The tensor maps are 3-D over [E, rows, cols] with the caller's
//   strides, so the expert is a coordinate; TMA zero-fills past every edge
//   of C, D and F, and the epilogue stores only the rows and columns that
//   exist.
// * "wgmma_small_c" (the same, C <= 16: a decode step has C = 8): the
//   operands swap, out[e]^T = w[e]^T h[e]^T, so F is wgmma's M (64 rows a
//   block) and C its N (8 or 16): no row of the product is padding.  Each
//   block streams a [64 F, D] slab of w through a deeper ring (kSmallStages
//   stages of 8 KB), so the 320 blocks of the decode shape keep enough
//   bytes of w in flight to read all experts near the memory rate.
// * "simt" (f32, or bf16 whose strides or base TMA cannot take): one block
//   of 256 threads per (F tile, C tile, expert), 64 x 64
//   outputs, each thread a 4 x 4 register tile of f32 sums on the FMA pipes,
//   D in steps of 16 through shared memory.  It holds f32 inputs to the
//   2e-4 contract that TF32 tensor cores would break.
//
// The tensor-core routes sum each output in another order than the plain
// version (f32 sums of bf16 products, 16 at a time): the contract is 1e-2
// relative to the largest value, not equality.
//
// The backward (`moe_gmm_bwd`; no Pallas kernel has this job, the reference
// differentiates its einsums in models/moe.py) is the SIMT kernel twice,
// with the operands read transposed through their strides:
//
//   dh[e] = dout[e] @ w[e]^T   ([C, F] @ [F, D], F summed)
//   dw[e] = h[e]^T @ dout[e]   ([D, C] @ [C, F], C summed)
//
// f32 sums, each output rounded once to the inputs' dtype.  At granite-moe-
// 3b-a800m's training shape (capacity 256: [40, 256, 1536] and [40, 1536,
// 512]) a call reads h, w and dout and writes dh and dw, 199 MB (59.4 us
// at 3.35 TB/s), for 32.2 GFLOP (32.6 us on the bf16 tensor cores): bytes,
// narrowly.  The SIMT kernel runs the products on the f32 pipes (67 TFLOP/s
// at best), far from either bound: the tensor-core routes with the
// transposes taken through the descriptors are later work (ROADMAP.md,
// Kernel follow-ups).
#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is
                   // looked up at run time, so nothing links -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { DT_F32 = 0, DT_BF16 = 1 };
enum { ROUTE_SIMT = 0, ROUTE_WGMMA = 1, ROUTE_SMALL_C = 2 };

// ------------------------------------------------------------------ simt

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

// out[e] [M, N] = a[e] [M, K] @ b[e] [K, N], out contiguous.  a lies along
// K (AK: a[m][k] at m * as + k) or along M (!AK: at k * as + m), b along N
// (BN: b[k][n] at k * bs + n) or along K (!BN: at n * bs + k), so the
// forward and both products of the backward are one kernel: the loaders
// put consecutive threads on the unit-stride axis.
template <typename T, bool AK, bool BN>
__global__ void __launch_bounds__(kThreads)
gmm_simt(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
         int M, int K, int N, long long ase, long long a_s, long long bse,
         long long b_s) {
  __shared__ __align__(16) float hs[kBK][kBM + kPad];  // hs[k][m] = a[m][k]
  __shared__ __align__(16) float ws[kBK][kBN];         // ws[k][n] = b[k][n]
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* ab = a + e * ase;
  const T* bb = b + e * bse;
  // loaders, 4 elements a thread: the a tile is 64 m x 16 k, the b tile
  // 16 k x 64 n
  const int am = AK ? tid / 4 : tid % 64;
  const int ak = AK ? (tid % 4) * 4 : tid / 64 * 4;
  const int bk = BN ? tid / 16 : tid % 16;
  const int bn = BN ? (tid % 16) * 4 : tid / 16 * 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int gm = m0 + am, gk = k0 + ak + u;
      hs[ak + u][am] =
          (gm < M && gk < K)
              ? to_f32(ab[AK ? static_cast<long long>(gm) * a_s + gk
                             : static_cast<long long>(gk) * a_s + gm])
              : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int gk = k0 + bk, gn = n0 + bn + u;
      ws[bk][bn + u] =
          (gk < K && gn < N)
              ? to_f32(bb[BN ? static_cast<long long>(gk) * b_s + gn
                             : static_cast<long long>(gn) * b_s + gk])
              : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 av4 = *reinterpret_cast<const float4*>(&hs[k][ty * 4]);
      const float4 bv4 = *reinterpret_cast<const float4*>(&ws[k][tx * 4]);
      const float av[4] = {av4.x, av4.y, av4.z, av4.w};
      const float bv[4] = {bv4.x, bv4.y, bv4.z, bv4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  T* ob = out + static_cast<long long>(e) * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N) store(ob + static_cast<long long>(row) * N + col,
                         acc[i][j]);
    }
  }
}

template <typename T, bool AK, bool BN>
cudaError_t launch_simt(const void* a, const void* b, void* out, int E, int M,
                        int K, int N, long long ase, long long a_s,
                        long long bse, long long b_s, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, E);
  gmm_simt<T, AK, BN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out),
      M, K, N, ase, a_s, bse, b_s);
  return cudaGetLastError();
}

// The backward of out = h @ w on the SIMT kernel: dh[e] = dout[e] @ w[e]^T
// (w read along its rows, F the reduced axis) and dw[e] = h[e]^T @ dout[e]
// (h read along D, C the reduced axis).
template <typename T>
cudaError_t launch_bwd(const void* h, const void* w, const void* dout,
                       void* dh, void* dw, int E, int C, int D, int F,
                       long long hse, long long hsc, long long wse,
                       long long wsd, long long dose, long long dosc,
                       cudaStream_t stream) {
  cudaError_t err = launch_simt<T, true, false>(dout, w, dh, E, C, F, D, dose,
                                                dosc, wse, wsd, stream);
  if (err != cudaSuccess) return err;
  return launch_simt<T, false, true>(h, dout, dw, E, D, C, F, hse, hsc, dose,
                                     dosc, stream);
}


// ------------------------------------------------------- wgmma + TMA routes

namespace tc {

constexpr int kTM = 128;            // rows of C per tile (two warpgroups)
constexpr int kTN = 128;            // columns of F per tile
constexpr int kTK = 64;             // step along D: one 128-byte swizzle row
constexpr int kStages = 3;          // ring depth
constexpr int kBlocksPerSM = 2;     // what kStages' shared memory allows
constexpr int kConsumerWarps = 8;   // two warpgroups
constexpr int kThreadsTC = 32 * kConsumerWarps + 32;   // + the producer warp
constexpr int kTileA = kTM * kTK * 2;    // 16 KB: h [128 C][64 D]
constexpr int kHalfB = kTK * 64 * 2;     // 8 KB: w [64 D][64 F]
constexpr int kTileB = 2 * kHalfB;       // w [64 D][128 F] as two halves
constexpr int kSmemTC = kStages * (kTileA + kTileB) + 2 * kStages * 8 + 1024;

constexpr int kSmallM = 64;         // columns of F per block (wgmma's M)
constexpr int kSmallStages = 6;
constexpr int kSmallWarps = 4;      // one warpgroup
constexpr int kThreadsSmall = 32 * kSmallWarps + 32;
constexpr int kTileW = kTK * kSmallM * 2;   // 8 KB: w [64 D][64 F]
constexpr int kTileH = 16 * kTK * 2;        // 2 KB: h [<= 16 C][64 D]
constexpr int kSmemSmall =
    kSmallStages * (kTileW + kTileH) + 2 * kSmallStages * 8 + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Spin until the phase of `bar` with this parity has completed.  A wait
// that outlasts 2^26 tries (seconds; a stage lands in microseconds) is a
// broken ring: trap, so that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0, tries = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (++tries == (1u << 26)) __trap();
  } while (!done);
}

// One TMA load of a box of a 3-D map (coordinates innermost first) into
// shared memory, completing on `bar` with the box's bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile whose base is
// 1024-byte aligned (base offset 0).  K-major: rows of 64 bf16 along K,
// `sbo` between groups of 8 rows, `lbo` unused.  MN-major: rows of 64 bf16
// along M or N, one row per k; `sbo` between groups of 8 k, `lbo` between
// 64-wide blocks of M or N.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving the accumulators across an asynchronous
// wgmma (their registers are written behind its back until the wait).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// m64n128k16: A K-major, B MN-major (imm-trans-b 1)
__device__ __forceinline__ void wgmma_n128_bt(float (&d)[64], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// m64n8k16: A MN-major (imm-trans-a 1), B K-major
__device__ __forceinline__ void wgmma_n8_at(float (&d)[4], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

// m64n16k16: A MN-major (imm-trans-a 1), B K-major
__device__ __forceinline__ void wgmma_n16_at(float (&d)[8], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}


// The first 1024-byte boundary at or after p in shared memory: the 128-byte
// swizzle repeats every 8 rows of 128 bytes, and wgmma's descriptors assume
// tiles that start on it.
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          int stages, int consumer_warps) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumer_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// out[e] tiles [128 C, 128 F] = h[e] [128 C, D] @ w[e] [D, 128 F], tile t
// = ((e * tiles_m) + C tile) * tiles_n + F tile.  Each block walks tiles
// blockIdx.x, + gridDim.x, ... (a persistent grid, two blocks an SM): the
// producer runs on into the next tile's stages while the consumers store
// the last one.
__global__ void __launch_bounds__(kThreadsTC, kBlocksPerSM)
gmm_wgmma(const __grid_constant__ CUtensorMap hmap,
          const __grid_constant__ CUtensorMap wmap,
          __nv_bfloat16* __restrict__ out, int E, int C, int D, int F) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sa = align1024(smem_raw);        // kStages x h [128][64]
  uint8_t* sb = sa + kStages * kTileA;      // kStages x w [64][64] x 2
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + kStages * kTileB);
  uint64_t* empty = full + kStages;
  const int tiles_n = (F + kTN - 1) / kTN, tiles_m = (C + kTM - 1) / kTM;
  const int tiles = tiles_n * tiles_m * E;
  const int nk = (D + kTK - 1) / kTK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  init_ring(full, empty, kStages, kConsumerWarps);

  if (warp == kConsumerWarps) {  // the producer: one thread issues TMA
    if (lane == 0) {
      int it = 0;  // k-steps issued by this block, over all its tiles
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int n0 = t % tiles_n * kTN, m0 = t / tiles_n % tiles_m * kTM;
        const int e = t / (tiles_n * tiles_m);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], kTileA + kTileB);
          tma_load(sa + s * kTileA, &hmap, &full[s], kt * kTK, m0, e);
#pragma unroll
          for (int b = 0; b < kTN / 64; ++b)
            tma_load(sb + s * kTileB + b * kHalfB, &wmap, &full[s],
                     n0 + 64 * b, kt * kTK, e);
        }
      }
    }
    return;
  }

  const int wg = warp / 4;  // consumer warpgroup: rows m0 + 64 wg ...
  float acc[kTN / 2];
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int n0 = t % tiles_n * kTN, m0 = t / tiles_n % tiles_m * kTM;
    const int e = t / (tiles_n * tiles_m);
#pragma unroll
    for (int i = 0; i < kTN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const uint8_t* a = sa + s * kTileA + wg * 64 * 128;
      const uint8_t* b = sb + s * kTileB;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kTK / 16; ++k) {  // A: +32 B along K; B: +16 rows
        const uint64_t da = desc_sw128(a + 32 * k, 0, 1024);
        const uint64_t db = desc_sw128(b + 2048 * k, kHalfB, 1024);
        wgmma_n128_bt(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release it
      fence_regs(acc);
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);

    // acc[4 j + 2 i + c] holds row lane/4 + 8 i of this warp's 16 rows,
    // column 8 j + 2 (lane % 4) + c.
    const int row0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
    const int col0 = n0 + 2 * (lane % 4);
    __nv_bfloat16* ob = out + static_cast<long long>(e) * C * F;
#pragma unroll
    for (int j = 0; j < kTN / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i, col = col0 + 8 * j;
        if (row >= C || col >= F) continue;
        __nv_bfloat16* p = ob + static_cast<long long>(row) * F + col;
        const float v0 = acc[4 * j + 2 * i], v1 = acc[4 * j + 2 * i + 1];
        if ((F & 1) == 0) {  // col is even, so the pair is 4-byte aligned
          *reinterpret_cast<__nv_bfloat162*>(p) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          p[0] = __float2bfloat16_rn(v0);
          if (col + 1 < F) p[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// out[e]^T tile [64 F, NB C] = w[e]^T [64 F, D] @ h[e]^T [D, NB C], C <= NB.
template <int NB>
__global__ void __launch_bounds__(kThreadsSmall)
gmm_wgmma_small_c(const __grid_constant__ CUtensorMap hmap,
                  const __grid_constant__ CUtensorMap wmap,
                  __nv_bfloat16* __restrict__ out, int E, int C, int D,
                  int F) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sw = align1024(smem_raw);          // kSmallStages x w [64][64]
  uint8_t* sh = sw + kSmallStages * kTileW;   // kSmallStages x h [NB][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(sh + kSmallStages * kTileH);
  uint64_t* empty = full + kSmallStages;
  const int e = blockIdx.z, m0 = blockIdx.x * kSmallM;
  const int nk = (D + kTK - 1) / kTK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  init_ring(full, empty, kSmallStages, kSmallWarps);

  if (warp == kSmallWarps) {
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kSmallStages;
        mbar_wait(&empty[s], ((kt / kSmallStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kTileW + NB * kTK * 2);
        tma_load(sw + s * kTileW, &wmap, &full[s], m0, kt * kTK, e);
        tma_load(sh + s * kTileH, &hmap, &full[s], kt * kTK, 0, e);
      }
    }
    return;
  }

  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kSmallStages;
    mbar_wait(&full[s], (kt / kSmallStages) & 1);
    const uint8_t* a = sw + s * kTileW;
    const uint8_t* b = sh + s * kTileH;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kTK / 16; ++k) {  // A: +16 rows along K; B: +32 B
      const uint64_t da = desc_sw128(a + 2048 * k, kTileW, 1024);
      const uint64_t db = desc_sw128(b + 32 * k, 0, 1024);
      if constexpr (NB == 8)
        wgmma_n8_at(acc, da, db);
      else
        wgmma_n16_at(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % kSmallStages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // acc[4 j + 2 i + c]: F index lane/4 + 8 i of this warp's 16, C index
  // 8 j + 2 (lane % 4) + c.
  const int f0 = m0 + warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  __nv_bfloat16* ob = out + static_cast<long long>(e) * C * F;
#pragma unroll
  for (int j = 0; j < NB / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int f = f0 + 8 * i, cc = c0 + 8 * j + c;
        if (f < F && cc < C)
          ob[static_cast<long long>(cc) * F + f] =
              __float2bfloat16_rn(acc[4 * j + 2 * i + c]);
      }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 map over [E, rows, cols] (cols contiguous; strides in elements)
// with boxes of [1, box_rows, 64], 128-byte swizzled, zero fill outside.
bool make_map(CUtensorMap* map, const void* base, int E, int rows, int cols,
              long long s_e, long long s_row, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(s_row) * 2,
                                 static_cast<cuuint64_t>(s_e) * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename K>
cudaError_t launch_tc(K kernel, int smem, dim3 grid, int threads,
                      const CUtensorMap& hmap, const CUtensorMap& wmap,
                      void* out, int E, int C, int D, int F,
                      cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(
      hmap, wmap, static_cast<__nv_bfloat16*>(out), E, C, D, F);
  return cudaGetLastError();
}

// bf16 only; the caller has checked TMA's rules (16-byte aligned bases,
// strides that are multiples of 8 elements, D >= 1).
cudaError_t launch_wgmma(int route, const void* h, const void* w, void* out,
                         int E, int C, int D, int F, long long hse,
                         long long hsc, long long wse, long long wsd,
                         cudaStream_t stream) {
  CUtensorMap hmap, wmap;
  if (route == ROUTE_SMALL_C) {
    const int nb = C <= 8 ? 8 : 16;
    if (C > 16 || !make_map(&hmap, h, E, C, D, hse, hsc, nb) ||
        !make_map(&wmap, w, E, D, F, wse, wsd, kTK))
      return cudaErrorInvalidValue;
    const dim3 grid((F + kSmallM - 1) / kSmallM, 1, E);
    return nb == 8
               ? launch_tc(gmm_wgmma_small_c<8>, kSmemSmall, grid,
                           kThreadsSmall, hmap, wmap, out, E, C, D, F, stream)
               : launch_tc(gmm_wgmma_small_c<16>, kSmemSmall, grid,
                           kThreadsSmall, hmap, wmap, out, E, C, D, F,
                           stream);
  }
  if (!make_map(&hmap, h, E, C, D, hse, hsc, kTM) ||
      !make_map(&wmap, w, E, D, F, wse, wsd, kTK))
    return cudaErrorInvalidValue;
  const long long tiles = static_cast<long long>((F + kTN - 1) / kTN) *
                          ((C + kTM - 1) / kTM) * E;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  const int blocks = static_cast<int>(
      tiles < sms * kBlocksPerSM ? tiles : sms * kBlocksPerSM);
  return launch_tc(gmm_wgmma, kSmemTC, dim3(blocks), kThreadsTC, hmap, wmap,
                   out, E, C, D, F, stream);
}

}  // namespace tc
}  // namespace

extern "C" {

// The backward of moe_gmm_fwd on the SIMT kernel: dh [E, C, D] and dw [E,
// D, F], contiguous, from h and w as moe_gmm_fwd takes them and dout
// [E, C, F] (strides dose, dosc along E and C, unit stride along F), each
// summed in f32 and rounded once to the dtype.  Two launches, dh then dw.
int moe_gmm_bwd(const void* h, const void* w, const void* dout, void* dh,
                void* dw, int E, int C, int D, int F, long long hse,
                long long hsc, long long wse, long long wsd, long long dose,
                long long dosc, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0) return 0;
  if (E > 65535 || (C + kBM - 1) / kBM > 65535 ||
      (D + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    err = launch_bwd<float>(h, w, dout, dh, dw, E, C, D, F, hse, hsc, wse,
                            wsd, dose, dosc, s);
  else if (dtype == DT_BF16)
    err = launch_bwd<__nv_bfloat16>(h, w, dout, dh, dw, E, C, D, F, hse, hsc,
                                    wse, wsd, dose, dosc, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}

// Strides are in elements: hse, hsc of h along E and C; wse, wsd of w along
// E and D (the last axes have stride 1).  dtype: 0 f32, 1 bf16 (h, w and
// out alike).  route: 0 the SIMT kernel (f32 or bf16), 1 wgmma + TMA, 2 its
// small-C variant (C <= 16); 1 and 2 take bf16 with 16-byte aligned bases,
// strides that are multiples of 8 elements and D >= 1 (kernels/moe_gmm.py
// `route` checks this before the launch).  Returns cudaGetLastError() after
// the launch; cudaErrorInvalidValue for a dtype or route the kernels do not
// take, a tensor map cuTensorMapEncodeTiled refuses, or a grid the card
// cannot launch.
int moe_gmm_fwd(const void* h, const void* w, void* out, int E, int C, int D,
                int F, long long hse, long long hsc, long long wse,
                long long wsd, int dtype, int route, int device,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (E <= 0 || C <= 0 || F <= 0) return 0;
  if (E > 65535 || (C + kBM - 1) / kBM > 65535 || D < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_WGMMA || route == ROUTE_SMALL_C) {
    if (dtype != DT_BF16 || D == 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(tc::launch_wgmma(route, h, w, out, E, C, D, F,
                                             hse, hsc, wse, wsd, s));
  }
  if (route != ROUTE_SIMT) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DT_F32)
    err = launch_simt<float, true, true>(h, w, out, E, C, D, F, hse, hsc,
                                         wse, wsd, s);
  else if (dtype == DT_BF16)
    err = launch_simt<__nv_bfloat16, true, true>(h, w, out, E, C, D, F, hse,
                                                 hsc, wse, wsd, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}

const char* moe_gmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
