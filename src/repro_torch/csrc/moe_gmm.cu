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
//   The producer runs on into the next tile while the consumers store,
//   each quad of lanes first trading its bf16 pairs so that a lane writes
//   16 contiguous bytes.
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
// differentiates its einsums in models/moe.py) is two products:
//
//   dh[e] = dout[e] @ w[e]^T   ([C, F] @ [F, D], F summed)
//   dw[e] = h[e]^T @ dout[e]   ([D, C] @ [C, F], C summed)
//
// f32 sums, each output rounded once to the inputs' dtype.  At granite-moe-
// 3b-a800m's training shape (capacity 256: [40, 256, 1536] and [40, 1536,
// 512]) a call reads h, w and dout and writes dh and dw, 199 MB (59.4 us
// at 3.35 TB/s), for 32.2 GFLOP (32.6 us on the bf16 tensor cores): bytes,
// narrowly.  Two routes, chosen by the caller (kernels/moe_gmm.py
// `bwd_route`):
// * "wgmma" (bf16, TMA-legal strides): the forward's kernel, templated on
//   each operand's major-ness, in one launch over both products' tiles.
//   The transposes are taken in the tensor maps and the wgmma descriptors,
//   so no operand is copied: for dh, A is dout K-major (F contiguous, as
//   the forward's h) and B is w^T, K-major because w[e] is [D, F] with F
//   contiguous (wgmma's own layout, no transpose bit); for dw, A is h^T,
//   MN-major (h[e] is [C, D] with D contiguous; bf16 lets wgmma read A
//   transposed from shared memory) and B is dout, MN-major as the
//   forward's w.  At this shape K is short (F = 512 for dh, C = 256 for
//   dw), so each tile's store of its outputs, 94.4 MB in all, is a large
//   share of its time, and on the forward's 128 x 128 tiles, one launch a
//   product, it ran far from its bound.  So the backward takes tiles of
//   256 rows of M (four consumer warpgroups, 4 stages of 48 KB, one block
//   an SM: one B stage feeds 256 rows) over dh's 480 tiles and dw's 960 in
//   one persistent launch, expert by expert (dh's 12, then dw's 24, which
//   read dout[e] again while it is in L2); and each quad of lanes
//   transposes its bf16 pairs in two butterfly rounds of shuffles before
//   the 16-byte stores, where selects by a lane-dependent index had taken
//   a large share of the store's issue slots.  Tried on the card and not
//   kept, as no faster: a cluster of two blocks multicasting A, stores
//   staged in shared memory and written by TMA, streaming stores, no L2
//   promotion, tiles drawn from an atomic ticket.
// * "simt" (f32, or bf16 whose strides or bases TMA cannot take): the SIMT
//   kernel twice, the operands read transposed through their strides, so
//   f32 keeps the 2e-4 contract.
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

constexpr int kTN = 128;            // columns of N per tile
constexpr int kTK = 64;             // step along K: one 128-byte swizzle row
constexpr int kHalf = 64 * kTK * 2; // 8 KB: [64][64], one TMA box
constexpr int kTileB = kTN * kTK * 2;   // 16 KB: B [64 K][128 N]

// A gmm_wgmma launch with WGS consumer warpgroups of 64 rows of M each.
template <int WGS>
struct Ring {
  static constexpr int kTM = 64 * WGS;                   // rows of M a tile
  static constexpr int kStages = WGS == 2 ? 3 : 4;       // ring depth
  static constexpr int kBlocksPerSM = WGS == 2 ? 2 : 1;  // as the ring allows
  static constexpr int kConsumerWarps = 4 * WGS;
  static constexpr int kThreads = 32 * kConsumerWarps + 32;  // + producer
  static constexpr int kTileA = kTM * kTK * 2;           // A [kTM M][64 K]
  static constexpr int kSmem =
      kStages * (kTileA + kTileB) + 2 * kStages * 8 + 1024;
};
// The forward keeps 128 x 128 tiles, two blocks an SM: at the training
// call (C = 256) its w1 and w3 products have 160 tiles of 256 rows each,
// 1.2 waves of 132 SMs.  The backward's one launch has 1440 of them.
constexpr int kFwdWGS = 2;
constexpr int kBwdWGS = 4;

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

// m64n128k16, A and B from shared memory; TA and TB are imm-trans-a and
// imm-trans-b: 1 where that operand lies MN-major (read transposed).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
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
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
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
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
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

// A warp's 16 rows x 128 columns of a tile, rounded to bf16, in 16-byte
// stores (N a multiple of 8): acc[4 j + 2 i + c] holds row row0 + 8 i,
// column n0 + 8 j + 2 (lane % 4) + c.  For each group g of four 8-column
// blocks the quad's bf16 pairs form a 4 x 4 matrix, lane s holding row s
// (its pair of each block); two butterfly rounds (with lane q ^ 2, then
// q ^ 1, trading the two pairs whose block differs from q in that bit)
// transpose it, so that lane q holds block 4 g + q whole: a warp's store
// then writes 8 rows of 64 contiguous bytes, where the pairs as they lie
// would write 8 rows of 16.
__device__ __forceinline__ void store_quads(__nv_bfloat16* ob,
                                            const float (&acc)[kTN / 2],
                                            int row0, int n0, int M, int N) {
  const int q = threadIdx.x % 4;
  const bool hi = q & 2, lo = q & 1;
#pragma unroll
  for (int g = 0; g < kTN / 32; ++g) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t x[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(acc[4 * (4 * g + jj) + 2 * i],
                                  acc[4 * (4 * g + jj) + 2 * i + 1]);
        x[jj] = *reinterpret_cast<const uint32_t*>(&v);
      }
      uint32_t r0 = __shfl_xor_sync(0xffffffffu, hi ? x[0] : x[2], 2);
      uint32_t r1 = __shfl_xor_sync(0xffffffffu, hi ? x[1] : x[3], 2);
      const uint32_t t0 = hi ? r0 : x[0], t1 = hi ? r1 : x[1];
      const uint32_t t2 = hi ? x[2] : r0, t3 = hi ? x[3] : r1;
      r0 = __shfl_xor_sync(0xffffffffu, lo ? t0 : t1, 1);
      r1 = __shfl_xor_sync(0xffffffffu, lo ? t2 : t3, 1);
      uint4 o;  // pair p (columns 2 p, 2 p + 1) of block 4 g + q
      o.x = lo ? r0 : t0;
      o.y = lo ? t1 : r0;
      o.z = lo ? r1 : t2;
      o.w = lo ? t3 : r1;
      const int row = row0 + 8 * i, col = n0 + 8 * (4 * g + q);
      if (row < M && col < N)
        *reinterpret_cast<uint4*>(ob + static_cast<long long>(row) * N +
                                  col) = o;
    }
  }
}

// A warp's 16 rows x 128 columns of a tile where N is odd or not a
// multiple of 8, in bf16 pairs (single values where N is odd).
__device__ __forceinline__ void store_pairs(__nv_bfloat16* ob,
                                            const float (&acc)[kTN / 2],
                                            int row0, int n0, int M, int N) {
  const int col0 = n0 + 2 * (threadIdx.x % 4);
#pragma unroll
  for (int j = 0; j < kTN / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i, col = col0 + 8 * j;
      if (row >= M || col >= N) continue;
      __nv_bfloat16* p = ob + static_cast<long long>(row) * N + col;
      const float v0 = acc[4 * j + 2 * i], v1 = acc[4 * j + 2 * i + 1];
      if ((N & 1) == 0) {  // col is even, so the pair is 4-byte aligned
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
      } else {
        p[0] = __float2bfloat16_rn(v0);
        if (col + 1 < N) p[1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

// One product of a gmm_wgmma launch: out [E, M, N] = A [E, M, K] @
// B [E, K, N], out contiguous (out null: no product).
struct Prod {
  __nv_bfloat16* out;
  int M, K, N;
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// The producer's k-steps of one tile: each stage waits for its slot, then
// TMA brings A [kTM M][64 K] and B [64 K][128 N] into it.  A K-major
// operand is one box of its rows by 64 K; an MN-major one is a box of 64
// K rows by 64 M or N per 64-wide block.
template <int WGS, bool AT, bool BK>
__device__ __forceinline__ void issue_tile(uint8_t* sa, uint8_t* sb,
                                           uint64_t* full, uint64_t* empty,
                                           const CUtensorMap* amap,
                                           const CUtensorMap* bmap, int m0,
                                           int n0, int e, int nk, int& it) {
  using R = Ring<WGS>;
  for (int kt = 0; kt < nk; ++kt, ++it) {
    const int s = it % R::kStages, k0 = kt * kTK;
    mbar_wait(&empty[s], ((it / R::kStages) & 1) ^ 1);
    mbar_expect_tx(&full[s], R::kTileA + kTileB);
    uint8_t* a = sa + s * R::kTileA;
    uint8_t* b = sb + s * kTileB;
    if constexpr (AT) {
#pragma unroll
      for (int h = 0; h < WGS; ++h)
        tma_load(a + h * kHalf, amap, &full[s], m0 + 64 * h, k0, e);
    } else {
      tma_load(a, amap, &full[s], k0, m0, e);
    }
    if constexpr (BK) {
      tma_load(b, bmap, &full[s], k0, n0, e);
    } else {
#pragma unroll
      for (int h = 0; h < kTN / 64; ++h)
        tma_load(b + h * kHalf, bmap, &full[s], n0 + 64 * h, k0, e);
    }
  }
}

// A consumer warpgroup's k-steps of one tile: wgmma m64n128k16 on each
// stage as it lands, the stage handed back once the next one's products
// are issued.  Its 64 rows of M are 8 KB of the stage in either layout:
// 64 rows of 128 B (K-major) or its own box (MN-major).
template <int WGS, bool AT, bool BK>
__device__ __forceinline__ void mma_tile(float (&acc)[kTN / 2],
                                         const uint8_t* sa, const uint8_t* sb,
                                         uint64_t* full, uint64_t* empty,
                                         int nk, int& it, int wg, int lane) {
  using R = Ring<WGS>;
  for (int kt = 0; kt < nk; ++kt, ++it) {
    const int s = it % R::kStages;
    mbar_wait(&full[s], (it / R::kStages) & 1);
    const uint8_t* a = sa + s * R::kTileA + wg * kHalf;
    const uint8_t* b = sb + s * kTileB;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kTK / 16; ++k) {
      // a k16 slice: +32 B along a K-major row, +16 rows (2 KB) of an
      // MN-major box; `lbo` steps between the 64-wide halves of N
      const uint64_t da = AT ? desc_sw128(a + 2048 * k, kHalf, 1024)
                             : desc_sw128(a + 32 * k, 0, 1024);
      const uint64_t db = BK ? desc_sw128(b + 32 * k, 0, 1024)
                             : desc_sw128(b + 2048 * k, kHalf, 1024);
      wgmma_n128<AT ? 1 : 0, BK ? 0 : 1>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    fence_regs(acc);
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % R::kStages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (lane == 0) mbar_arrive(&empty[(it - 1) % R::kStages]);
}

// Tiles [kTM M, 128 N] of out = A @ B for one or two products (p1.out
// null: one), expert by expert: of expert e's tiles, p0's come first, then
// p1's (the backward's dw reads dout[e] while dh's read of it is still in
// L2), each product's M tile by M tile, N tile by N tile.  Block b walks
// tiles b, b + gridDim.x, ... (a persistent grid): the producer runs on
// into the next tile's stages while the consumers store the last one.
// Each operand lies K-major (K contiguous) or MN-major (M or N
// contiguous), and wgmma reads an MN-major operand transposed from shared
// memory (imm-trans 1), so no operand is copied:
//   forward  out = h @ w        A = h K-major,       B = w MN-major;
//   dh       dh = dout @ w^T    A = dout K-major,    B = w K-major;
//   dw       dw = h^T @ dout    A = h MN-major,      B = dout MN-major.
// ATi: product i's A is MN-major; BKi: its B is K-major.  The maps are 3-D
// over [E, rows, cols] of each tensor as it lies: a K-major A's rows are
// M, an MN-major A's rows are K; a K-major B's rows are N, an MN-major B's
// rows are K.
template <int WGS, bool AT0, bool BK0, bool AT1, bool BK1>
__global__ void __launch_bounds__(Ring<WGS>::kThreads,
                                  Ring<WGS>::kBlocksPerSM)
gmm_wgmma(const __grid_constant__ CUtensorMap amap0,
          const __grid_constant__ CUtensorMap bmap0,
          const __grid_constant__ CUtensorMap amap1,
          const __grid_constant__ CUtensorMap bmap1, const Prod p0,
          const Prod p1, int E) {
  using R = Ring<WGS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sa = align1024(smem_raw);          // kStages x A [kTM][64]
  uint8_t* sb = sa + R::kStages * R::kTileA;  // kStages x B [64][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + R::kStages * kTileB);
  uint64_t* empty = full + R::kStages;
  const int tm0 = cdiv(p0.M, R::kTM), tn0 = cdiv(p0.N, kTN);
  const int tm1 = cdiv(p1.M, R::kTM), tn1 = cdiv(p1.N, kTN);
  const int per0 = tm0 * tn0;  // an expert's tiles of p0, then of both
  const int per_e = per0 + (p1.out != nullptr ? tm1 * tn1 : 0);
  const int tiles = per_e * E;
  const int nk0 = cdiv(p0.K, kTK), nk1 = cdiv(p1.K, kTK);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  init_ring(full, empty, R::kStages, R::kConsumerWarps);
  // tile t: whether it is p1's, its first row and column and its expert
  auto where = [&](int t, int& m0, int& n0, int& e) {
    e = t / per_e;
    const int r = t % per_e;
    const bool second = r >= per0;
    const int u = second ? r - per0 : r;
    const int tn = second ? tn1 : tn0;
    n0 = u % tn * kTN;
    m0 = u / tn * R::kTM;
    return second;
  };

  if (warp == R::kConsumerWarps) {  // the producer: one thread issues TMA
    if (lane == 0) {
      int it = 0;  // k-steps issued by this block, over all its tiles
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int m0, n0, e;
        if (where(t, m0, n0, e))
          issue_tile<WGS, AT1, BK1>(sa, sb, full, empty, &amap1, &bmap1, m0,
                                    n0, e, nk1, it);
        else
          issue_tile<WGS, AT0, BK0>(sa, sb, full, empty, &amap0, &bmap0, m0,
                                    n0, e, nk0, it);
      }
    }
    return;
  }

  const int wg = warp / 4;  // consumer warpgroup: rows m0 + 64 wg ...
  float acc[kTN / 2];
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int m0, n0, e;
    const bool second = where(t, m0, n0, e);
#pragma unroll
    for (int i = 0; i < kTN / 2; ++i) acc[i] = 0.f;
    if (second)
      mma_tile<WGS, AT1, BK1>(acc, sa, sb, full, empty, nk1, it, wg, lane);
    else
      mma_tile<WGS, AT0, BK0>(acc, sa, sb, full, empty, nk0, it, wg, lane);
    const Prod p = second ? p1 : p0;
    // acc[4 j + 2 i + c] holds row lane/4 + 8 i of this warp's 16 rows,
    // column 8 j + 2 (lane % 4) + c.
    const int row0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
    __nv_bfloat16* ob = p.out + static_cast<long long>(e) * p.M * p.N;
    if ((p.N & 7) == 0)  // rows 16-byte aligned: whole 16-byte stores
      store_quads(ob, acc, row0, n0, p.M, p.N);
    else
      store_pairs(ob, acc, row0, n0, p.M, p.N);
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

// Launches gmm_wgmma_small_c<NB> over out [E, C, F].
template <typename K>
cudaError_t launch_small(K kernel, dim3 grid, const CUtensorMap& hmap,
                         const CUtensorMap& wmap, void* out, int E, int C,
                         int D, int F, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemSmall);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreadsSmall, kSmemSmall, stream>>>(
      hmap, wmap, static_cast<__nv_bfloat16*>(out), E, C, D, F);
  return cudaGetLastError();
}

// gmm_wgmma over the tiles of p0 and p1 (p1.out null: p0 alone) on a
// persistent grid: one block per tile up to kBlocksPerSM an SM.
template <int WGS, bool AT0, bool BK0, bool AT1, bool BK1>
cudaError_t launch_gemm(const CUtensorMap& amap0, const CUtensorMap& bmap0,
                        const Prod& p0, const CUtensorMap& amap1,
                        const CUtensorMap& bmap1, const Prod& p1, int E,
                        cudaStream_t stream) {
  using R = Ring<WGS>;
  auto tiles_of = [&](const Prod& p) {
    return p.out == nullptr ? 0LL
                            : static_cast<long long>(cdiv(p.M, R::kTM)) *
                                  cdiv(p.N, kTN) * E;
  };
  const long long tiles = tiles_of(p0) + tiles_of(p1);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  const long long most = static_cast<long long>(sms) * R::kBlocksPerSM;
  const int blocks = static_cast<int>(tiles < most ? tiles : most);
  auto kernel = gmm_wgmma<WGS, AT0, BK0, AT1, BK1>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, R::kThreads, R::kSmem, stream>>>(amap0, bmap0, amap1,
                                                    bmap1, p0, p1, E);
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
    return nb == 8 ? launch_small(gmm_wgmma_small_c<8>, grid, hmap, wmap, out,
                                  E, C, D, F, stream)
                   : launch_small(gmm_wgmma_small_c<16>, grid, hmap, wmap,
                                  out, E, C, D, F, stream);
  }
  if (!make_map(&hmap, h, E, C, D, hse, hsc, Ring<kFwdWGS>::kTM) ||
      !make_map(&wmap, w, E, D, F, wse, wsd, kTK))
    return cudaErrorInvalidValue;
  const Prod p{static_cast<__nv_bfloat16*>(out), C, D, F};
  return launch_gemm<kFwdWGS, false, false, false, false>(
      hmap, wmap, p, hmap, wmap, Prod{nullptr, 0, 0, 0}, E, stream);
}

// The backward on the tensor cores, one launch of gmm_wgmma over both
// products' tiles (of each expert dh's first: their K is the longer), on
// maps of the tensors as they lie (bf16, TMA's rules checked by the
// caller):
//   dh [C, D] = dout [C, F] @ w^T [F, D]: A dout K-major (boxes of kTM
//     rows of C), B w K-major (boxes of 128 rows of D), K = F;
//   dw [D, F] = h^T [D, C] @ dout [C, F]: A h MN-major (boxes of 64 rows
//     of C by 64 of D), B dout MN-major (64 rows of C by 64 of F), K = C.
cudaError_t launch_bwd_wgmma(const void* h, const void* w, const void* dout,
                             void* dh, void* dw, int E, int C, int D, int F,
                             long long hse, long long hsc, long long wse,
                             long long wsd, long long dose, long long dosc,
                             cudaStream_t stream) {
  CUtensorMap a0, b0, a1, b1;
  if (!make_map(&a0, dout, E, C, F, dose, dosc, Ring<kBwdWGS>::kTM) ||
      !make_map(&b0, w, E, D, F, wse, wsd, kTN) ||
      !make_map(&a1, h, E, C, D, hse, hsc, kTK) ||
      !make_map(&b1, dout, E, C, F, dose, dosc, kTK))
    return cudaErrorInvalidValue;
  const Prod pdh{static_cast<__nv_bfloat16*>(dh), C, F, D};
  const Prod pdw{static_cast<__nv_bfloat16*>(dw), D, C, F};
  return launch_gemm<kBwdWGS, false, true, true, false>(a0, b0, pdh, a1, b1,
                                                        pdw, E, stream);
}

}  // namespace tc
}  // namespace

extern "C" {

// The backward of moe_gmm_fwd: dh [E, C, D] and dw [E, D, F], contiguous,
// from h and w as moe_gmm_fwd takes them and dout [E, C, F] (strides dose,
// dosc along E and C, unit stride along F), each summed in f32 and rounded
// once to the dtype.  route: 0 the SIMT kernel twice, dh then dw (f32 or
// bf16), 1 one wgmma + TMA launch over both (bf16 whose three inputs have
// 16-byte aligned bases and strides that are multiples of 8 elements;
// kernels/moe_gmm.py `bwd_route` checks this before the launch).
int moe_gmm_bwd(const void* h, const void* w, const void* dout, void* dh,
                void* dw, int E, int C, int D, int F, long long hse,
                long long hsc, long long wse, long long wsd, long long dose,
                long long dosc, int dtype, int route, int device,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0) return 0;
  if (E > 65535 || (C + kBM - 1) / kBM > 65535 ||
      (D + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_WGMMA) {
    if (dtype != DT_BF16) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(tc::launch_bwd_wgmma(h, w, dout, dh, dw, E, C, D,
                                                 F, hse, hsc, wse, wsd, dose,
                                                 dosc, s));
  }
  if (route != ROUTE_SIMT) return static_cast<int>(cudaErrorInvalidValue);
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
