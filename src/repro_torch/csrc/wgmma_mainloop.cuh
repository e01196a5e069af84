// TMA + WGMMA main loop for Hopper (sm_90a), shared by the CA-GEMM program
// kernel's bf16 route (ca_gemm_program.cu, K1) and the k-outer ablation's
// bf16 step (ca_mmm_k_outer.cu, K4), so that the two schedules differ only
// in where C lives.
//
// The paper's schedule on this card.  One CTA owns a BM x BN output tile.
// Its fp32 accumulators stay in the registers of its two consumer
// warpgroups (rows 0-63 and 64-127 of the tile) for the whole k loop.  The
// A and B panels stream through a ring of shared-memory stages, BK = 64
// rows of k a stage, loaded by TMA (cp.async.bulk.tensor, issued by one
// thread of a producer warp or warpgroup) with the 128-byte swizzle wgmma
// reads.  Each
// stage has a full mbarrier (the TMA's bytes arrived) and an empty one (all
// 256 consumer threads are done with it).  The product is
// wgmma.mma_async bf16 x bf16 -> fp32, four k16 steps a stage; one stage's
// wgmma group stays in flight while the next stage is waited on; over a
// long k loop the products are added into the fp32 accumulator every 4
// stages with a rounded add (see PROMOTE).  The caller's drain runs once,
// after the last stage.
//
// Layouts.  wgmma reads an operand in shared memory K-major or, through its
// transpose bit, M-major (A) or N-major (B).  So each stored layout gets its
// own TMA box and descriptor, and no operand is transposed in memory:
//   A (m, k) row-major (nn, nt)   K-major: one box of 64 k x 128 rows
//   A stored (k, m) (tn, tt)      M-major: two boxes of 64 m x 64 k
//   B (k, n) row-major (nn, tn)   N-major: BN / 64 boxes of 64 n x 64 k
//   B stored (n, k) (nt, tt)      K-major: one box of 64 k x BN rows
// Each 128-byte row of a box holds 64 bf16, and 8 rows form the 1024-byte
// swizzle atom: 16-byte chunk c of row r lands at chunk c ^ (r % 8).
// K-major descriptors: stride 1024 B between 8-row groups, +32 B a k16
// step.  M- and N-major: 1024 B between 8-row groups of k, 8192 B to the
// next 64-wide box, +2048 B a k16 step.  Box elements past the tensor's
// edge arrive as zeros, which is the plus_times k mask: ragged m, n and k
// need no mask in the loop.
//
// An optional fp32 tile (the dact prologue's pre-activation, shaped like
// the decorated operand) rides each stage beside the operands, unswizzled.
// A consumer-side rewrite of the arrived stage (the prologues) runs before
// the stage's wgmma; it fences the generic-proxy writes into the async
// proxy and syncs the 256 consumer threads itself.
//
// Tensor maps are encoded on the host (cuTensorMapEncodeTiled, looked up
// through the CUDA runtime, so nothing links libcuda) and passed to the
// kernel as __grid_constant__ parameters.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wgmma_ml {

constexpr int BM = 128;                  // two consumer warpgroups of 64 rows
constexpr int BK = 64;                   // k rows a stage: one swizzle row of bf16
constexpr int CONSUMERS = 256;
// Threads of a CTA: the two consumer warpgroups and a producer warp, or
// (WIDE) a producer warpgroup that hands its registers to the consumers
// with setmaxnreg, for consumers that keep two accumulators (PROMOTE).  The
// register file is shared out by warpgroups, so 288 threads are charged as
// 384 and cap a thread at 168 registers; the wide form raises the
// consumers to 232 (2 x 128 x 232 + 128 x 40 = 64,512 of 65,536).
constexpr int THREADS = CONSUMERS + 32;
constexpr int WIDE_THREADS = CONSUMERS + 128;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int MAX_STAGES = 6;
constexpr int RING_BYTES = 192 * 1024;   // the stages together, at most
constexpr int SMEM_BYTES = RING_BYTES + 1024;  // the most a ring takes
constexpr int BOX_BYTES = 64 * 64 * 2;   // one 64 x 64 bf16 box

// The fp32 tile streamed beside the operands, if any.
enum Extra { EXTRA_NONE = 0, EXTRA_A = 1, EXTRA_B = 2 };

// One stage of the ring: A (BM x BK), NB B tiles (BK x BN), the extra tile.
template <int BN, int NB>
struct Stage {
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  __host__ __device__ static int bytes(int extra) {
    return A_BYTES + NB * B_BYTES + (extra == EXTRA_A ? BM * BK * 4 : extra == EXTRA_B ? BK * BN * 4 : 0);
  }
  // Stages of the ring for nslabs stages of k: as many as fit, at most
  // MAX_STAGES, and no more than the loop has, so that a short loop (K4's
  // one-stage steps) leaves shared memory for more CTAs an SM.
  __host__ __device__ static int stages(int extra, int nslabs) {
    int s = RING_BYTES / bytes(extra);
    s = s < MAX_STAGES ? s : MAX_STAGES;
    return nslabs < 1 ? 1 : nslabs < s ? nslabs : s;
  }
  // Dynamic shared memory of the kernel: the ring, plus slack to align it.
  __host__ __device__ static int smem_bytes(int extra, int nslabs) {
    return stages(extra, nslabs) * bytes(extra) + 1024;
  }
};

struct Maps {
  CUtensorMap a;
  CUtensorMap b[2];
  CUtensorMap extra;
};

// ---------------------------------------------------------------------------
// Device side
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Box at (c0, c1) (innermost coordinate first) of `map` into `dst`; its
// bytes complete on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// The 256 consumer threads (named barrier 1; the producer is not in it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across the async
// products.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// D (64 x 128 fp32, 64 registers a thread) (+)= A (64 x 16) B (16 x 128), bf16
// in shared memory through the descriptors; scale_d = 0 overwrites D.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x 64 fp32, 32 registers a thread) (+)= A (64 x 16) B (16 x 64).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// The ring of one CTA: stage s of the k loop sits at stage s % count.
struct Ring {
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  int stage_bytes;
  int count;
};

// Shared memory a kernel declares for the ring: the stages (dynamic,
// aligned here to the 1024-byte swizzle atom) and their barriers.
__device__ __forceinline__ Ring make_ring(uint8_t* dyn, uint64_t* full, uint64_t* empty,
                                          int stage_bytes, int count) {
  const uint32_t a = smem_u32(dyn);
  Ring r{dyn + ((1024 - (a & 1023)) & 1023), full, empty, stage_bytes, count};
  if (threadIdx.x == 0) {
    for (int i = 0; i < count; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  return r;
}

// The producer (one thread): slabs k0 + s BK, s < nslabs, of the CTA's row
// block row0 and column block col0.  TA: A stored (k, m); TB: B stored (n, k).
template <int BN, int NB, bool TA, bool TB>
__device__ void produce(const Maps& maps, int extra, const Ring& ring, int row0, int col0, int k0,
                        int nslabs) {
  using S = Stage<BN, NB>;
  for (int s = 0; s < nslabs; ++s) {
    const int st = s % ring.count;
    mbar_wait(&ring.empty[st], ((s / ring.count) & 1) ^ 1);
    uint64_t* bar = &ring.full[st];
    uint8_t* a = ring.base + st * ring.stage_bytes;
    uint8_t* b = a + S::A_BYTES;
    uint8_t* x = b + NB * S::B_BYTES;
    const int kk = k0 + s * BK;
    // Whole boxes arrive, zero-filled past the edges, so every stage
    // carries the same byte count.
    mbar_expect_tx(bar, ring.stage_bytes);
    if constexpr (TA) {
      tma_load(a, &maps.a, bar, row0, kk);
      tma_load(a + BOX_BYTES, &maps.a, bar, row0 + 64, kk);
    } else {
      tma_load(a, &maps.a, bar, kk, row0);
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      uint8_t* bi = b + i * S::B_BYTES;
      if constexpr (TB) {
        tma_load(bi, &maps.b[i], bar, kk, col0);
      } else {
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) tma_load(bi + j * BOX_BYTES, &maps.b[i], bar, col0 + 64 * j, kk);
      }
    }
    if (extra == EXTRA_A)
      tma_load(x, &maps.extra, bar, kk, row0);   // (m, k) fp32
    else if (extra == EXTRA_B)
      tma_load(x, &maps.extra, bar, col0, kk);   // (k, n) fp32
  }
}

// Stages a wgmma accumulator sums before it is added into the fp32
// accumulator (256 rows of k), where the loop promotes.  The tensor cores' own fp32 sums lose low
// bits as they go: left to sum all of k, the error against the plain
// version grows in proportion to k (1.4e-5 at k = 2048, 6.1e-4 at
// k = 100352 with outputs near 5; NVIDIA H100 80GB HBM3, 700 W).  So each
// run of PROMOTE stages is summed there and then joins acc with one
// rounded fp32 add.
constexpr int PROMOTE = 4;

template <bool P, typename T>
__device__ __forceinline__ T& pick(T& a, T& b) {
  if constexpr (P)
    return a;
  else
    return b;
}

// The consumers (threads 0-255): acc[i] (this warpgroup's 64 x BN of branch
// i, zeroed by the caller) += the tile's products over nslabs stages.
// rewrite(a, b, x, s) may change the arrived stage s first; if it writes,
// it fences and calls consumer_sync() itself.  With PROMOTED, each run of
// PROMOTE stages goes into part, which then joins acc (a long k loop);
// without, the products go straight into acc (a short one: K4's steps,
// whose sums join C with a rounded add anyway).  One wgmma group stays in
// flight within a run, and a stage is handed back to the producer as soon
// as its products are done.
template <int BN, int NB, bool TA, bool TB, bool PROMOTED, typename Rewrite>
__device__ void consume(float (&acc)[NB][BN / 2], const Ring& ring, int nslabs, Rewrite&& rewrite) {
  using S = Stage<BN, NB>;
  const int wg = threadIdx.x / 128;
  float own[NB][BN / 2];
  float(&part)[NB][BN / 2] = pick<PROMOTED>(own, acc);
  if constexpr (PROMOTED) {
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) part[i][j] = 0.f;
  }
  int held = -1;  // the slab whose stage is not handed back yet
  for (int s = 0; s < nslabs; ++s) {
    const int st = s % ring.count;
    mbar_wait(&ring.full[st], (s / ring.count) & 1);
    uint8_t* a = ring.base + st * ring.stage_bytes;
    uint8_t* b = a + S::A_BYTES;
    rewrite(a, b, b + NB * S::B_BYTES, s);
    // This warpgroup's 64 rows: rows 64 wg.. of a K-major A, or its M box.
    const uint8_t* aw = a + wg * BOX_BYTES;
    const bool first = PROMOTED && s % PROMOTE == 0;
#pragma unroll
    for (int i = 0; i < NB; ++i) fence_regs(part[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = TA ? smem_desc(aw + kk * 2048, BOX_BYTES, 1024) : smem_desc(aw + kk * 32, 16, 1024);
      const int scale_d = first && kk == 0 ? 0 : 1;  // a run starts from zero
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const uint8_t* bi = b + i * S::B_BYTES;
        const uint64_t db = TB ? smem_desc(bi + kk * 32, 16, 1024) : smem_desc(bi + kk * 2048, BOX_BYTES, 1024);
        if constexpr (BN == 128)
          wgmma_m64n128k16<TA ? 1 : 0, TB ? 0 : 1>(part[i], da, db, scale_d);
        else
          wgmma_m64n64k16<TA ? 1 : 0, TB ? 0 : 1>(part[i], da, db, scale_d);
      }
    }
    wgmma_commit();
#pragma unroll
    for (int i = 0; i < NB; ++i) fence_regs(part[i]);
    if (s == nslabs - 1 || (PROMOTED && s % PROMOTE == PROMOTE - 1)) {
      // The run is done: add it in, hand back its last two stages.
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        fence_regs(part[i]);
        if constexpr (PROMOTED) {
#pragma unroll
          for (int j = 0; j < BN / 2; ++j) acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
        }
      }
      if (held >= 0) mbar_arrive(&ring.empty[held % ring.count]);
      mbar_arrive(&ring.empty[st]);
      held = -1;
    } else {
      // Stage s - 1's products are done: hand its buffers back.
      wgmma_wait<1>();
      if (held >= 0) mbar_arrive(&ring.empty[held % ring.count]);
      held = s;
    }
  }
}

// Row and column of accumulator register j of consumer thread t in the
// tile: wgmma's fragment, 8-column groups of 2 x 2 values a thread.
__device__ __forceinline__ int acc_row(int t, int j) {
  return (t / 128) * 64 + ((t % 128) / 32) * 16 + (t % 32) / 4 + 8 * ((j / 2) % 2);
}
__device__ __forceinline__ int acc_col(int t, int j) { return 8 * (j / 4) + 2 * (t % 4) + j % 2; }

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiled>(f)
                                                                   : nullptr;
  }();
  return fn;
}

// Map of a row-major (rows, cols) tensor, cols contiguous, read in boxes of
// (box_rows, box_cols); bf16 with the 128-byte swizzle, or fp32 unswizzled.
inline bool encode_map(CUtensorMap* map, const void* ptr, bool f32, uint64_t rows, uint64_t cols,
                       uint32_t box_rows, uint32_t box_cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * (f32 ? 4 : 2)};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                f32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The operand maps of one product: A (m, k), or stored (k, m) with ta; B
// (k, n), or stored (n, k) with tb; BN columns of C a CTA.
inline bool encode_operands(Maps* maps, const void* a, const void* const* b, int nb, int m, int n,
                            int k, bool ta, bool tb, int bn) {
  bool ok = ta ? encode_map(&maps->a, a, false, k, m, BK, 64) : encode_map(&maps->a, a, false, m, k, BM, BK);
  for (int i = 0; i < nb; ++i)
    ok = ok && (tb ? encode_map(&maps->b[i], b[i], false, n, k, bn, BK)
                   : encode_map(&maps->b[i], b[i], false, k, n, BK, 64));
  return ok;
}

// TMA's address rules: a 16-byte aligned base and row stride.
inline bool tma_ok(const void* p, long long row_bytes) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && row_bytes % 16 == 0 && row_bytes > 0;
}

}  // namespace wgmma_ml
