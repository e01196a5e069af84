// k-outer ablation GEMM for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel repro/kernels/ca_mmm.py:ca_mmm_k_outer: the
// schedule the paper's I/O model rejects.  k is the outermost loop, so C
// cannot stay in fast memory: every k step reads each C tile from device
// memory, adds the product of one A panel (bm x bk) and one B panel
// (bk x bn), and writes the tile back.  One launch of this kernel is one k
// step over a (n / bn, m / bm) grid; the wrapper launches k / bk of them in
// order, on one stream, so step s + 1 reads what step s wrote.  Shapes are
// tile-divisible (the wrapper checks m % bm, n % bn, k % bk), as the
// reference asserts.
//
// C is fp32 for fp32 and bf16 operands, int32 for int8 (exact sums); the
// cast to the output dtype follows the last step, outside the kernel, as in
// the reference.  Step 0 starts its tiles at zero instead of reading C.
//
// Design.  A CTA of 256 threads owns a (bm, bn) C tile and walks its 64 x 64
// sub-tiles in order; each thread keeps a 4 x 4 block of a sub-tile in
// registers (rows tr + 16 i, columns tc + 16 j, so neighbouring threads
// read neighbouring shared words), reads it from C, streams the step's bk
// rows of k through shared memory 32 at a time (operands widened to the sum's
// type as they are staged), multiplies with fp32 FMAs or int32
// multiply-adds, and writes the block back.  No tensor cores.
//
// The bf16 step at tiles of whole 128 x 128 x 64 blocks (bm, bn multiples
// of 128, bk of 64; the default bf16 tile is K1's, 128 x 128 x 64) runs on
// the TMA + WGMMA main loop K1's bf16 route runs (wgmma_mainloop.cuh): one
// CTA of two consumer warpgroups and a producer warp per 128 x 128 block of
// C, the step's bk rows of k streamed through the ring of TMA stages and
// multiplied by wgmma into fp32 registers from zero; the drain then reads
// the block's C, adds, and writes it back (step 0 writes the product).  So
// K4 and K1's bf16 route stream the same panels through the same loop and
// differ only in where C lives.  fp32 and int8 steps, and bf16 tiles that
// are not whole blocks (multiples of 64 x 64 x 32), take the SIMT step.
//
// What bounds it on the H100.  The product is the GEMM's, 2 m n k operations
// (4096^3 in bf16: 0.139 ms at 989 TFLOP/s); on top of the operands' bytes
// the schedule moves C through device memory twice per step,
// 2 * 4 * m * n * k / bk bytes (at m = n = k = 4096 and bk = 32: 17 GB, 5.1
// ms at 3.35 TB/s), which is the point of the ablation.  This SIMT kernel
// runs far below both bounds; PERF.md has its times beside the k-inner
// kernel's (ca_gemm_program.cu) at the same shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma_mainloop.cuh"

namespace {

// Element types of A and B (the wrapper's _TYPE_CODES).
enum Type { TYPE_F32 = 0, TYPE_BF16 = 1, TYPE_I8 = 2 };

constexpr int SUB = 64;   // sub-tile rows and columns
constexpr int BK = 32;    // k rows staged at a time
constexpr int NT = 256;   // threads: 16 x 16, a 4 x 4 register block each
constexpr int TM = 4, TN = 4, RSTEP = SUB / TM, TCOLS = SUB / TN;

template <typename Acc, typename T>
__device__ __forceinline__ Acc widen(T v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(v);
  else
    return static_cast<Acc>(v);
}

__device__ __forceinline__ float mac(float acc, float a, float b) { return fmaf(a, b, acc); }
__device__ __forceinline__ int mac(int acc, int a, int b) { return acc + a * b; }

// One k step: C[tile] (= 0 at the first step) += A[:, k0:k0+bk] B[k0:k0+bk, :].
template <typename T, typename Acc>
__global__ void __launch_bounds__(NT)
    k_outer_step_kernel(const T* __restrict__ A, const T* __restrict__ B, Acc* __restrict__ C,
                        int n, int k, int k0, int bk, int bm, int bn, int first) {
  __shared__ Acc As[SUB][BK + 1];
  __shared__ Acc Bs[BK][SUB];
  const int tid = threadIdx.x;
  const int tr = tid / TCOLS, tc = tid % TCOLS;
  for (int sr = 0; sr < bm; sr += SUB) {
    for (int sc = 0; sc < bn; sc += SUB) {
      const long long row0 = (long long)blockIdx.y * bm + sr;
      const int col0 = blockIdx.x * bn + sc;
      Acc acc[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = first ? Acc(0) : C[(row0 + tr + i * RSTEP) * n + col0 + tc + j * TCOLS];
      for (int s = k0; s < k0 + bk; s += BK) {
        __syncthreads();  // every thread is done reading the previous slab
#pragma unroll
        for (int t = 0; t < SUB * BK / NT; ++t) {
          const int e = tid + t * NT, r = e / BK, c = e % BK;
          As[r][c] = widen<Acc>(A[(row0 + r) * k + s + c]);
        }
#pragma unroll
        for (int t = 0; t < BK * SUB / NT; ++t) {
          const int e = tid + t * NT, r = e / SUB, c = e % SUB;
          Bs[r][c] = widen<Acc>(B[(long long)(s + r) * n + col0 + c]);
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) {
          Acc av[TM];
#pragma unroll
          for (int i = 0; i < TM; ++i) av[i] = As[tr + i * RSTEP][kk];
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const Acc bv = Bs[kk][tc + j * TCOLS];
#pragma unroll
            for (int i = 0; i < TM; ++i) acc[i][j] = mac(acc[i][j], av[i], bv);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          C[(row0 + tr + i * RSTEP) * n + col0 + tc + j * TCOLS] = acc[i][j];
    }
  }
}

template <typename T, typename Acc>
void launch(const void* a, const void* b, void* c, int m, int n, int k, int k0, int bk, int bm,
            int bn, int first, cudaStream_t stream) {
  const dim3 grid(n / bn, m / bm);
  k_outer_step_kernel<T, Acc><<<grid, NT, 0, stream>>>(static_cast<const T*>(a),
                                                        static_cast<const T*>(b),
                                                        static_cast<Acc*>(c), n, k, k0, bk,
                                                        bm, bn, first);
}

namespace ml = wgmma_ml;

struct StepArgs {
  ml::Maps maps;
  float* c;
  int n, k0, nslabs, first;
};

// One bf16 k step of one 128 x 128 block of C: C = (first ? 0 : C) + the
// step's product, fp32.
__global__ void __launch_bounds__(ml::THREADS, 1) k_outer_wgmma_kernel(const __grid_constant__ StepArgs args) {
  using S = ml::Stage<128, 1>;
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t full[ml::MAX_STAGES], empty[ml::MAX_STAGES];
  const ml::Ring ring = ml::make_ring(dyn_smem, full, empty, S::bytes(ml::EXTRA_NONE),
                                      S::stages(ml::EXTRA_NONE, args.nslabs));
  const int row0 = blockIdx.x * ml::BM, col0 = blockIdx.y * 128;
  if (threadIdx.x >= ml::CONSUMERS) {
    if (threadIdx.x == ml::CONSUMERS)
      ml::produce<128, 1, false, false>(args.maps, ml::EXTRA_NONE, ring, row0, col0, args.k0,
                                        args.nslabs);
    return;
  }
  float acc[1][64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[0][j] = 0.f;
  ml::consume<128, 1, false, false, false>(acc, ring, args.nslabs,
                                          [](uint8_t*, uint8_t*, uint8_t*, int) {});
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < 64; j += 2) {
    const long long idx =
        (long long)(row0 + ml::acc_row(t, j)) * args.n + col0 + ml::acc_col(t, j);
    float2* cp = reinterpret_cast<float2*>(args.c + idx);
    float2 v = make_float2(acc[0][j], acc[0][j + 1]);
    if (!args.first) {
      const float2 old = *cp;   // the C read, before the add
      v = make_float2(__fadd_rn(old.x, v.x), __fadd_rn(old.y, v.y));
    }
    *cp = v;
  }
}

// The wgmma step's tiles: whole 128 x 128 x 64 blocks.
bool wgmma_tile(int bm, int bn, int bk) { return bm % 128 == 0 && bn % 128 == 0 && bk % 64 == 0; }

int launch_wgmma(const void* a, const void* b, void* c, int m, int n, int k, int k0, int bk,
                 int first, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      k_outer_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ml::SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  StepArgs args{};
  const void* bs[1] = {b};
  if (!ml::encode_operands(&args.maps, a, bs, 1, m, n, k, false, false, 128))
    return static_cast<int>(cudaErrorInvalidValue);
  args.c = static_cast<float*>(c);
  args.n = n;
  args.k0 = k0;
  args.nslabs = bk / ml::BK;
  args.first = first;
  const int smem = ml::Stage<128, 1>::smem_bytes(ml::EXTRA_NONE, args.nslabs);
  k_outer_wgmma_kernel<<<dim3(m / 128, n / 128), ml::THREADS, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point: one k step (rows k0 .. k0 + bk of k) of C (m, n) += A (m, k)
// B (k, n), all row-major; C fp32 for fp32 and bf16 A/B, int32 for int8;
// first = 1 starts the tiles at zero (step 0) instead of reading C.  The
// caller checks types, contiguity and divisibility (m % bm, n % bn, k % bk)
// and m, n, k > 0, and gives its route (1 wgmma, 0 SIMT, from
// kernels/ca_mmm.py:k_outer_route): the wgmma step for bf16 at whole
// 128 x 128 x 64 blocks, else the SIMT step, which takes bm and bn
// multiples of 64 and bk of 32; another tile, or another route, returns
// cudaErrorInvalidValue.  Launches on `stream` without synchronising and
// returns cudaGetLastError().
extern "C" int ca_mmm_k_outer_step(const void* a, const void* b, void* c, int m, int n, int k,
                                   int k0, int bk, int bm, int bn, int first, int type,
                                   int route, void* stream) {
  if (bm <= 0 || bn <= 0 || bk <= 0 || m % bm || n % bn || k % bk || k0 % bk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wgmma = type == TYPE_BF16 && wgmma_tile(bm, bn, bk);
  if (route != (wgmma ? 1 : 0)) return static_cast<int>(cudaErrorInvalidValue);
  if (wgmma) return launch_wgmma(a, b, c, m, n, k, k0, bk, first, s);
  if (bm % SUB || bn % SUB || bk % BK) return static_cast<int>(cudaErrorInvalidValue);
  if (type == TYPE_F32)
    launch<float, float>(a, b, c, m, n, k, k0, bk, bm, bn, first, s);
  else if (type == TYPE_BF16)
    launch<__nv_bfloat16, float>(a, b, c, m, n, k, k0, bk, bm, bn, first, s);
  else if (type == TYPE_I8)
    launch<int8_t, int>(a, b, c, m, n, k, k0, bk, bm, bn, first, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
