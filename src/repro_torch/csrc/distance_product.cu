// The distance product (K1g) for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel repro/kernels/ca_mmm.py:ca_gemm_program for
// semiring="min_plus" (body _program_kernel, its (min, +) step at
// ca_mmm.py:190-197):
//   C[i, j] = min_k (A[i, k] + B[k, j])
// A (m, k) and B (k, n) row-major, each fp32 or bf16 (widened to fp32 as it
// is staged), C (m, n) fp32.  The sum starts at +inf; out-of-range A and B
// elements (the k edge among them) are written as +inf, never 0 (the zero
// fill of cp.async or TMA is the plus_times mask only, ca_mmm.py:180-188),
// so a padded lane pairs +inf with +inf and never wins a minimum; each term
// is acc = min.NaN(acc, a + b), an fp32 add rounded to nearest, then a PTX
// min that propagates NaN as the reference's jnp.minimum does (fminf would
// drop it).  fp32 adds and minima are exact and order-free, so the result is
// the plain version's bit for bit.
//
// What bounds it on the H100: no tensor core computes (min, +), so every
// term is two FP32 instructions, an FADD and an FMNMX.  An SM issues four
// warp instructions a clock (one a scheduler) and its FMNMX pipe takes 64
// lanes a clock, so both allow m n k / 64 terms a clock per SM: 4.1 ms at
// m = n = k = 4096 on 132 SMs at 1.98 GHz.  The bytes (3 n^2 fp32 at
// 3.35 TB/s, 0.06 ms there) are far below.  Every other instruction (a
// shared-memory load, an address, a barrier) costs the kernel directly, so
// the design is about issuing little else.
//
// Design: a register-blocked SIMT tile.
//  - A CTA of 256 threads owns a 128 x 128 C tile; each thread keeps an
//    8 x 8 block of it in 64 fp32 registers, as two 4-row strips (rows
//    4 ty + i and 64 + 4 ty + i) by two 4-column strips (4 tx + j and
//    64 + 4 tx + j), so that a k step reads its 8 A and 8 B values as four
//    16-byte shared loads (LDS.128) for 64 terms (128 FP instructions).
//  - A is staged k-major (transposed) in shared memory, its rows padded by
//    4 floats so that the transposed writes fall in distinct banks; B is
//    staged as it is stored.  A warp's A reads are two broadcast addresses,
//    its B reads 256 contiguous bytes: no bank conflict either way.
//  - A ring of two shared slabs of BK = 32 rows of k (16 where a thread
//    would stage more than 4 registers: fp32 A with bf16 B, and scalar
//    loads), one __syncthreads a slab, the BK steps unrolled.  The next
//    slab comes in while this one's products run: A (which it transposes)
//    and bf16 B (which it widens) in pieces of 8 rows of k, each piece's
//    global loads in flight in registers during 8 k steps, then stored
//    into the other slab; fp32 B by 16-byte cp.async, the whole slab's
//    copies issued at its start and waited for before the barrier.  The
//    fragments of step kk + 1 are read from shared memory while step kk
//    computes.
//  - At most 128 registers a thread (__launch_bounds__(256, 2)), so two
//    CTAs share an SM: 16 warps to hide the shared-memory latency; every
//    instantiation fits without spills (-Xptxas -v).
//  - Vector loads and stores where k and n are multiples of 4 and the
//    operands' bases allow them (a vector then lies wholly inside or
//    outside the matrix); scalar ones otherwise.
// The alternatives measured against it (shallower slabs, B through
// registers, no fragment prefetch, a stage-free loop) and the issue rate
// of an FADD + FMNMX stream alone: tools/k1g_probe.py, PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // C rows a CTA owns
constexpr int BN = 128;      // C columns a CTA owns
constexpr int PIECE = 8;     // rows of k a thread stages at a time
constexpr int RING = 2;      // shared slabs
constexpr int THREADS = 256;
constexpr int TM = 8;        // C rows a thread owns (two strips of 4)
constexpr int TN = 8;        // C columns a thread owns (two strips of 4)
constexpr int APAD = 4;      // floats padding each k-major A row
constexpr int AS = BM + APAD;  // a k-major A row's floats
// Rows of k a shared slab holds: 32 where a thread stages at most 4
// registers a piece (vector loads of fp32 A or bf16 A, with bf16 B or fp32
// B by cp.async), else 16 (fp32 A with bf16 B: 6; scalar loads: 8), which
// keeps every instantiation within 128 registers without spills.
template <bool A_F32, bool B_F32, bool VEC>
__host__ __device__ constexpr int slab_rows() { return VEC && !(A_F32 && !B_F32) ? 32 : 16; }
// Shared memory: RING slabs, each BK k-major A rows and BK B rows.
template <bool A_F32, bool B_F32, bool VEC>
__host__ __device__ constexpr int smem_bytes() {
  return RING * slab_rows<A_F32, B_F32, VEC>() * (AS + BN) * 4;
}

constexpr uint32_t BF16_INF2 = 0x7f807f80u;  // two bf16 +inf

// min(acc, v), NaN in either propagating (min.NaN, sm_80+).
__device__ __forceinline__ float min_nan(float acc, float v) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(acc), "f"(v));
  return r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An asynchronous 16-byte copy global -> shared (no registers).
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// A bf16 is the top half of its fp32.
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

template <bool F32>
__device__ __forceinline__ float load1(const void* p, long long i) {
  if constexpr (F32)
    return static_cast<const float*>(p)[i];
  else
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// Four consecutive elements of one operand row in registers, on their way
// to shared memory: a 16-byte vector of fp32, an 8-byte vector of bf16
// (widened as it is stored), or four scalars; +inf out of range.
template <bool F32, bool VEC>
struct Four {
  float f[4];
  __device__ __forceinline__ void load(const void* p, long long i, bool in, int valid) {
    if constexpr (VEC) {
      const float4 x = in ? *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i)
                          : make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, CUDART_INF_F);
      f[0] = x.x;
      f[1] = x.y;
      f[2] = x.z;
      f[3] = x.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) f[j] = j < valid ? load1<F32>(p, i + j) : CUDART_INF_F;
    }
  }
  __device__ __forceinline__ float at(int j) const { return f[j]; }
};

template <>
struct Four<false, true> {
  uint2 w;
  __device__ __forceinline__ void load(const void* p, long long i, bool in, int) {
    w = in ? *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p) + i)
           : make_uint2(BF16_INF2, BF16_INF2);
  }
  __device__ __forceinline__ float at(int j) const {
    const uint32_t x = j < 2 ? w.x : w.y;
    return j % 2 ? bf16_hi(x) : bf16_lo(x);
  }
};

// One CTA: the (BM, BN) C tile at (blockIdx.y, blockIdx.x).  A_F32 / B_F32:
// the operands' element types (fp32, else bf16); VEC: k % 4 == 0,
// n % 4 == 0 and the bases aligned to a vector.
template <bool A_F32, bool B_F32, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
    distance_product_kernel(const void* __restrict__ a, const void* __restrict__ b,
                            float* __restrict__ out, int m, int n, int k) {
  constexpr int BK = slab_rows<A_F32, B_F32, VEC>();
  constexpr int SLAB = BK * (AS + BN);
  // fp32 B in 16-byte vectors goes global -> shared by cp.async; A (to be
  // transposed), bf16 B (to be widened) and scalar loads through registers.
  constexpr bool ASYNC_B = B_F32 && VEC;
  static_assert(BK % PIECE == 0 && BK % 2 == 0, "a slab holds whole pieces");
  extern __shared__ __align__(16) float smem[];  // [RING][SLAB]: A k-major [BK][AS], then B [BK][BN]
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  // Staging a piece of PIECE rows of k: this thread's 4 A elements (row ar,
  // k columns 4 aq ..) and 4 B elements (k row br, columns 4 bc ..).
  const int ar = tid >> 1, aq = tid & 1;
  const int br = tid >> 5, bc = tid & 31;
  const int a_row = row0 + ar, b_col = col0 + 4 * bc;
  Four<A_F32, VEC> ra;
  Four<B_F32, VEC> rb;

  // A piece's element slots in slab `buf`: A transposed, B as stored.
  auto a_slot = [&](int buf, int pc, int j) { return smem + buf * SLAB + (pc * PIECE + 4 * aq + j) * AS + ar; };
  auto b_slot = [&](int buf, int pc) { return smem + buf * SLAB + BK * AS + (pc * PIECE + br) * BN + 4 * bc; };
  // fp32 B by cp.async, +inf stored directly out of range (cp.async's zero
  // fill is the plus_times mask, not this one).
  auto issue_b = [&](int buf, int pc, int k0) {
    const int r = k0 + br;
    float* dst = b_slot(buf, pc);
    if (r < k && b_col < n)
      cp_async16(dst, static_cast<const float*>(b) + (long long)r * n + b_col);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, CUDART_INF_F);
  };
  // The other operands through registers, bf16 widened as it is stored:
  // global -> registers for the piece at k0 (+inf out of range), then
  // registers -> piece `pc` of slab `buf`.
  auto load = [&](int k0) {
    const int c = k0 + 4 * aq, r = k0 + br;
    ra.load(a, (long long)a_row * k + c, a_row < m && c < k, a_row < m ? k - c : 0);
    if constexpr (!ASYNC_B) rb.load(b, (long long)r * n + b_col, r < k && b_col < n, r < k ? n - b_col : 0);
  };
  auto store = [&](int buf, int pc) {
#pragma unroll
    for (int j = 0; j < 4; ++j) *a_slot(buf, pc, j) = ra.at(j);
    if constexpr (!ASYNC_B)
      *reinterpret_cast<float4*>(b_slot(buf, pc)) = make_float4(rb.at(0), rb.at(1), rb.at(2), rb.at(3));
  };
  // The 8 A and 8 B values of k step kk of slab `buf`: four 16-byte loads.
  auto frag = [&](int buf, int kk, float* fa, float* fb) {
    const float* As = smem + buf * SLAB + kk * AS;
    const float* Bs = smem + buf * SLAB + BK * AS + kk * BN;
    const float4 a0 = *reinterpret_cast<const float4*>(As + 4 * ty);
    const float4 a1 = *reinterpret_cast<const float4*>(As + 64 + 4 * ty);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + 4 * tx);
    const float4 b1 = *reinterpret_cast<const float4*>(Bs + 64 + 4 * tx);
    fa[0] = a0.x; fa[1] = a0.y; fa[2] = a0.z; fa[3] = a0.w;
    fa[4] = a1.x; fa[5] = a1.y; fa[6] = a1.z; fa[7] = a1.w;
    fb[0] = b0.x; fb[1] = b0.y; fb[2] = b0.z; fb[3] = b0.w;
    fb[4] = b1.x; fb[5] = b1.y; fb[6] = b1.z; fb[7] = b1.w;
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = CUDART_INF_F;

  const int nslabs = (k + BK - 1) / BK;
  if (nslabs > 0) {
#pragma unroll
    for (int pc = 0; pc < BK / PIECE; ++pc) {
      if constexpr (ASYNC_B) issue_b(0, pc, pc * PIECE);
      load(pc * PIECE);
      store(0, pc);
    }
    if constexpr (ASYNC_B) {
      cp_async_commit();
      cp_async_wait_all();
    }
  }
  __syncthreads();
  for (int s = 0; s < nslabs; ++s) {
    const int buf = s & 1;
    const bool more = s + 1 < nslabs;
    // The next slab's B copies, all in flight during this slab's products;
    // the other slab is free since the last barrier.
    if constexpr (ASYNC_B) {
      if (more) {
#pragma unroll
        for (int pc = 0; pc < BK / PIECE; ++pc) issue_b(buf ^ 1, pc, (s + 1) * BK + pc * PIECE);
        cp_async_commit();
      }
    }
    float fa[2][TM], fb[2][TN];
    frag(buf, 0, fa[0], fb[0]);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      // Operands through registers: the next slab's pieces one in flight at
      // a time, loaded as a piece's rows of this slab start and stored as
      // they end.
      if (more && kk % PIECE == 0) load((s + 1) * BK + kk);
      if (kk + 1 < BK) frag(buf, kk + 1, fa[(kk + 1) & 1], fb[(kk + 1) & 1]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = min_nan(acc[i][j], __fadd_rn(fa[kk & 1][i], fb[kk & 1][j]));
      if (more && kk % PIECE == PIECE - 1) store(buf ^ 1, kk / PIECE);
    }
    if constexpr (ASYNC_B) {
      if (more) cp_async_wait_all();
    }
    __syncthreads();
  }

  // Drain: each C element stored once.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (r >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + 64 * h + 4 * tx;
      float* o = out + (long long)r * n + c;
      if constexpr (VEC) {
        if (c < n) *reinterpret_cast<float4*>(o) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < n) o[j] = acc[i][4 * h + j];
      }
    }
  }
}

template <bool A_F32, bool B_F32, bool VEC>
cudaError_t launch_vec(const void* a, const void* b, float* out, int m, int n, int k, cudaStream_t s) {
  auto kernel = distance_product_kernel<A_F32, B_F32, VEC>;
  constexpr int smem = smem_bytes<A_F32, B_F32, VEC>();
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kernel<<<grid, THREADS, smem, s>>>(a, b, out, m, n, k);
  return cudaGetLastError();
}

template <bool A_F32, bool B_F32>
cudaError_t launch(const void* a, const void* b, float* out, int m, int n, int k, cudaStream_t s) {
  const int va = A_F32 ? 16 : 8, vb = B_F32 ? 16 : 8;
  const bool vec = k % 4 == 0 && n % 4 == 0 && reinterpret_cast<uintptr_t>(a) % va == 0 &&
                   reinterpret_cast<uintptr_t>(b) % vb == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return vec ? launch_vec<A_F32, B_F32, true>(a, b, out, m, n, k, s)
             : launch_vec<A_F32, B_F32, false>(a, b, out, m, n, k, s);
}

}  // namespace

// C entry point: out (m, n) fp32 = min_k (A[i, k] + B[k, j]), A (m, k) and
// B (k, n) row-major, each fp32 (a_f32 = 1, b_f32 = 1) or bf16 (0).  The
// caller checks shapes, types and contiguity; m, n > 0 (k = 0 gives +inf).
// Launches on `stream` without synchronising and returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape past the grid).
extern "C" int distance_product_launch(const void* a, const void* b, void* out, int m, int n,
                                       int k, int a_f32, int b_f32, void* stream) {
  if (m <= 0 || n <= 0 || k < 0 || (m + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a_f32)
    err = b_f32 ? launch<true, true>(a, b, o, m, n, k, s) : launch<true, false>(a, b, o, m, n, k, s);
  else
    err = b_f32 ? launch<false, true>(a, b, o, m, n, k, s) : launch<false, false>(a, b, o, m, n, k, s);
  return static_cast<int>(err);
}
