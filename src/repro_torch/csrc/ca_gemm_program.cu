// CA-GEMM program kernel for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel repro/kernels/ca_mmm.py:ca_gemm_program (body
// _program_kernel), for its plus_times programs, in the 'nn' layout:
//   none                      wq / wk / wv and the logits head
//   res (and bias/act/mul)    wo and w_down, residual added in the drain
//   rms>glu.<act>(b0|b1)      SwiGLU gate+up as one dual-branch pass, the
//                             pre-FFN rms_norm folded into the A fetch
//   dqb...                    the same with int8 weights (K1d): int8 B tiles
//                             streamed and widened to fp32 in registers
//   dqab...                   w8a8 (K1e): int8 A and B, int32 products
//                             (both at m <= 8 on the decode route below)
// the tropical distance product (K1g, semiring="min_plus"):
//   none, min_plus            C[i,j] = min_k (A[i,k] + B[k,j]) in fp32
// and the backward programs of training (K1f, the float programs only):
//   nt, tn layouts            dA = dC B^T with B stored (n, k), dB = A^T dC
//                             with A stored (k, m), each read in its stored
//                             layout (no transposed copy)
//   dact.<act>[@b]>...        g * act'(h) folded into the fetch of the
//                             decorated operand (A, or B with @b), h the
//                             saved fp32 pre-activation streamed beside it
//   save_preact               each branch's fp32 value after bias, before
//                             the activation, drained as extra outputs (the
//                             forward GLU of training writes two)
//
// Schedule (the paper's, as on the TPU): one CTA owns a (BM, BN) C tile and
// keeps one accumulator per B branch in registers for the whole k loop;
// A and B panels stream through shared memory one BK slab at a time, the
// next slab's global loads in flight (registers) while the current one is
// multiplied.  The loop over k inside the block takes the place of the TPU's
// sequential k grid axis.  The drain runs once, after the last slab:
// dequant, then act(z + bias) * mul + residual (one branch) or
// act(z0 + bias0) * (z1 + bias1) (glu), all in fp32, then a single
// predicated store per C element.
//
// Quantized programs.  The products accumulate in a per-thread partial: fp32
// for float A (int8 B widens exactly), int32 for int8 A, exact for any
// k < 2^31 / 127^2 = 133,000 (the reference's headroom case is k = 4096).
// The partial is folded into an fp32 accumulator at the end of each
// quantization block (every `scale_block` rows of k, a multiple of 128, so
// each BK slab lies in one block) and at the last slab: converted to fp32,
// times the block's per-tile weight scale row and per-tile activation scale
// where those are per tile (ca_mmm.py:239-248, on every branch).  Without
// per-tile scales there is one fold, at the end.  Per-channel weight scales
// and per-row activation scales multiply the accumulator in the drain, before
// bias, act, mul and residual (ca_mmm.py:272-275).
//
// Ragged m, n and k: out-of-range A and B loads read 0 (the plus_times k
// mask), and the C store is predicated, so each C element is written once.
// The rms prologue multiplies each in-range A element in fp32 by
// row_scale[row] * gain[col] and rounds it back to A's type before the
// product, as ca_mmm.py:204-207 does.
//
// Training programs (K1f) run in their own instantiations of the 64 x 64
// tile, one per float type and branch count (TRAIN below): the layout, the
// dact operand and save_preact are uniform run-time flags there, so every
// combination the reference takes (nn, nt, tn, tt; dact on A or B;
// save_preact on one or two branches) shares 4 instantiations and the
// serving instantiations keep their code.  A transposed operand is loaded
// with neighbouring threads on neighbouring addresses of its stored layout
// (along m for A stored (k, m), along k for B stored (n, k)), and written
// into shared memory in the orientation the product reads; B's shared rows
// are padded by one element so that the column-wise writes of a transposed
// B do not all fall in one bank.  The dact prologue loads the fp32
// pre-activation with the same offsets as the decorated element (0 out of
// range, so the product stays 0 at the k edge), multiplies in fp32 and
// rounds back to the operand's type before the slab enters shared memory,
// as the rms prologue does.  At training shapes (m = 1024 tokens) these
// programs are bound by operations, 2 m n k over 989 TFLOP/s in bf16 (the
// tn program of w_down, 1024 x 5632 x 2048: 24 us), which only wgmma
// reaches: their bf16 launches take the wgmma route below.
//
// Two routes.  A bf16 program (A and B bf16, no dequant) at m > 8 whose TMA'd
// operands have 16-byte aligned bases and row strides runs on the TMA +
// WGMMA main loop of wgmma_mainloop.cuh (ca_gemm_wgmma_kernel below): one
// CTA of two consumer warpgroups and a producer warpgroup (which gives its
// registers to the consumers with setmaxnreg) owns a 128 x 128 C tile
// (128 x 64 with the GLU's two accumulators), its fp32 accumulators in
// registers for the whole k loop, A and B through a ring of TMA stages with
// the 128-byte swizzle; each stored layout (nn, nt, tn, tt) reads its own
// boxes through wgmma's transpose bits.  The tensor cores sum 4 stages
// (256 rows of k) at a time, and each such sum joins the fp32 accumulator
// with a rounded add, so that the error stays within the fp32 tolerance at
// the head's k = 100352.  The prologues (rms; dact on A or B,
// its fp32 pre-activation streamed as a third TMA tile) rewrite each arrived
// stage in shared memory, through the swizzle, before its products, rounding
// to bf16 in the SIMT kernel's order: the consumer threads rather than an A
// from registers (wgmma RS), because dact decorates B as well as A and one
// form serves both.  The drain keeps the SIMT kernel's chain and order.
//
// The decode route: the same bf16 serving programs (nn, no training flag) at
// m <= 8 with the same aligned operands, and the int8 ones (dqb with bf16 A,
// dqab), run a split-k cluster kernel (ca_gemm_decode_kernel below).  They
// are GEMVs bound by B's bytes, so the design is about bytes in flight and
// covering the SMs, not tensor cores.  A CTA of 256 threads owns a strip of
// 64 C columns over a chunk of k: each thread streams vectors of B (16
// bytes, 8 columns, for bf16; 8 bytes, 8 columns, for int8 at m = 1; 4
// bytes at m > 1) U rows deep, so a CTA keeps 16-32 KB of B a branch in
// flight; the small int8 vectors keep int8's partials in few enough
// registers (48-80 a thread at m = 1) for three or more CTAs an SM, so
// that one wave holds every cluster of a narrow n (16-byte int8 vectors
// need 104-255: one or two).  The <= 8 rows of A for the chunk are staged
// once in shared memory, bf16 as fp32 with the rms prologue applied in the
// SIMT kernel's order, int8 as int32; int8 B is widened by byte permutes,
// not conversion instructions (into a float's mantissa for dqb,
// sign-extended for dqab's int32 multiply-adds), which would otherwise
// bound it at 3.35 TB/s of int8.  Per-tile scales (their own
// instantiations, TILE) fold each thread's block partial into an fp32
// accumulator at the block's end (each CTA's chunk a multiple of the
// block); per-channel and per-row scales run in the drain, after the sum,
// which for dqab is int32 through the reduction and exact, so its result
// is the plain version's bit for bit.  So that a narrow n still covers the
// card, k is split over a thread-block cluster of up to 8 CTAs (about two
// CTAs an SM in all); each CTA reduces its k lanes (warp shuffles, then
// the 8 warps in order) and the leader CTA sums the cluster's partials
// through distributed shared memory in rank order, so the result is the
// same run to run (no atomics), then runs the dequant and drain chain once
// and stores each C element once.  A wide n (the head's 1568 strips) takes
// no split.
//
// The route is decided by k1_route and its Python twin
// (kernels/ca_mmm.py:k1_route), nothing else; everything else (fp32, fp32
// A with int8 B, int8 at m > 8, min_plus, training programs at m <= 8,
// misaligned operands) runs the SIMT tile below, whose instantiations and
// code are unchanged.
//
// The distance product (K1g) runs in one instantiation of the 64 x 64 tile
// (MIN_PLUS below): fp32 or bf16 A and B, read through a run-time type flag
// and widened to fp32 as they are staged; the accumulator starts at +inf;
// out-of-range A and B elements (the k edge among them) are filled with +inf,
// not 0, so a padded lane never wins a minimum (ca_mmm.py:175-196); the inner
// step is acc = min(acc, a + b), with a min that propagates NaN as the
// reference's jnp.minimum does (PTX min.NaN; fminf would drop it); the drain
// has no chain and stores fp32.  fp32 adds and minima are exact and
// order-free, so the result is bit-equal to the plain version.  It runs on
// no tensor core: it is bound by its 2 m n k FP32 instructions (an FADD and
// an FMNMX per term), which the SMs issue at 128 lanes a clock each (FMNMX
// at 64): m n k / 64 per SM-clock, 4.1 ms at m = n = k = 4096 on 132 SMs
// at 1.98 GHz.
//
// What bounds it on the H100: at decode (m = 1) every program is bound by
// the weight bytes it must stream.  The GLU streams 2 x 2048 x 5632 x 2 B =
// 46 MB in bf16 (13.8 us at 3.35 TB/s), half that in int8 (6.9 us).  The
// SIMT tile (fp32 FMAs or int32 multiply-adds, no tensor cores) takes
// BN = 16 for m <= 8 (128 CTAs on n = 2048), which leaves it limited by
// shared-memory reads and by the few bytes each SM keeps in flight, far
// below that bound; decode (bf16 and int8) takes the decode route instead.
// The measured times stand in PERF.md.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma_mainloop.cuh"

namespace {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3 };
// Element types of A and B (the wrapper's _TYPE_CODES).
enum Type { TYPE_F32 = 0, TYPE_BF16 = 1, TYPE_I8 = 2 };
// Operand the dact prologue decorates.
enum Dact { DACT_NONE = 0, DACT_A = 1, DACT_B = 2 };

struct Params {
  const void* a;          // (m, k) row-major, TA
  const void* b[2];       // (k, n) row-major, TB, one per branch
  const float* row_scale; // (m,) fp32 rms row factor, or null (no prologue)
  const void* gain;       // (k,) rms gain, fp32 or bf16
  const void* bias[2];    // (n,) per-branch bias, or null
  const void* mul;        // (m, n) gate multiplied after the activation, or null
  const void* residual;   // (m, n) added last, or null
  void* out;              // (m, n), fp32 or bf16
  // Dequant (int8 B only): per branch, the weight scale, (n,) per channel or
  // (ceil(k / scale_block), n) per tile, and for int8 A the activation
  // scale, (m,) per row or (ceil(k / scale_block),) per k-tile; null when
  // the branch has none.
  const float* scale_b[2];
  const float* scale_a[2];
  // Training programs: the dact prologue's fp32 pre-activation, shaped like
  // the decorated operand ((m, k) for A, (k, n) for B), or null; the fp32
  // (m, n) pre-activation outputs of save_preact, per branch, or null.
  const float* preact;
  float* pre_out[2];
  int m, n, k;
  int gain_f32, bias_f32, mul_f32, res_f32, out_f32;
  int act;                // single-branch activation
  int glu_act;            // activation of the glu combine (two branches)
  int scale_block;        // k rows per per-tile scale (0: none per tile)
  int sb_tile, sa_tile;   // scale_b / scale_a per tile
  int trans_a, trans_b;   // A stored (k, m) / B stored (n, k)
  int dact, dact_act;     // Dact operand and its activation
  int a_f32, b_f32;       // min_plus: A / B element type (1 fp32, 0 bf16)
};

template <typename T>
struct Cvt;
template <>
struct Cvt<float> {
  static __device__ __forceinline__ float to(float v) { return v; }
  static __device__ __forceinline__ float from(float v) { return v; }
};
template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from(float v) {
    return __float2bfloat16_rn(v);
  }
};
template <>
struct Cvt<int8_t> {
  static __device__ __forceinline__ float to(int8_t v) { return static_cast<float>(v); }
  static __device__ __forceinline__ int8_t from(float v) { return static_cast<int8_t>(v); }
};

// A product operand widened to the accumulator's type: fp32 for float
// sums, int for the int32 sums of int8 x int8.
template <typename Acc, typename T>
__device__ __forceinline__ Acc widen(T v) {
  if constexpr (std::is_same<Acc, int>::value)
    return static_cast<int>(v);
  else
    return Cvt<T>::to(v);
}

__device__ __forceinline__ float mac(float acc, float a, float b) { return fmaf(a, b, acc); }
__device__ __forceinline__ int mac(int acc, int a, int b) { return acc + a * b; }

// min(acc, a + b) in fp32; NaN in either propagates (min.NaN, sm_80+).
__device__ __forceinline__ float min_plus(float acc, float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(acc), "f"(__fadd_rn(a, b)));
  return r;
}

__device__ __forceinline__ float load_f32(const void* p, long long i, int is_f32) {
  return is_f32 ? static_cast<const float*>(p)[i]
                : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ float act_fn(float x, int act) {
  switch (act) {
    case ACT_RELU:
      return fmaxf(x, 0.f);
    case ACT_GELU: {  // tanh form: jax.nn.gelu's default
      const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
      return 0.5f * x * (1.f + tanhf(inner));
    }
    case ACT_SILU:
      return x / (1.f + expf(-x));
    default:
      return x;
  }
}

// d act(x) / dx in closed form (relu's is 0 at 0, as the reference's is),
// one rounding per operation in the order of the plain version's torch ops
// (kernels/epilogue.py:act_grad): the product with the gradient is rounded
// to the operand's type next, and a last-bit difference here would flip
// that rounding.
__device__ __forceinline__ float act_grad(float x, int act) {
  switch (act) {
    case ACT_RELU:
      return x > 0.f ? 1.f : 0.f;
    case ACT_GELU: {
      const float c = 0.7978845608028654f;
      const float x2 = __fmul_rn(x, x);
      const float t = tanhf(__fmul_rn(c, __fadd_rn(x, __fmul_rn(__fmul_rn(0.044715f, x2), x))));
      const float lhs = __fmul_rn(0.5f, __fadd_rn(1.f, t));
      const float d = __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(0.5f, x), __fsub_rn(1.f, __fmul_rn(t, t))), c),
                                __fadd_rn(1.f, __fmul_rn(static_cast<float>(3.0 * 0.044715), x2)));
      return __fadd_rn(lhs, d);
    }
    case ACT_SILU: {
      const float sg = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
      return __fmul_rn(sg, __fadd_rn(1.f, __fmul_rn(x, __fsub_rn(1.f, sg))));
    }
    default:
      return 1.f;
  }
}

// Bytes of one vector B load: 16 where each thread's share of a B slab
// allows it, else 8 (int8 B in the 64 x 64 x 32 tile: 8 elements a thread).
__host__ __device__ constexpr int vec_bytes(int bytes_per_thread) {
  return bytes_per_thread >= 16 ? 16 : 8;
}

template <int BYTES>
struct VecOf;
template <>
struct VecOf<16> {
  using type = uint4;
};
template <>
struct VecOf<8> {
  using type = uint2;
};
template <>
struct VecOf<4> {
  using type = uint32_t;
};

// Dequant of one accumulator element in the drain: per-channel weight scale,
// then per-row activation scale, each where it is not per tile.
__device__ __forceinline__ float drain_scale(const Params& p, int b, float z, int r, int c) {
  if (p.scale_b[b] != nullptr && !p.sb_tile) z = __fmul_rn(z, p.scale_b[b][c]);
  if (p.scale_a[b] != nullptr && !p.sa_tile) z = __fmul_rn(z, p.scale_a[b][r]);
  return z;
}

// Threads: (BM / TM) x (BN / TN).  Thread (tr, tc) owns rows tr + i*(BM/TM)
// and columns tc + j*(BN/TN) of the C tile, so neighbouring threads read
// neighbouring shared-memory words and store neighbouring C elements.
// TRAIN instantiations (float, scalar B loads) also take the training
// programs' run-time flags: layouts, dact and save_preact.  The MIN_PLUS
// instantiation (fp32 A, B and sums, one branch, scalar loads) is the
// distance product.
template <typename TA, typename TB, int BM, int BN, int BK, int TM, int TN, int NB,
          bool VEC_B, bool TRAIN, bool MIN_PLUS>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    ca_gemm_program_kernel(const Params p) {
  constexpr bool QUANT = std::is_same<TB, int8_t>::value;   // dqb or dqab
  constexpr bool INT_A = std::is_same<TA, int8_t>::value;   // dqab
  using Acc = typename std::conditional<INT_A, int, float>::type;
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int TCOLS = BN / TN;
  constexpr int RSTEP = BM / TM;
  constexpr int A_PER = BM * BK / NT;
  constexpr int B_PER = BK * BN / NT;
  constexpr int VB = vec_bytes(B_PER * static_cast<int>(sizeof(TB)));
  using VecB = typename VecOf<VB>::type;
  constexpr int VW = VB / sizeof(TB);  // elements in one vector
  constexpr int BV_PER = VEC_B ? B_PER / VW : 1;
  constexpr int BS_PER = VEC_B ? 1 : B_PER;
  static_assert((BM * BK) % NT == 0 && (BK * BN) % NT == 0,
                "a tile must split evenly over the threads");
  static_assert(!VEC_B || (B_PER % VW == 0 && BN % VW == 0),
                "vector B loads must split evenly over the threads");
  static_assert(!INT_A || QUANT, "int8 A pairs with int8 B only");
  static_assert(!TRAIN || (!QUANT && !VEC_B), "training programs are float, scalar B");
  static_assert(!MIN_PLUS || (std::is_same<TA, float>::value && std::is_same<TB, float>::value &&
                              NB == 1 && !VEC_B && !TRAIN),
                "the distance product stages fp32, one branch, scalar loads");
  // A transposed B is written column-wise: pad its rows off one bank.
  constexpr int BPAD = TRAIN ? 1 : 0;

  __shared__ TA As[BM][BK + 1];
  __shared__ __align__(16) TB Bs[NB][BK][BN + BPAD];

  const TA* __restrict__ A = static_cast<const TA*>(p.a);
  const int m = p.m, n = p.n, k = p.k;
  const int tid = threadIdx.x;
  const int tr = tid / TCOLS, tc = tid % TCOLS;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const TA zero_a = Cvt<TA>::from(0.f);
  const TB zero_b = Cvt<TB>::from(0.f);

  // part: the products of the current quantization block (all of k for a
  // float program); acc: the folded, rescaled sum (quantized programs only).
  Acc part[NB][TM][TN];
  float acc[NB][TM][TN];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        if constexpr (MIN_PLUS)
          part[b][i][j] = CUDART_INF_F;
        else
          part[b][i][j] = Acc(0);
        acc[b][i][j] = 0.f;
      }

  TA ra[A_PER];
  VecB rbv[NB][BV_PER];
  TB rbs[NB][BS_PER];
  // The dact prologue's pre-activations of this thread's A or B elements.
  float pa[TRAIN ? A_PER : 1];
  float pb[TRAIN ? B_PER : 1];

  // Tile position (row, col) of the A element in load slot e: slots walk
  // the stored layout's contiguous axis (k, or m for A stored (k, m)).
  auto a_pos = [&](int e, int& rl, int& cl) {
    if (TRAIN && p.trans_a) {
      rl = e % BM;
      cl = e / BM;
    } else {
      rl = e / BK;
      cl = e % BK;
    }
  };
  // Tile position (k row, n col) of the B element in load slot e (n, or k
  // for B stored (n, k)).
  auto b_pos = [&](int e, int& rl, int& cl) {
    if (TRAIN && p.trans_b) {
      rl = e % BK;
      cl = e / BK;
    } else {
      rl = e / BN;
      cl = e % BN;
    }
  };

  // Global -> registers for the slab starting at k0; out of range reads 0.
  auto load_slab = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int e = tid + i * NT;
      if constexpr (TRAIN) {
        int rl, cl;
        a_pos(e, rl, cl);
        const int r = row0 + rl, c = k0 + cl;
        const bool in = r < m && c < k;
        ra[i] = in ? A[p.trans_a ? (long long)c * m + r : (long long)r * k + c] : zero_a;
        if (p.dact == DACT_A) pa[i] = in ? p.preact[(long long)r * k + c] : 0.f;
      } else if constexpr (MIN_PLUS) {
        const int r = row0 + e / BK, c = k0 + e % BK;
        ra[i] = (r < m && c < k) ? load_f32(p.a, (long long)r * k + c, p.a_f32) : CUDART_INF_F;
      } else {
        const int r = row0 + e / BK, c = k0 + e % BK;
        ra[i] = (r < m && c < k) ? A[(long long)r * k + c] : zero_a;
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const TB* __restrict__ B = static_cast<const TB*>(p.b[b]);
      if constexpr (TRAIN) {
#pragma unroll
        for (int i = 0; i < BS_PER; ++i) {
          int rl, cl;
          b_pos(tid + i * NT, rl, cl);
          const int r = k0 + rl, c = col0 + cl;
          const bool in = r < k && c < n;
          rbs[b][i] = in ? B[p.trans_b ? (long long)c * k + r : (long long)r * n + c] : zero_b;
          if (b == 0 && p.dact == DACT_B) pb[i] = in ? p.preact[(long long)r * n + c] : 0.f;
        }
      } else if constexpr (VEC_B) {
#pragma unroll
        for (int i = 0; i < BV_PER; ++i) {
          const int v = tid + i * NT;
          const int r = k0 + v / (BN / VW), c = col0 + (v % (BN / VW)) * VW;
          // n % VW == 0, so a vector lies wholly inside or wholly outside.
          rbv[b][i] = (r < k && c < n)
                          ? *reinterpret_cast<const VecB*>(B + (long long)r * n + c)
                          : VecB{};
        }
      } else if constexpr (MIN_PLUS) {
#pragma unroll
        for (int i = 0; i < BS_PER; ++i) {
          const int e = tid + i * NT;
          const int r = k0 + e / BN, c = col0 + e % BN;
          rbs[b][i] = (r < k && c < n) ? load_f32(p.b[b], (long long)r * n + c, p.b_f32)
                                       : CUDART_INF_F;
        }
      } else {
#pragma unroll
        for (int i = 0; i < BS_PER; ++i) {
          const int e = tid + i * NT;
          const int r = k0 + e / BN, c = col0 + e % BN;
          rbs[b][i] = (r < k && c < n) ? B[(long long)r * n + c] : zero_b;
        }
      }
    }
  };

  // Registers -> shared memory, with the rms or dact prologue on the
  // decorated elements.
  auto store_slab = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      int rl, cl;
      a_pos(tid + i * NT, rl, cl);
      TA v = ra[i];
      if constexpr (!INT_A && !MIN_PLUS) {
        if (p.row_scale != nullptr) {
          const int r = row0 + rl, c = k0 + cl;
          if (r < m && c < k) {
            const float f = __fmul_rn(__fmul_rn(Cvt<TA>::to(v), p.row_scale[r]),
                                      load_f32(p.gain, c, p.gain_f32));
            v = Cvt<TA>::from(f);  // rounded back to A's type before the product
          }
        }
      }
      if constexpr (TRAIN) {
        if (p.dact == DACT_A) v = Cvt<TA>::from(__fmul_rn(Cvt<TA>::to(v), act_grad(pa[i], p.dact_act)));
      }
      As[rl][cl] = v;
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if constexpr (TRAIN) {
#pragma unroll
        for (int i = 0; i < BS_PER; ++i) {
          int rl, cl;
          b_pos(tid + i * NT, rl, cl);
          TB v = rbs[b][i];
          if (p.dact == DACT_B) v = Cvt<TB>::from(__fmul_rn(Cvt<TB>::to(v), act_grad(pb[i], p.dact_act)));
          Bs[b][rl][cl] = v;
        }
      } else if constexpr (VEC_B) {
#pragma unroll
        for (int i = 0; i < BV_PER; ++i) {
          const int v = tid + i * NT;
          *reinterpret_cast<VecB*>(&Bs[b][v / (BN / VW)][(v % (BN / VW)) * VW]) =
              rbv[b][i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < BS_PER; ++i) {
          const int e = tid + i * NT;
          Bs[b][e / BN][e % BN] = rbs[b][i];
        }
      }
    }
  };

  // End of a quantization block: acc += part (to fp32, times the block's
  // per-tile scales), part = 0.
  auto fold = [&](int blk) {
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = col0 + tc + j * TCOLS;
        const float sb = (p.sb_tile && c < n) ? p.scale_b[b][(long long)blk * n + c] : 1.f;
        const float sa = p.sa_tile ? p.scale_a[b][blk] : 1.f;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          float v = static_cast<float>(part[b][i][j]);
          if (p.sb_tile) v = __fmul_rn(v, sb);
          if (p.sa_tile) v = __fmul_rn(v, sa);
          acc[b][i][j] = __fadd_rn(acc[b][i][j], v);
          part[b][i][j] = Acc(0);
        }
      }
  };

  const int nslabs = (k + BK - 1) / BK;
  if (nslabs > 0) load_slab(0);
  for (int s = 0; s < nslabs; ++s) {
    __syncthreads();  // every thread is done reading the previous slab
    store_slab(s * BK);
    __syncthreads();
    if (s + 1 < nslabs) load_slab((s + 1) * BK);  // in flight during the products
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      Acc av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = widen<Acc>(As[tr + i * RSTEP][kk]);
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const Acc bv = widen<Acc>(Bs[b][kk][tc + j * TCOLS]);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            if constexpr (MIN_PLUS)
              part[b][i][j] = min_plus(part[b][i][j], av[i], bv);
            else
              part[b][i][j] = mac(part[b][i][j], av[i], bv);
          }
        }
    }
    if constexpr (QUANT) {
      const int kend = (s + 1) * BK;
      if (s + 1 == nslabs || (p.scale_block > 0 && kend % p.scale_block == 0))
        fold(p.scale_block > 0 ? s * BK / p.scale_block : 0);
    }
  }

  // Drain: the one write-back of each C element.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + tr + i * RSTEP;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tc + j * TCOLS;
      if (c >= n) continue;
      const long long idx = (long long)r * n + c;
      if constexpr (MIN_PLUS) {
        static_cast<float*>(p.out)[idx] = part[0][i][j];
        continue;
      }
      float y;
      if constexpr (QUANT)
        y = drain_scale(p, 0, acc[0][i][j], r, c);
      else
        y = part[0][i][j];
      if (p.bias[0] != nullptr) y = __fadd_rn(y, load_f32(p.bias[0], c, p.bias_f32));
      if constexpr (TRAIN) {
        if (p.pre_out[0] != nullptr) p.pre_out[0][idx] = y;
      }
      if constexpr (NB == 2) {
        float u;
        if constexpr (QUANT)
          u = drain_scale(p, 1, acc[1][i][j], r, c);
        else
          u = part[1][i][j];
        if (p.bias[1] != nullptr) u = __fadd_rn(u, load_f32(p.bias[1], c, p.bias_f32));
        if constexpr (TRAIN) {
          if (p.pre_out[1] != nullptr) p.pre_out[1][idx] = u;
        }
        y = __fmul_rn(act_fn(y, p.glu_act), u);
      } else {
        y = act_fn(y, p.act);
        if (p.mul != nullptr) y = __fmul_rn(y, load_f32(p.mul, idx, p.mul_f32));
        if (p.residual != nullptr) y = __fadd_rn(y, load_f32(p.residual, idx, p.res_f32));
      }
      if (p.out_f32)
        static_cast<float*>(p.out)[idx] = y;
      else
        static_cast<__nv_bfloat16*>(p.out)[idx] = __float2bfloat16_rn(y);
    }
  }
}

// One tile shape: vector B loads where n and the B pointers allow them.
template <typename TA, typename TB, int BM, int BN, int BK, int TM, int TN, int NB>
void launch_tile(const Params& p, cudaStream_t stream) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int VB = vec_bytes(BK * BN / NT * static_cast<int>(sizeof(TB)));
  constexpr int VW = VB / sizeof(TB);
  const bool vec_b = p.n % VW == 0 && reinterpret_cast<uintptr_t>(p.b[0]) % VB == 0 &&
                     reinterpret_cast<uintptr_t>(p.b[1]) % VB == 0;
  const dim3 grid((p.n + BN - 1) / BN, (p.m + BM - 1) / BM);
  if (vec_b)
    ca_gemm_program_kernel<TA, TB, BM, BN, BK, TM, TN, NB, true, false, false>
        <<<grid, NT, 0, stream>>>(p);
  else
    ca_gemm_program_kernel<TA, TB, BM, BN, BK, TM, TN, NB, false, false, false>
        <<<grid, NT, 0, stream>>>(p);
}

bool is_training_program(const Params& p) {
  return p.trans_a || p.trans_b || p.dact != DACT_NONE || p.pre_out[0] != nullptr;
}

// Fixed tiles chosen for the card: decode and short prompts (m <= 8) take
// narrow 8 x 16 tiles so that n = 2048 still spreads over 128 CTAs; longer
// prompts take 64 x 64 tiles with a 4 x 4 register block per thread.  Both
// slab depths (128, 32) divide every per-tile scale block (a multiple of 128).
// Training programs (float only) take the 64 x 64 tile at every m.
template <typename TA, typename TB, int NB>
void launch_program(const Params& p, cudaStream_t stream) {
  if constexpr (!std::is_same<TB, int8_t>::value) {
    if (is_training_program(p)) {
      const dim3 grid((p.n + 63) / 64, (p.m + 63) / 64);
      ca_gemm_program_kernel<TA, TB, 64, 64, 32, 4, 4, NB, false, true, false>
          <<<grid, 256, 0, stream>>>(p);
      return;
    }
  }
  if (p.m <= 8)
    launch_tile<TA, TB, 8, 16, 128, 1, 1, NB>(p, stream);
  else
    launch_tile<TA, TB, 64, 64, 32, 4, 4, NB>(p, stream);
}

template <typename TA, typename TB>
void launch_typed(const Params& p, bool two_branches, cudaStream_t stream) {
  if (two_branches)
    launch_program<TA, TB, 2>(p, stream);
  else
    launch_program<TA, TB, 1>(p, stream);
}

// ---------------------------------------------------------------------------
// The wgmma route: bf16 programs at m > 8 on the TMA + WGMMA main loop
// ---------------------------------------------------------------------------

namespace ml = wgmma_ml;

struct WgArgs {
  ml::Maps maps;
  Params p;
};

// C columns a CTA owns: 128 for one branch; 64 for the GLU, whose two fp32
// accumulators (2 x 32 registers a thread) then take what one branch's 64
// take, and whose two B tiles fill a stage as one branch's B does.
template <int NB>
constexpr int WG_BN = NB == 2 ? 64 : 128;

// The drain of one element pair's chain, in the SIMT kernel's order (bias,
// save_preact, then act * mul + residual or the glu combine), fp32 values.
template <int NB>
__device__ __forceinline__ float wg_chain(const Params& p, float y, float u, int c, long long idx) {
  if (p.bias[0] != nullptr) y = __fadd_rn(y, load_f32(p.bias[0], c, p.bias_f32));
  if (p.pre_out[0] != nullptr) p.pre_out[0][idx] = y;
  if constexpr (NB == 2) {
    if (p.bias[1] != nullptr) u = __fadd_rn(u, load_f32(p.bias[1], c, p.bias_f32));
    if (p.pre_out[1] != nullptr) p.pre_out[1][idx] = u;
    return __fmul_rn(act_fn(y, p.glu_act), u);
  } else {
    y = act_fn(y, p.act);
    if (p.mul != nullptr) y = __fmul_rn(y, load_f32(p.mul, idx, p.mul_f32));
    if (p.residual != nullptr) y = __fadd_rn(y, load_f32(p.residual, idx, p.res_f32));
    return y;
  }
}

// The prologues on an arrived stage, before its products: rms on A (row
// factor, then gain, rounded back to bf16), dact on A or B (times act' of
// the fp32 pre-activation x beside it, rounded back), in the SIMT kernel's
// order.  The consumer threads rewrite the stage in place, 16-byte chunks
// at a time; a chunk's logical column comes from undoing the swizzle.
// Thread t takes chunk t % 8 of rows t / 8 + 32 i, whose logical chunk,
// (t % 8) ^ (t / 8 % 8), is the same in every row it takes, so it reads
// its 8 gains once a stage.  Elements past the tensor's edge arrived as
// zero and stay zero.
template <int BN, bool TA, bool TB>
__device__ __forceinline__ void wg_prologue(const Params& p, uint8_t* a, uint8_t* b, const float* x,
                                            int row0, int col0, int kb) {
  const int t = threadIdx.x;
  const int pc = t % 8, lc = pc ^ ((t / 8) % 8);
  if constexpr (!TA) {
    if (p.row_scale != nullptr || p.dact == DACT_A) {
      float g[8];
      if (p.row_scale != nullptr) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = kb + lc * 8 + j;
          g[j] = c < p.k ? load_f32(p.gain, c, p.gain_f32) : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < ml::BM * 8 / ml::CONSUMERS; ++i) {
        const int r = t / 8 + i * (ml::CONSUMERS / 8);
        uint4* chunk = reinterpret_cast<uint4*>(a + r * 128 + pc * 16);
        uint4 v = *chunk;
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
        if (p.row_scale != nullptr) {
          const int gr = row0 + r;
          if (gr < p.m) {
            const float rs = p.row_scale[gr];
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (kb + lc * 8 + j < p.k)
                e[j] = __float2bfloat16_rn(__fmul_rn(__fmul_rn(__bfloat162float(e[j]), rs), g[j]));
          }
        } else {
          const float* h = x + r * ml::BK + lc * 8;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            e[j] = __float2bfloat16_rn(__fmul_rn(__bfloat162float(e[j]), act_grad(h[j], p.dact_act)));
        }
        *chunk = v;
      }
      ml::fence_proxy_async();
      ml::consumer_sync();
    }
  }
  if constexpr (!TB) {
    if (p.dact == DACT_B) {
#pragma unroll
      for (int i = 0; i < BN * 8 / ml::CONSUMERS; ++i) {
        const int q = t + i * ml::CONSUMERS;
        const int box = q / 512, r = (q / 8) % 64;
        uint4* chunk = reinterpret_cast<uint4*>(b + box * ml::BOX_BYTES + r * 128 + pc * 16);
        uint4 v = *chunk;
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
        const float* h = x + r * BN + box * 64 + lc * 8;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = __float2bfloat16_rn(__fmul_rn(__bfloat162float(e[j]), act_grad(h[j], p.dact_act)));
        *chunk = v;
      }
      ml::fence_proxy_async();
      ml::consumer_sync();
    }
  }
}

// One CTA: the (BM, BN) C tile at (blockIdx.x, blockIdx.y); m runs fastest
// over the grid, so the CTAs of a wave share B panels in L2.  TA: A stored
// (k, m); TB: B stored (n, k).
template <int NB, bool TA, bool TB>
__global__ void __launch_bounds__(ml::WIDE_THREADS, 1)
    ca_gemm_wgmma_kernel(const __grid_constant__ WgArgs args) {
  constexpr int BN = WG_BN<NB>;
  using S = ml::Stage<BN, NB>;
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t full[ml::MAX_STAGES], empty[ml::MAX_STAGES];
  const Params& p = args.p;
  const int extra = p.dact == DACT_A ? ml::EXTRA_A : p.dact == DACT_B ? ml::EXTRA_B : ml::EXTRA_NONE;
  const int nslabs = (p.k + ml::BK - 1) / ml::BK;
  const ml::Ring ring =
      ml::make_ring(dyn_smem, full, empty, S::bytes(extra), S::stages(extra, nslabs));
  const int row0 = blockIdx.x * ml::BM, col0 = blockIdx.y * BN;
  if (threadIdx.x >= ml::CONSUMERS) {
    ml::setmaxnreg_dec<ml::PRODUCER_REGS>();
    if (threadIdx.x == ml::CONSUMERS)
      ml::produce<BN, NB, TA, TB>(args.maps, extra, ring, row0, col0, 0, nslabs);
    return;
  }
  ml::setmaxnreg_inc<ml::CONSUMER_REGS>();
  float acc[NB][BN / 2];
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[i][j] = 0.f;
  ml::consume<BN, NB, TA, TB, true>(acc, ring, nslabs, [&](uint8_t* a, uint8_t* b, uint8_t* x, int s) {
    wg_prologue<BN, TA, TB>(p, a, b, reinterpret_cast<const float*>(x), row0, col0, s * ml::BK);
  });

  // Drain: the one write-back of each C element; a thread's two
  // neighbouring columns go out as one store where n is even.
  const int t = threadIdx.x;
  const bool pairs = p.n % 2 == 0;
#pragma unroll
  for (int j = 0; j < BN / 2; j += 2) {
    const int r = row0 + ml::acc_row(t, j), c = col0 + ml::acc_col(t, j);
    if (r >= p.m || c >= p.n) continue;
    const long long idx = (long long)r * p.n + c;
    const bool second = c + 1 < p.n;
    const float y0 = wg_chain<NB>(p, acc[0][j], NB == 2 ? acc[NB - 1][j] : 0.f, c, idx);
    const float y1 =
        second ? wg_chain<NB>(p, acc[0][j + 1], NB == 2 ? acc[NB - 1][j + 1] : 0.f, c + 1, idx + 1) : 0.f;
    if (p.out_f32) {
      float* o = static_cast<float*>(p.out) + idx;
      if (pairs) {
        *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
      } else {
        o[0] = y0;
        if (second) o[1] = y1;
      }
    } else {
      __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.out) + idx;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(y0, y1);
      } else {
        o[0] = __float2bfloat16_rn(y0);
        if (second) o[1] = __float2bfloat16_rn(y1);
      }
    }
  }
}

template <int NB, bool TA, bool TB>
int launch_wgmma(const Params& p, cudaStream_t stream) {
  constexpr int BN = WG_BN<NB>;
  auto kernel = ca_gemm_wgmma_kernel<NB, TA, TB>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ml::SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  WgArgs args{};
  args.p = p;
  const void* bs[2] = {p.b[0], p.b[1]};
  bool ok = ml::encode_operands(&args.maps, p.a, bs, NB, p.m, p.n, p.k, TA, TB, BN);
  if (p.dact == DACT_A)
    ok = ok && ml::encode_map(&args.maps.extra, p.preact, true, p.m, p.k, ml::BM, ml::BK);
  else if (p.dact == DACT_B)
    ok = ok && ml::encode_map(&args.maps.extra, p.preact, true, p.k, p.n, ml::BK, BN);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int extra = p.dact == DACT_A ? ml::EXTRA_A : p.dact == DACT_B ? ml::EXTRA_B : ml::EXTRA_NONE;
  const int smem = ml::Stage<BN, NB>::smem_bytes(extra, (p.k + ml::BK - 1) / ml::BK);
  const dim3 grid((p.m + ml::BM - 1) / ml::BM, (p.n + BN - 1) / BN);
  kernel<<<grid, ml::WIDE_THREADS, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

int launch_wgmma_program(const Params& p, bool two, cudaStream_t stream) {
  if (two) return launch_wgmma<2, false, false>(p, stream);
  if (p.trans_a)
    return p.trans_b ? launch_wgmma<1, true, true>(p, stream) : launch_wgmma<1, true, false>(p, stream);
  return p.trans_b ? launch_wgmma<1, false, true>(p, stream) : launch_wgmma<1, false, false>(p, stream);
}

// ---------------------------------------------------------------------------
// The decode route: serving programs at m <= 8 on a split-k cluster
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int DEC_THREADS = 256;
constexpr int DEC_BN = 64;                     // C columns a CTA owns (a strip)
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_MAX_SPLIT = 8;               // CTAs of a cluster (the portable most)
constexpr int DEC_MIN_CHUNK = 256;             // k rows a CTA takes at least
constexpr int DEC_A_BYTES = 64 * 1024;         // shared memory for A's staged rows

// How a CTA's 256 threads cover a strip: each thread streams one VB-byte
// vector of B (CW columns of one k row) from each of U k rows in flight;
// CG column groups x KL k lanes, lane kl taking rows kl, kl + KL, ...
// bf16 B: 16-byte vectors (8 columns, 32 k lanes), U = 8 at m = 1 (32 KB of
// B in flight a CTA), 4 at m <= 8.  int8 B at m = 1: 8-byte vectors (8
// columns, 32 k lanes), U = 8 (16 KB a branch); int8 B at m <= 8: 4-byte
// vectors (4 columns, 16 k lanes), U = 16 (16 KB a branch).  Small vectors
// keep int8's block partials and fp32 accumulators (with the rows of B in
// flight) in few enough registers for several CTAs an SM, so that one wave
// holds every cluster of a narrow n.
template <typename TB, int MR>
struct DecLayout {
  static constexpr bool I8 = std::is_same<TB, int8_t>::value;
  static constexpr int VB = !I8 ? 16 : MR > 1 ? 4 : 8;
  static constexpr int CW = VB / static_cast<int>(sizeof(TB));
  static constexpr int CG = DEC_BN / CW;
  static constexpr int KL = DEC_THREADS / CG;
  static constexpr int U = MR == 1 ? 8 : I8 ? 16 : 4;
  using Vec = typename VecOf<VB>::type;
};

// A rows a CTA stages at a time: the whole chunk, unless MR rows of it
// outgrow DEC_A_BYTES (then the chunk goes in pieces).
template <int MR>
__host__ __device__ constexpr int dec_piece() {
  return DEC_A_BYTES / (MR * 4);
}

// One vector of B, streamed once: read-only, not kept in L1.
template <typename V>
__device__ __forceinline__ V ld_stream(const void* ptr);
template <>
__device__ __forceinline__ uint4 ld_stream<uint4>(const void* ptr) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(ptr));
  return v;
}
template <>
__device__ __forceinline__ uint2 ld_stream<uint2>(const void* ptr) {
  uint2 v;
  asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];" : "=r"(v.x), "=r"(v.y) : "l"(ptr));
  return v;
}
template <>
__device__ __forceinline__ uint32_t ld_stream<uint32_t>(const void* ptr) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(v) : "l"(ptr));
  return v;
}

__device__ __forceinline__ uint32_t word_at(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ uint32_t word_at(const uint2& v, int i) { return i == 0 ? v.x : v.y; }
__device__ __forceinline__ uint32_t word_at(uint32_t v, int) { return v; }

// Element j (0-7) of 8 bf16 packed in a vector, widened to fp32.
__device__ __forceinline__ float bf16_at(const uint4& v, int j) {
  const uint32_t w = j < 2 ? v.x : j < 4 ? v.y : j < 6 ? v.z : v.w;
  return __uint_as_float(j % 2 ? w & 0xffff0000u : w << 16);
}

// Byte j (0-3) of a word of int8, widened without a conversion instruction:
// to fp32 from the word with each byte's sign bit flipped (b + 128), moved
// by a byte permute into the mantissa of 2^23 and the 2^23 + 128 taken off
// (exact for every int8); to int32 by a sign-replicating byte permute.
__device__ __forceinline__ float i8_f32_at(uint32_t flipped, int j) {
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7440 | j)) - 8388736.f;
}
__device__ __forceinline__ int i8_i32_at(uint32_t w, int j) {
  int r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(w), "r"(0), "r"(((8 | j) * 0x1110) | j));
  return r;
}

// The CW elements of a B vector, widened to the accumulator's type.
template <typename TB, typename Acc, int CW, typename V>
__device__ __forceinline__ void widen_vec(const V& v, Acc (&w)[CW]) {
  if constexpr (!std::is_same<TB, int8_t>::value) {
#pragma unroll
    for (int j = 0; j < CW; ++j) w[j] = bf16_at(v, j);
  } else {
#pragma unroll
    for (int q = 0; q < CW / 4; ++q) {
      const uint32_t x = word_at(v, q);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (std::is_same<Acc, int>::value)
          w[4 * q + j] = i8_i32_at(x, j);
        else
          w[4 * q + j] = i8_f32_at(x ^ 0x80808080u, j);
      }
    }
  }
}

__device__ __forceinline__ float dec_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ int dec_add(int a, int b) { return a + b; }
__device__ __forceinline__ uint32_t dec_bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint32_t dec_bits(int x) { return static_cast<uint32_t>(x); }
template <typename T>
__device__ __forceinline__ T dec_val(uint32_t w) {
  if constexpr (std::is_same<T, int>::value)
    return static_cast<int>(w);
  else
    return __uint_as_float(w);
}

// TA, TB: bf16 and bf16 (K1a-c), bf16 and int8 (dqb, K1d), int8 and int8
// (dqab, K1e).  MR: rows of A a CTA computes (1 for m = 1, else 8, rows past
// m zero).  The grid is (n strips, split), one cluster per strip, rank r
// taking k rows [r chunk, (r + 1) chunk).
//
// Sums: `part` holds each thread's products in the accumulator's type (fp32,
// int32 for int8 A).  With per-tile scales (TILE) a thread folds `part`,
// converted to fp32 and times the block's scales, into its fp32 `acc`
// whenever its next row lies in another quantization block (the chunk is a
// multiple of the block), and the CTA reduces `acc`; otherwise it reduces
// `part` itself, in int32 for int8 A (exact), and the leader converts the
// cluster's sum once.  The drain then applies the per-channel and per-row
// scales (drain_scale), then the chain, in the SIMT kernel's order.
template <typename TA, typename TB, int MR, int NB, bool TILE>
__global__ void __launch_bounds__(DEC_THREADS) ca_gemm_decode_kernel(const Params p, int chunk) {
  using L = DecLayout<TB, MR>;
  constexpr bool QUANT = std::is_same<TB, int8_t>::value;
  constexpr bool INT_A = std::is_same<TA, int8_t>::value;
  using Acc = typename std::conditional<INT_A, int, float>::type;
  constexpr int CW = L::CW, CG = L::CG, KL = L::KL, U = L::U;
  constexpr int PIECE = dec_piece<MR>();
  extern __shared__ float4 dec_smem[];
  Acc* As = reinterpret_cast<Acc*>(dec_smem);  // [piece rows][MR]
  __shared__ uint32_t red[DEC_WARPS][NB * MR * DEC_BN];
  __shared__ uint32_t part_s[NB * MR * DEC_BN];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int split = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, cgi = tid % CG, kl = tid / CG;
  const int col = blockIdx.x * DEC_BN + cgi * CW;
  const bool col_in = col < p.n;  // n % CW == 0: a vector lies wholly inside or out
  const int kb = rank * chunk, ke = min(p.k, kb + chunk);
  const TA* A = static_cast<const TA*>(p.a);
  static_assert(QUANT || !TILE, "per-tile scales belong to int8 programs");

  Acc part[NB][MR][CW];
  float acc[TILE ? NB : 1][TILE ? MR : 1][TILE ? CW : 1];
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        part[i][r][j] = Acc(0);
        if constexpr (TILE) acc[i][r][j] = 0.f;
      }
  // The quantization block of `part` and the first row past it.
  int blk = TILE ? kb / p.scale_block : 0;
  int blk_end = TILE ? (blk + 1) * p.scale_block : 0;
  // acc += part (to fp32, times block blk's per-tile scales), part = 0.
  auto fold = [&]() {
    if constexpr (TILE) {
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const float sa = p.sa_tile ? p.scale_a[i][blk] : 1.f;
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          const float sb = (p.sb_tile && col_in) ? p.scale_b[i][(long long)blk * p.n + col + j] : 1.f;
#pragma unroll
          for (int r = 0; r < MR; ++r) {
            float v = static_cast<float>(part[i][r][j]);
            if (p.sb_tile) v = __fmul_rn(v, sb);
            if (p.sa_tile) v = __fmul_rn(v, sa);
            acc[i][r][j] = __fadd_rn(acc[i][r][j], v);
            part[i][r][j] = Acc(0);
          }
        }
      }
    }
  };

  typename L::Vec v[NB][U];
  // B rows base + KL u, u < U, below pe; zeros past it.
  auto load = [&](int base, int pe) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kr = base + u * KL;
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const TB* B = static_cast<const TB*>(p.b[i]);
        v[i][u] = col_in && kr < pe ? ld_stream<typename L::Vec>(B + (long long)kr * p.n + col)
                                    : typename L::Vec{};
      }
    }
  };
  auto compute = [&](int base, int p0, int pe) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kr = base + u * KL;
      if (kr >= pe) break;
      if (TILE && kr >= blk_end) {  // a new quantization block
        fold();
        ++blk;
        blk_end += p.scale_block;
      }
      Acc a[MR];
      if constexpr (MR == 1) {
        a[0] = As[kr - p0];
      } else {
        using Acc4 = typename std::conditional<INT_A, int4, float4>::type;
        const Acc4* ar = reinterpret_cast<const Acc4*>(As + (kr - p0) * MR);
#pragma unroll
        for (int q = 0; q < MR / 4; ++q) {
          const Acc4 x = ar[q];
          a[4 * q] = x.x;
          a[4 * q + 1] = x.y;
          a[4 * q + 2] = x.z;
          a[4 * q + 3] = x.w;
        }
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        Acc w[CW];
        widen_vec<TB, Acc, CW>(v[i][u], w);
#pragma unroll
        for (int j = 0; j < CW; ++j)
#pragma unroll
          for (int r = 0; r < MR; ++r) part[i][r][j] = mac(part[i][r][j], a[r], w[j]);
      }
    }
  };

  for (int p0 = kb; p0 < ke; p0 += PIECE) {
    const int pe = min(ke, p0 + PIECE);
    int base = p0 + kl;
    load(base, pe);                  // the first rows are in flight during the staging
    if (p0 != kb) __syncthreads();   // the previous piece is read
    // A rows [p0, pe): bf16 as fp32, the rms prologue applied and rounded
    // back to bf16 as the SIMT kernel does; int8 as int32; rows past m zero.
    for (int e = tid; e < (pe - p0) * MR; e += DEC_THREADS) {
      const int r = e % MR, kr = p0 + e / MR;
      Acc x = Acc(0);
      if (r < p.m) {
        if constexpr (INT_A) {
          x = A[(long long)r * p.k + kr];
        } else {
          __nv_bfloat16 av = A[(long long)r * p.k + kr];
          if (p.row_scale != nullptr)
            av = __float2bfloat16_rn(__fmul_rn(__fmul_rn(__bfloat162float(av), p.row_scale[r]),
                                               load_f32(p.gain, kr, p.gain_f32)));
          x = __bfloat162float(av);
        }
      }
      As[e] = x;
    }
    __syncthreads();
    for (;;) {
      compute(base, p0, pe);
      base += U * KL;
      if (base >= pe) break;
      load(base, pe);
    }
  }

  // The CTA's partial: the k lanes of a warp by shuffles, then the warps in
  // order, each sum in a fixed order; then the leader sums the cluster's
  // partials in rank order through distributed shared memory, runs the
  // dequant and the drain chain and stores each C element once.
  const int warp = tid / 32, lane = tid % 32;
  auto reduce = [&](auto& x) {
    using T = typename std::remove_reference<decltype(x[0][0][0])>::type;
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int r = 0; r < MR; ++r)
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          T y = x[i][r][j];
#pragma unroll
          for (int s = CG; s < 32; s *= 2) y = dec_add(y, __shfl_xor_sync(0xffffffffu, y, s));
          x[i][r][j] = y;
        }
    if (lane < CG) {
#pragma unroll
      for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int r = 0; r < MR; ++r)
#pragma unroll
          for (int j = 0; j < CW; ++j)
            red[warp][(i * MR + r) * DEC_BN + lane * CW + j] = dec_bits(x[i][r][j]);
    }
    __syncthreads();
    for (int e = tid; e < NB * MR * DEC_BN; e += DEC_THREADS) {
      T y = dec_val<T>(red[0][e]);
#pragma unroll
      for (int w = 1; w < DEC_WARPS; ++w) y = dec_add(y, dec_val<T>(red[w][e]));
      part_s[e] = dec_bits(y);
    }
    cluster.sync();
    if (rank == 0) {
      for (int e = tid; e < MR * DEC_BN; e += DEC_THREADS) {
        const int r = e / DEC_BN, cl = e % DEC_BN, c = blockIdx.x * DEC_BN + cl;
        if (r >= p.m || c >= p.n) continue;
        float z[NB];
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          const int at = (i * MR + r) * DEC_BN + cl;
          // The other ranks' partials loaded together, summed in rank order.
          uint32_t w[DEC_MAX_SPLIT];
#pragma unroll
          for (int q = 1; q < DEC_MAX_SPLIT; ++q) w[q] = q < split ? cluster.map_shared_rank(&part_s[0], q)[at] : 0u;
          T y = dec_val<T>(part_s[at]);
#pragma unroll
          for (int q = 1; q < DEC_MAX_SPLIT; ++q)
            if (q < split) y = dec_add(y, dec_val<T>(w[q]));
          z[i] = static_cast<float>(y);  // int32: the one rounding of the exact sum
          if constexpr (QUANT) z[i] = drain_scale(p, i, z[i], r, c);
        }
        const long long idx = (long long)r * p.n + c;
        const float y = wg_chain<NB>(p, z[0], z[NB - 1], c, idx);
        if (p.out_f32)
          static_cast<float*>(p.out)[idx] = y;
        else
          static_cast<__nv_bfloat16*>(p.out)[idx] = __float2bfloat16_rn(y);
      }
    }
    cluster.sync();  // the partials stay until the leader has read them
  };
  if constexpr (TILE) {
    fold();
    reduce(acc);
  } else {
    reduce(part);
  }
}

// The split of k over a cluster: about two CTAs an SM in all, at most
// DEC_MAX_SPLIT, each CTA at least DEC_MIN_CHUNK rows; `chunk` (a multiple
// of `quantum`: the k lanes, or the per-tile scale block) is each CTA's share.
int decode_split(const Params& p, int quantum, int* chunk) {
  static const int sms = [] {
    int dev = 0, n = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const int strips = (p.n + DEC_BN - 1) / DEC_BN;
  const int most = (p.k + DEC_MIN_CHUNK - 1) / DEC_MIN_CHUNK;
  int split = (2 * sms + strips - 1) / strips;
  split = split < DEC_MAX_SPLIT ? split : DEC_MAX_SPLIT;
  split = split < most ? split : most;
  split = split > 1 ? split : 1;
  *chunk = ((p.k + split - 1) / split + quantum - 1) / quantum * quantum;
  return (p.k + *chunk - 1) / *chunk;
}

template <typename TA, typename TB, int MR, int NB, bool TILE>
int launch_decode(const Params& p, cudaStream_t stream) {
  auto kernel = ca_gemm_decode_kernel<TA, TB, MR, NB, TILE>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DEC_A_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int chunk = 0;
  const int split = decode_split(p, p.scale_block > 0 ? p.scale_block : DecLayout<TB, MR>::KL, &chunk);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.n + DEC_BN - 1) / DEC_BN, split, 1);
  cfg.blockDim = dim3(DEC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = (chunk < dec_piece<MR>() ? chunk : dec_piece<MR>()) * MR * 4;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = 1;
  attrs[0].val.clusterDim.y = split;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p, chunk);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename TA, typename TB, bool TILE>
int launch_decode_typed(const Params& p, bool two, cudaStream_t stream) {
  if (p.m == 1)
    return two ? launch_decode<TA, TB, 1, 2, TILE>(p, stream) : launch_decode<TA, TB, 1, 1, TILE>(p, stream);
  return two ? launch_decode<TA, TB, 8, 2, TILE>(p, stream) : launch_decode<TA, TB, 8, 1, TILE>(p, stream);
}

template <typename TA>
int launch_decode_int8(const Params& p, bool two, cudaStream_t stream) {
  return p.scale_block > 0 ? launch_decode_typed<TA, int8_t, true>(p, two, stream)
                           : launch_decode_typed<TA, int8_t, false>(p, two, stream);
}

int launch_decode_program(const Params& p, int a_type, int b_type, bool two, cudaStream_t stream) {
  if (b_type == TYPE_BF16) return launch_decode_typed<__nv_bfloat16, __nv_bfloat16, false>(p, two, stream);
  if (a_type == TYPE_BF16) return launch_decode_int8<__nv_bfloat16>(p, two, stream);
  return launch_decode_int8<int8_t>(p, two, stream);
}

enum Route { ROUTE_SIMT = 0, ROUTE_WGMMA = 1, ROUTE_DECODE = 2 };

// Which route a launch takes (the twin of kernels/ca_mmm.py:k1_route), for
// operands whose TMA'd or vector-loaded rows (A, B, the dact pre-activation)
// have 16-byte aligned bases and row strides: bf16 A and B, decode at m <= 8
// for a serving program (nn, no dact, no save_preact), wgmma at m > 8 (the
// GLU only in the nn layout and without dact); int8 B with bf16 A (dqb) or
// int8 A (dqab), decode at m <= 8 (int8 has no training program).  The rest,
// fp32, fp32 A with int8 B, int8 at m > 8, training programs at m <= 8,
// stays on the SIMT tile.
int k1_route(const Params& p, int a_type, int b_type, bool two) {
  const bool bf16 = a_type == TYPE_BF16 && b_type == TYPE_BF16;
  const bool int8 = b_type == TYPE_I8 && (a_type == TYPE_BF16 || a_type == TYPE_I8);
  if (!(bf16 || int8) || p.k < 1) return ROUTE_SIMT;
  const long long ea = a_type == TYPE_I8 ? 1 : 2, eb = b_type == TYPE_I8 ? 1 : 2;
  const long long a_row = p.trans_a ? p.m : p.k, b_row = p.trans_b ? p.k : p.n;
  bool ok = ml::tma_ok(p.a, ea * a_row) && ml::tma_ok(p.b[0], eb * b_row) &&
            ml::tma_ok(p.b[1], eb * b_row);
  if (p.dact != DACT_NONE) ok = ok && ml::tma_ok(p.preact, 4LL * (p.dact == DACT_A ? p.k : p.n));
  if (!ok) return ROUTE_SIMT;
  if (p.m <= 8) return is_training_program(p) ? ROUTE_SIMT : ROUTE_DECODE;
  if (int8) return ROUTE_SIMT;
  if (p.n > 65535 * WG_BN<2>) return ROUTE_SIMT;
  if (two && (p.trans_a || p.trans_b || p.dact != DACT_NONE)) return ROUTE_SIMT;
  return ROUTE_WGMMA;
}

}  // namespace

// C entry point.  The caller checks shapes, types, scales and contiguity;
// m, n > 0.  A and B types (TYPE_*): float A with B of the same type, float A
// with int8 B (dqb), or int8 A with int8 B (dqab); any other pair, or a
// training program (transposed layout, dact or save_preact) on int8
// operands, returns cudaErrorInvalidValue.  `route` is the caller's route
// (0 SIMT, 1 wgmma, 2 decode, from kernels/ca_mmm.py:k1_route); one that
// differs from k1_route's returns cudaErrorInvalidValue too.  Launches on `stream`
// without synchronising and returns cudaGetLastError().
extern "C" int ca_gemm_program_launch(
    const void* a, const void* b0, const void* b1, const void* row_scale,
    const void* gain, const void* bias0, const void* bias1, const void* mul,
    const void* residual, void* out, const void* scale_b0, const void* scale_b1,
    const void* scale_a0, const void* scale_a1, const void* preact, void* pre_out0,
    void* pre_out1, int m, int n, int k, int a_type, int b_type, int gain_f32,
    int bias_f32, int mul_f32, int res_f32, int out_f32, int act, int glu_act,
    int scale_block, int sb_tile, int sa_tile, int trans_a, int trans_b, int dact,
    int dact_act, int route, void* stream) {
  Params p;
  p.a = a;
  p.b[0] = b0;
  p.b[1] = b1 != nullptr ? b1 : b0;
  p.row_scale = static_cast<const float*>(row_scale);
  p.gain = gain;
  p.bias[0] = bias0;
  p.bias[1] = bias1;
  p.mul = mul;
  p.residual = residual;
  p.out = out;
  p.scale_b[0] = static_cast<const float*>(scale_b0);
  p.scale_b[1] = static_cast<const float*>(scale_b1);
  p.scale_a[0] = static_cast<const float*>(scale_a0);
  p.scale_a[1] = static_cast<const float*>(scale_a1);
  p.m = m;
  p.n = n;
  p.k = k;
  p.gain_f32 = gain_f32;
  p.bias_f32 = bias_f32;
  p.mul_f32 = mul_f32;
  p.res_f32 = res_f32;
  p.out_f32 = out_f32;
  p.act = act;
  p.glu_act = glu_act;
  p.scale_block = scale_block;
  p.sb_tile = sb_tile;
  p.sa_tile = sa_tile;
  p.preact = static_cast<const float*>(preact);
  p.pre_out[0] = static_cast<float*>(pre_out0);
  p.pre_out[1] = static_cast<float*>(pre_out1);
  p.trans_a = trans_a;
  p.trans_b = trans_b;
  p.dact = dact;
  p.dact_act = dact_act;
  p.a_f32 = p.b_f32 = 1;
  const bool two = b1 != nullptr;
  if (is_training_program(p) && (a_type == TYPE_I8 || b_type == TYPE_I8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int r = k1_route(p, a_type, b_type, two);
  if (route != r) return static_cast<int>(cudaErrorInvalidValue);
  if (r == ROUTE_WGMMA) return launch_wgmma_program(p, two, s);
  if (r == ROUTE_DECODE) return launch_decode_program(p, a_type, b_type, two, s);
  if (a_type == TYPE_F32 && b_type == TYPE_F32)
    launch_typed<float, float>(p, two, s);
  else if (a_type == TYPE_BF16 && b_type == TYPE_BF16)
    launch_typed<__nv_bfloat16, __nv_bfloat16>(p, two, s);
  else if (a_type == TYPE_F32 && b_type == TYPE_I8)
    launch_typed<float, int8_t>(p, two, s);
  else if (a_type == TYPE_BF16 && b_type == TYPE_I8)
    launch_typed<__nv_bfloat16, int8_t>(p, two, s);
  else if (a_type == TYPE_I8 && b_type == TYPE_I8)
    launch_typed<int8_t, int8_t>(p, two, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// C entry point of the distance product (K1g): out (m, n) fp32 =
// min_k (A[i,k] + B[k,j]), A (m, k) and B (k, n) row-major, each fp32
// (a_f32 = 1) or bf16 (0).  The caller checks shapes, types and contiguity;
// m, n > 0.  Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int ca_gemm_min_plus_launch(const void* a, const void* b, void* out, int m, int n,
                                       int k, int a_f32, int b_f32, void* stream) {
  Params p = {};
  p.a = a;
  p.b[0] = p.b[1] = b;
  p.out = out;
  p.m = m;
  p.n = n;
  p.k = k;
  p.out_f32 = 1;
  p.a_f32 = a_f32;
  p.b_f32 = b_f32;
  const dim3 grid((n + 63) / 64, (m + 63) / 64);
  ca_gemm_program_kernel<float, float, 64, 64, 32, 4, 4, 1, false, false, true>
      <<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
