// CA-GEMM program kernel for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel repro/kernels/ca_mmm.py:ca_gemm_program (body
// _program_kernel), for its float, 'nn'-layout programs:
//   none                      wq / wk / wv and the logits head
//   res (and bias/act/mul)    wo and w_down, residual added in the drain
//   rms>glu.<act>(b0|b1)      SwiGLU gate+up as one dual-branch pass, the
//                             pre-FFN rms_norm folded into the A fetch
//
// Schedule (the paper's, as on the TPU): one CTA owns a (BM, BN) C tile and
// keeps one fp32 accumulator per B branch in registers for the whole k loop;
// A and B panels stream through shared memory one BK slab at a time, the
// next slab's global loads in flight (registers) while the current one is
// multiplied.  The loop over k inside the block takes the place of the TPU's
// sequential k grid axis.  The drain runs once, after the last slab:
// act(z + bias) * mul + residual (one branch) or act(z0 + bias0) * (z1 + bias1)
// (glu), all in fp32, then a single predicated store per C element.
//
// Ragged m, n and k: out-of-range A and B loads read 0 (the plus_times k
// mask), and the C store is predicated, so each C element is written once.
// The rms prologue multiplies each in-range A element in fp32 by
// row_scale[row] * gain[col] and rounds it back to A's type before the
// product, as ca_mmm.py:204-207 does.
//
// What bounds it on the H100: at decode (m = 1) every program is bound by
// the weight bytes it must stream.  The GLU streams 2 x 2048 x 5632 x 2 B =
// 46 MB: 13.8 us at 3.35 TB/s.  This is a simple SIMT kernel (fp32 FMAs,
// no tensor cores): with BN = 64 on n = 2048 it would launch only 32 CTAs on
// 132 SMs, so for m <= 8 it takes BN = 16 (128 CTAs on n = 2048), which
// still leaves it limited by shared-memory reads and by the few bytes each
// SM keeps in flight, far below that bound.  The measured times stand in
// PERF.md; wgmma, TMA and a split-k decode path are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3 };

struct Params {
  const void* a;          // (m, k) row-major, T
  const void* b[2];       // (k, n) row-major, T, one per branch
  const float* row_scale; // (m,) fp32 rms row factor, or null (no prologue)
  const void* gain;       // (k,) rms gain, fp32 or bf16
  const void* bias[2];    // (n,) per-branch bias, or null
  const void* mul;        // (m, n) gate multiplied after the activation, or null
  const void* residual;   // (m, n) added last, or null
  void* out;              // (m, n), fp32 or bf16
  int m, n, k;
  int gain_f32, bias_f32, mul_f32, res_f32, out_f32;
  int act;                // single-branch activation
  int glu_act;            // activation of the glu combine (two branches)
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

// Threads: (BM / TM) x (BN / TN).  Thread (tr, tc) owns rows tr + i*(BM/TM)
// and columns tc + j*(BN/TN) of the C tile, so neighbouring threads read
// neighbouring shared-memory words and store neighbouring C elements.
template <typename T, int BM, int BN, int BK, int TM, int TN, int NB, bool VEC_B>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    ca_gemm_program_kernel(const Params p) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int TCOLS = BN / TN;
  constexpr int RSTEP = BM / TM;
  constexpr int VW = 16 / sizeof(T);  // elements in one 16-byte vector
  constexpr int A_PER = BM * BK / NT;
  constexpr int B_PER = BK * BN / NT;
  constexpr int BV_PER = VEC_B ? B_PER / VW : 1;
  constexpr int BS_PER = VEC_B ? 1 : B_PER;
  static_assert((BM * BK) % NT == 0 && (BK * BN) % NT == 0,
                "a tile must split evenly over the threads");
  static_assert(!VEC_B || (B_PER % VW == 0 && BN % VW == 0),
                "vector B loads must split evenly over the threads");

  __shared__ T As[BM][BK + 1];
  __shared__ __align__(16) T Bs[NB][BK][BN];

  const T* __restrict__ A = static_cast<const T*>(p.a);
  const int m = p.m, n = p.n, k = p.k;
  const int tid = threadIdx.x;
  const int tr = tid / TCOLS, tc = tid % TCOLS;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const T zero = Cvt<T>::from(0.f);

  float acc[NB][TM][TN];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[b][i][j] = 0.f;

  T ra[A_PER];
  uint4 rbv[NB][BV_PER];
  T rbs[NB][BS_PER];

  // Global -> registers for the slab starting at k0; out of range reads 0.
  auto load_slab = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int e = tid + i * NT;
      const int r = row0 + e / BK, c = k0 + e % BK;
      ra[i] = (r < m && c < k) ? A[(long long)r * k + c] : zero;
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const T* __restrict__ B = static_cast<const T*>(p.b[b]);
      if constexpr (VEC_B) {
#pragma unroll
        for (int i = 0; i < BV_PER; ++i) {
          const int v = tid + i * NT;
          const int r = k0 + v / (BN / VW), c = col0 + (v % (BN / VW)) * VW;
          // n % VW == 0, so a vector lies wholly inside or wholly outside.
          rbv[b][i] = (r < k && c < n)
                          ? *reinterpret_cast<const uint4*>(B + (long long)r * n + c)
                          : make_uint4(0u, 0u, 0u, 0u);
        }
      } else {
#pragma unroll
        for (int i = 0; i < BS_PER; ++i) {
          const int e = tid + i * NT;
          const int r = k0 + e / BN, c = col0 + e % BN;
          rbs[b][i] = (r < k && c < n) ? B[(long long)r * n + c] : zero;
        }
      }
    }
  };

  // Registers -> shared memory, with the rms prologue on the A elements.
  auto store_slab = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int e = tid + i * NT;
      const int rl = e / BK, cl = e % BK;
      T v = ra[i];
      if (p.row_scale != nullptr) {
        const int r = row0 + rl, c = k0 + cl;
        if (r < m && c < k) {
          const float f = __fmul_rn(__fmul_rn(Cvt<T>::to(v), p.row_scale[r]),
                                    load_f32(p.gain, c, p.gain_f32));
          v = Cvt<T>::from(f);  // rounded back to A's type before the product
        }
      }
      As[rl][cl] = v;
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if constexpr (VEC_B) {
#pragma unroll
        for (int i = 0; i < BV_PER; ++i) {
          const int v = tid + i * NT;
          *reinterpret_cast<uint4*>(&Bs[b][v / (BN / VW)][(v % (BN / VW)) * VW]) =
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

  const int nslabs = (k + BK - 1) / BK;
  if (nslabs > 0) load_slab(0);
  for (int s = 0; s < nslabs; ++s) {
    __syncthreads();  // every thread is done reading the previous slab
    store_slab(s * BK);
    __syncthreads();
    if (s + 1 < nslabs) load_slab((s + 1) * BK);  // in flight during the products
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = Cvt<T>::to(As[tr + i * RSTEP][kk]);
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float bv = Cvt<T>::to(Bs[b][kk][tc + j * TCOLS]);
#pragma unroll
          for (int i = 0; i < TM; ++i) acc[b][i][j] = fmaf(av[i], bv, acc[b][i][j]);
        }
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
      float y = acc[0][i][j];
      if (p.bias[0] != nullptr) y = __fadd_rn(y, load_f32(p.bias[0], c, p.bias_f32));
      if constexpr (NB == 2) {
        float u = acc[1][i][j];
        if (p.bias[1] != nullptr) u = __fadd_rn(u, load_f32(p.bias[1], c, p.bias_f32));
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

template <typename T, int BM, int BN, int BK, int TM, int TN, int NB, bool VEC_B>
void launch_tile(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.n + BN - 1) / BN, (p.m + BM - 1) / BM);
  ca_gemm_program_kernel<T, BM, BN, BK, TM, TN, NB, VEC_B>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(p);
}

// Fixed tiles chosen for the card: decode and short prompts (m <= 8) take
// narrow 8 x 16 tiles so that n = 2048 still spreads over 128 CTAs; longer
// prompts take 64 x 64 tiles with a 4 x 4 register block per thread.
template <typename T, int NB, bool VEC_B>
void launch_program(const Params& p, cudaStream_t stream) {
  if (p.m <= 8)
    launch_tile<T, 8, 16, 128, 1, 1, NB, VEC_B>(p, stream);
  else
    launch_tile<T, 64, 64, 32, 4, 4, NB, VEC_B>(p, stream);
}

template <typename T>
void launch_typed(const Params& p, bool two_branches, bool vec_b, cudaStream_t stream) {
  if (two_branches) {
    if (vec_b)
      launch_program<T, 2, true>(p, stream);
    else
      launch_program<T, 2, false>(p, stream);
  } else {
    if (vec_b)
      launch_program<T, 1, true>(p, stream);
    else
      launch_program<T, 1, false>(p, stream);
  }
}

}  // namespace

// C entry point.  The caller checks shapes, types and contiguity; m, n > 0.
// Launches on `stream` without synchronising and returns cudaGetLastError().
extern "C" int ca_gemm_program_launch(
    const void* a, const void* b0, const void* b1, const void* row_scale,
    const void* gain, const void* bias0, const void* bias1, const void* mul,
    const void* residual, void* out, int m, int n, int k, int in_bf16,
    int gain_f32, int bias_f32, int mul_f32, int res_f32, int out_f32,
    int act, int glu_act, void* stream) {
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
  const bool two = b1 != nullptr;
  const int vw = in_bf16 ? 8 : 4;
  const bool vec_b = (n % vw == 0) && (reinterpret_cast<uintptr_t>(b0) % 16 == 0) &&
                     (!two || reinterpret_cast<uintptr_t>(b1) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    launch_typed<__nv_bfloat16>(p, two, vec_b, s);
  else
    launch_typed<float>(p, two, vec_b, s);
  return static_cast<int>(cudaGetLastError());
}
