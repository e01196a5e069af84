// Forward flash attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel repro/kernels/flash_attn.py:flash_attention_tpu
// (body _fa_kernel): attention of every query over the kv slots it may see,
// with explicit positions, causal and sliding-window masks and GQA.
//   q      (B, Lq, H, D)   fp32 or bf16
//   k      (B, S, Hkv, D)  q's dtype
//   v      (B, S, Hkv, Dv) q's dtype
//   qpos   (B, Lq) int32   query positions
//   kpos   (B, S) int32    kv positions, -1 = invalid slot
//   out    (B, Lq, H, Dv)  q's dtype
// A kv slot c is visible to query row r when kpos[c] >= 0, and (causal)
// kpos[c] <= qpos[r], and (window) kpos[c] > qpos[r] - window.
//
// It does what the TPU kernel does, step for step, not what the plain
// softmax oracle does: the scale multiplies the fp32 q.k dot; masked logits
// are -1e30, not -inf; masked probabilities are set to 0 explicitly; the
// probabilities are rounded to v's dtype before the PV product (their fp32
// values feed the denominator); the running max m, the denominator l and the
// accumulator are fp32; the drain is acc / max(l, 1e-30), so a fully masked
// row stores 0; query rows past Lq carry position -1e9, as the TPU kernel's
// padding does, and are never stored.
//
// Schedule.  One CTA of 256 threads per (batch x KV head, q block) holds the
// G x qc query rows of that block (the G query heads of one KV head folded
// into the rows, qc = 64 / G positions each, as the TPU kernel folds them):
// 64 rows of q in shared memory, widened to fp32.  It walks the kv slots in
// order, 64 at a time; a block of slots that no row of the CTA can see (all
// invalid, all after the last query under causal, all before the window of
// the first) is skipped, which changes no bit: such a step leaves m, l and
// the accumulator as they were.  For each block it stages K and V in shared
// memory, widened to fp32, computes the 64 x 64 scores (each thread a 4 x 4
// block, fp32 FMAs), runs the online softmax one warp per 8 rows, and adds
// P V into the accumulator, which each thread keeps in registers (4 rows x
// DMAX / 16 columns; DMAX = 64 or 128, so D, Dv <= 128, h2o-danube-3-4b's
// 120 included).  Each output element is stored once, after the last block.
// The block sizes are fixed here; the q_block and kv_block arguments of the
// wrapper are not read (results do not depend on them beyond rounding).
//
// What bounds it on the H100: 4 D (visible pairs) H operations in bf16 (the
// q.k and p.v products) over 989 TFLOP/s, or its bytes (q, k, v and out once)
// over 3.35 TB/s at short contexts.  stablelm-1.6b's prefill of 1000 tokens
// (H = 32, D = 64, causal): 4.1 GFLOP, 4.2 us.  This SIMT kernel (fp32 FMAs,
// no tensor cores, no cp.async) runs far from that; wgmma with a TMA-fed ring
// is later work.  The measured times stand in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int ROWS = 64;       // query rows per CTA (G heads x qc positions)
constexpr int KC = 64;         // kv slots per block
constexpr int NT = 256;        // threads: 16 x 16, a 4 x 4 score block each
constexpr int WARPS = NT / 32;
constexpr int RSTEP = 16;      // rows tr + 16 i, columns tc + 16 j
constexpr float kNeg = -1e30f;
constexpr int kPadPos = -1000000000;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* qpos;
  const int* kpos;
  void* out;
  int Lq, S, H, Hkv, D, Dv;
  int qc;                      // query positions per CTA (ROWS / G)
  int causal, window;          // window 0: none
  float scale;
};

template <typename T>
__device__ __forceinline__ float to_f32(T v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(v);
  else
    return v;
}

// x rounded to T and widened back (the TPU kernel's p.astype(v.dtype)).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return x;
}

template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __float2bfloat16_rn(x);
  else
    return x;
}

__device__ __forceinline__ bool visible(int kp, int qp, int causal, int window) {
  return kp >= 0 && (!causal || kp <= qp) &&
         (window <= 0 || (long long)kp > (long long)qp - window);
}

template <int DMAX>
constexpr int smem_floats() {
  // Q and K rows at stride DMAX + 1 (odd: a column is read conflict-free),
  // V rows at DMAX, P at KC + 1, then m, l, alpha and the two position rows.
  return ROWS * (DMAX + 1) + KC * (DMAX + 1) + KC * DMAX + ROWS * (KC + 1) + 3 * ROWS +
         ROWS + KC;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT, 2) flash_attn_fwd_kernel(const Params p) {
  constexpr int QS = DMAX + 1, PS = KC + 1, DJ = DMAX / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + ROWS * QS;
  float* Vs = Ks + KC * QS;
  float* Ps = Vs + KC * DMAX;
  float* m_s = Ps + ROWS * PS;
  float* l_s = m_s + ROWS;
  float* alpha_s = l_s + ROWS;
  int* qpos_s = reinterpret_cast<int*>(alpha_s + ROWS);
  int* kpos_s = qpos_s + ROWS;

  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k = static_cast<const T*>(p.k);
  const T* __restrict__ v = static_cast<const T*>(p.v);
  const int G = p.H / p.Hkv;
  const int b = blockIdx.y / p.Hkv, kvh = blockIdx.y % p.Hkv;
  const int qb = gridDim.x - 1 - blockIdx.x;  // the longest causal blocks start first
  const int rows = G * p.qc;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  // Row r holds query position qb * qc + r % qc of head kvh * G + r / qc.
  auto query = [&](int r) { return qb * p.qc + r % p.qc; };
  auto valid = [&](int r) { return r < rows && query(r) < p.Lq; };
  auto row_offset = [&](int r) {  // element offset of (b, query, head, 0)
    return ((long long)b * p.Lq + query(r)) * p.H + kvh * G + r / p.qc;
  };

  if (tid < ROWS) {
    qpos_s[tid] = valid(tid) ? p.qpos[(long long)b * p.Lq + query(tid)] : kPadPos;
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  for (int e = tid; e < ROWS * DMAX; e += NT) {
    const int r = e / DMAX, d = e % DMAX;
    Qs[r * QS + d] = (d < p.D && valid(r)) ? to_f32(q[row_offset(r) * p.D + d]) : 0.f;
  }
  __syncthreads();
  // The CTA's query position range, for skipping kv blocks no row sees.
  int qmin = 0x7fffffff, qmax = -0x7fffffff - 1;
  for (int r = 0; r < ROWS; ++r) {
    if (valid(r)) {
      qmin = min(qmin, qpos_s[r]);
      qmax = max(qmax, qpos_s[r]);
    }
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int j0 = 0; j0 < p.S; j0 += KC) {
    bool any = false;
    if (tid < KC) {
      const int c = j0 + tid;
      const int kp = c < p.S ? p.kpos[(long long)b * p.S + c] : -1;
      kpos_s[tid] = kp;
      any = kp >= 0 && (!p.causal || kp <= qmax) &&
            (p.window <= 0 || (long long)kp > (long long)qmin - p.window);
    }
    if (!__syncthreads_or(any)) continue;
    for (int e = tid; e < KC * DMAX; e += NT) {
      const int c = e / DMAX, d = e % DMAX;
      const bool in = j0 + c < p.S;
      const long long slot = ((long long)b * p.S + j0 + c) * p.Hkv + kvh;
      Ks[c * QS + d] = (in && d < p.D) ? to_f32(k[slot * p.D + d]) : 0.f;
      Vs[c * DMAX + d] = (in && d < p.Dv) ? to_f32(v[slot * p.Dv + d]) : 0.f;
    }
    __syncthreads();

    // Scores: s = (q . k) * scale, fp32.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < p.D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(tr + i * RSTEP) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tc + j * RSTEP) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(tr + i * RSTEP) * PS + tc + j * RSTEP] = __fmul_rn(s[i][j], p.scale);
    __syncthreads();

    // Online softmax: one warp per ROWS / WARPS rows, two slots per lane.
    for (int rr = 0; rr < ROWS / WARPS; ++rr) {
      const int r = warp * (ROWS / WARPS) + rr;
      const int qp = qpos_s[r];
      bool ok[2];
      float sv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        ok[h] = visible(kpos_s[c], qp, p.causal, p.window);
        sv[h] = ok[h] ? Ps[r * PS + c] : kNeg;
      }
      float mx = fmaxf(sv[0], sv[1]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float pv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) pv[h] = ok[h] ? expf(__fsub_rn(sv[h], m_new)) : 0.f;
      float sum = __fadd_rn(pv[0], pv[1]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
      const float alpha = expf(__fsub_rn(m_prev, m_new));
#pragma unroll
      for (int h = 0; h < 2; ++h) Ps[r * PS + lane + 32 * h] = round_to<T>(pv[h]);
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = __fadd_rn(__fmul_rn(l_s[r], alpha), sum);
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = alpha_s[tr + i * RSTEP];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] = __fmul_rn(acc[i][j], a);
    }
#pragma unroll 4
    for (int c = 0; c < KC; ++c) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ps[(tr + i * RSTEP) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * DMAX + tc + j * RSTEP];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
      }
    }
  }

  // Drain: the one store of each output element.
  T* __restrict__ out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + i * RSTEP;
    if (!valid(r)) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    const long long base = row_offset(r) * p.Dv;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tc + j * RSTEP;
      if (d < p.Dv) out[base + d] = from_f32<T>(__fdiv_rn(acc[i][j], l));
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const Params& p, int B, int nq, cudaStream_t stream) {
  const int bytes = smem_floats<DMAX>() * 4;
  cudaError_t err = cudaFuncSetAttribute(flash_attn_fwd_kernel<T, DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  flash_attn_fwd_kernel<T, DMAX><<<dim3(nq, B * p.Hkv), NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// C entry point: the forward attention of q over k/v (shapes above), all
// row-major and contiguous, in fp32 (is_bf16 = 0) or bf16 (1); window 0
// means none.  Returns cudaGetLastError() after the launch (0 on success);
// the wrapper raises on anything else.  Launches on `stream`, does not
// synchronise and allocates nothing.
extern "C" int flash_attn_fwd_launch(const void* q, const void* k, const void* v,
                                     const void* qpos, const void* kpos, void* out, int B,
                                     int Lq, int S, int H, int Hkv, int D, int Dv, int causal,
                                     int window, float scale, int is_bf16, void* stream) {
  if (B <= 0 || Lq <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > ROWS || D <= 0 || D > 128 || Dv <= 0 ||
      Dv > 128 || S < 0 || (long long)B * Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.qpos = static_cast<const int*>(qpos);
  p.kpos = static_cast<const int*>(kpos);
  p.out = out;
  p.Lq = Lq;
  p.S = S;
  p.H = H;
  p.Hkv = Hkv;
  p.D = D;
  p.Dv = Dv;
  p.qc = ROWS / (H / Hkv);
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  const int nq = (Lq + p.qc - 1) / p.qc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = D > 64 || Dv > 64;
  cudaError_t err;
  if (is_bf16)
    err = wide ? launch<__nv_bfloat16, 128>(p, B, nq, s) : launch<__nv_bfloat16, 64>(p, B, nq, s);
  else
    err = wide ? launch<float, 128>(p, B, nq, s) : launch<float, 64>(p, B, nq, s);
  return static_cast<int>(err);
}
