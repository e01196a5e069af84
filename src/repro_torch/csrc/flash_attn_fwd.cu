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
// row stores 0; query rows past Lq are padding and are never stored.  Both
// routes walk the kv slots in blocks of 64 from slot 0, the plain version's
// blocks, so p rounds at the same running maxima; a block of slots that no
// row of the CTA can see (all invalid, all after the CTA's last query under
// causal, all before the window of its first) is skipped, which changes no
// bit: such a step leaves m, l and the accumulator as they were.  The G query
// heads of one KV head fold into a CTA's rows, as the TPU kernel folds them;
// a group larger than a CTA's rows is split over a third grid axis (head
// chunks), so any G is taken.
//
// Two routes, chosen by fwd_route below and its Python twin
// (kernels/flash_attn.py:fwd_route); the entry point refuses a launch whose
// route differs.
//
// wgmma (bf16, D and Dv multiples of 8, 16-byte aligned q, k and v: TMA's
// address rules).  One CTA of two consumer warpgroups and a producer
// warpgroup owns 128 query rows: gc heads x qc positions of one KV head (gc
// = min(G, 128), qc = 128 / gc), row = position x gc + head.  A producer
// warp loads the Q tile once by TMA through a 5-D tensor map over (B, Lq,
// Hkv, G, D), so a box never crosses a batch, a KV head or the group (heads
// past G and positions past Lq arrive as zeros); then, for each kv block
// that some row can see, the K and V boxes of 64 slots through 4-D maps over
// (B, S, Hkv, D) into a ring of stages (full and empty mbarriers), with the
// block's kv positions stored beside them (-1 past S) and a flag that says
// whether every slot is visible to every row (no mask needed) or the end of
// the walk.  Each consumer warpgroup owns 64 rows: S = Q K^T by wgmma SS
// (Q and K both K-major, 128-byte swizzle; head dims in 64-wide boxes, TMA's
// zero fill past D is the k padding of the product), the masks from qpos
// (per row, in registers) and kpos (per slot, from the stage; none for a
// block every row sees whole), the online softmax in the accumulator's
// fragment layout (a thread holds 16 scores of each of two rows; row max and
// sum reduce across the 4 threads of a quad), then P V by wgmma RS: P is
// rounded to bf16 straight from the S fragment into the A registers (wgmma's
// accumulator and A-fragment layouts coincide), V (slots x Dv) is N-major B.
// The exp runs in the log2 domain: log2(e) is folded into the scale (s and m
// are the reference's times log2(e)), p = ex2.approx(s - m), alpha =
// ex2.approx(m_prev - m_new); the per-row bounds of the tests hold with it.
// A block's P V is issued with the next block's Q K^T and runs while that
// block's softmax does; the accumulator is rescaled by alpha once the P V
// is done, so each block still computes acc * alpha + P V in the TPU
// kernel's order.  The O accumulator (64 x 64 or 64 x 128 fp32, Dv rounded
// up, zero columns never stored) stays in registers for the whole kv walk;
// the drain divides by max(l, 1e-30) and stores each element once.
//
// SIMT (fp32, and bf16 operands TMA cannot take).  One CTA of 256 threads
// holds 64 rows, gc = min(G, 64) heads x qc = 64 / gc positions of one KV
// head (row = head x qc + position), widened to fp32 in shared memory.  For
// each block it stages K and V in shared memory, widened to fp32, computes
// the 64 x 64 scores (each thread a 4 x 4 block, fp32 FMAs), runs the online
// softmax one warp per 8 rows, and adds P V into the accumulator, which each
// thread keeps in registers (4 rows x DMAX / 16 columns; DMAX = 64 or 128).
//
// D and Dv are at most 128 on both routes (h2o-danube-3-4b's 120 included).
// The block sizes are fixed; the q_block and kv_block arguments of the
// wrapper are not read (results do not depend on them beyond rounding).
//
// What bounds it on the H100: 4 D (visible pairs) H operations in bf16 (the
// q.k and p.v products) over 989 TFLOP/s, or its bytes (q, k, v and out once)
// over 3.35 TB/s at short contexts.  stablelm-1.6b's prefill of 1000 tokens
// (H = 32, D = 64, causal): 4.1 GFLOP, 4.2 us.  Past the tensor cores, each
// score costs the softmax some ten FP32 instructions and one MUFU exp2 a
// block, about what its two products cost at D = 64, so the wgmma route is
// bound by the exp and the mask as much as by the products; the measured
// times stand in PERF.md.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "wgmma_mainloop.cuh"

namespace {

constexpr int ROWS = 64;       // SIMT: query rows per CTA (gc heads x qc positions)
constexpr int KC = 64;         // kv slots per block, both routes
constexpr int NT = 256;        // threads: 16 x 16, a 4 x 4 score block each
constexpr int WARPS = NT / 32;
constexpr int RSTEP = 16;      // rows tr + 16 i, columns tc + 16 j
constexpr float kNeg = -1e30f;
constexpr int kPadPos = -1000000000;

enum Route { ROUTE_SIMT = 0, ROUTE_WGMMA = 1 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* qpos;
  const int* kpos;
  void* out;
  int Lq, S, H, Hkv, D, Dv;
  int gc;                      // query heads per CTA (a chunk of the G)
  int qc;                      // query positions per CTA
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
  const int g0 = blockIdx.z * p.gc;           // the CTA's first head of the group
  const int qb = gridDim.x - 1 - blockIdx.x;  // the longest causal blocks start first
  const int rows = p.gc * p.qc;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  // Row r holds query position qb * qc + r % qc of head kvh * G + g0 + r / qc.
  auto query = [&](int r) { return qb * p.qc + r % p.qc; };
  auto valid = [&](int r) { return r < rows && g0 + r / p.qc < G && query(r) < p.Lq; };
  auto row_offset = [&](int r) {  // element offset of (b, query, head, 0)
    return ((long long)b * p.Lq + query(r)) * p.H + kvh * G + g0 + r / p.qc;
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
cudaError_t launch(const Params& p, dim3 grid, cudaStream_t stream) {
  const int bytes = smem_floats<DMAX>() * 4;
  cudaError_t err = cudaFuncSetAttribute(flash_attn_fwd_kernel<T, DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  flash_attn_fwd_kernel<T, DMAX><<<grid, NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The wgmma route: TMA feed, wgmma products, the softmax in fragments
// ---------------------------------------------------------------------------

namespace ml = wgmma_ml;

constexpr int WG_ROWS = 128;                 // two consumer warpgroups of 64 rows
constexpr int ROW_BYTES = 128;               // 64 bf16 of a head dim: one swizzle row
constexpr int KV_BOX = KC * ROW_BYTES;       // one 64-slot box of K or V: 8 KB
constexpr int Q_BOX = WG_ROWS * ROW_BYTES;   // room for one 64-wide box of Q: 16 KB
constexpr float kLog2e = 1.4426950408889634f;
// Stage flags: the end of the walk, a block to mask, a block every row sees whole.
enum Flag { FLAG_END = 0, FLAG_MASKED = 1, FLAG_WHOLE = 2 };

// W: 64-wide boxes of the head dims (1 for D, Dv <= 64, else 2); the P V
// product is 64 W wide.
template <int W>
struct FwdLayout {
  static constexpr int STAGES = 4;
  static constexpr int Q_BYTES = W * Q_BOX;
  static constexpr int STAGE_BYTES = 2 * W * KV_BOX;  // K boxes, then V boxes
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES;
};

struct FwdArgs {
  CUtensorMap q, k, v;
  Params p;
};

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(ml::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(ml::smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];" ::"r"(ml::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(ml::smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// D (64 x 64 fp32) += A (64 x 16 bf16, registers) B (16 x 64, N-major in
// shared memory through the descriptor).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128 fp32) += A (64 x 16 bf16, registers) B (16 x 128, N-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
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
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Two fp32 values as one bf16 pair, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Keeps the compiler from reusing the registers of a P fragment an
// in-flight wgmma still reads.
__device__ __forceinline__ void fence_frag(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// 2^x (MUFU.EX2): the softmax's exp in the log2 domain.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The producer warp: the Q tile once, then K, V and the kv positions of each
// block some row of the CTA can see, then the end flag.
template <int W>
__device__ void fwd_produce(const FwdArgs& a, uint8_t* qs, uint8_t* ring, uint64_t* full,
                            uint64_t* empty, uint64_t* qbar, int (*kpos_s)[KC], int* flag_s,
                            int b, int kvh, int g0, int q0) {
  using L = FwdLayout<W>;
  const Params& p = a.p;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    ml::mbar_expect_tx(qbar, W * p.gc * p.qc * ROW_BYTES);
    for (int i = 0; i < W; ++i) tma_load_5d(qs + i * Q_BOX, &a.q, qbar, 64 * i, g0, kvh, q0, b);
  }
  // The CTA's query position range (its positions under Lq).
  int qmin = INT_MAX, qmax = INT_MIN;
  const int qend = min(q0 + p.qc, p.Lq);
  for (int i = q0 + lane; i < qend; i += 32) {
    const int v = p.qpos[(long long)b * p.Lq + i];
    qmin = min(qmin, v);
    qmax = max(qmax, v);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, o));
    qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, o));
  }
  int it = 0;
  for (int s0 = 0; s0 < p.S; s0 += KC) {
    int kp[2];
    bool any = false, whole = true;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = s0 + lane + 32 * h;
      kp[h] = c < p.S ? p.kpos[(long long)b * p.S + c] : -1;
      any = any || (kp[h] >= 0 && (!p.causal || kp[h] <= qmax) &&
                    (p.window <= 0 || (long long)kp[h] > (long long)qmin - p.window));
      whole = whole && kp[h] >= 0 && (!p.causal || kp[h] <= qmin) &&
              (p.window <= 0 || (long long)kp[h] > (long long)qmax - p.window);
    }
    if (!__any_sync(0xffffffffu, any)) continue;
    whole = __all_sync(0xffffffffu, whole);
    const int st = it % L::STAGES;
    ml::mbar_wait(&empty[st], ((it / L::STAGES) & 1) ^ 1);
    kpos_s[st][lane] = kp[0];
    kpos_s[st][lane + 32] = kp[1];
    if (lane == 0) {
      flag_s[st] = whole ? FLAG_WHOLE : FLAG_MASKED;
      uint64_t* bar = &full[st];
      uint8_t* ks = ring + st * L::STAGE_BYTES;
      ml::mbar_expect_tx(bar, L::STAGE_BYTES);
      for (int i = 0; i < W; ++i) {
        tma_load_4d(ks + i * KV_BOX, &a.k, bar, 64 * i, kvh, s0, b);
        tma_load_4d(ks + (W + i) * KV_BOX, &a.v, bar, 64 * i, kvh, s0, b);
      }
    } else {
      ml::mbar_arrive(&full[st]);
    }
    ++it;
  }
  const int st = it % L::STAGES;
  ml::mbar_wait(&empty[st], ((it / L::STAGES) & 1) ^ 1);
  if (lane == 0) flag_s[st] = FLAG_END;
  ml::mbar_arrive(&full[st]);
}

template <int W>
__global__ void __launch_bounds__(ml::WIDE_THREADS, 1)
    flash_attn_wgmma_kernel(const __grid_constant__ FwdArgs a) {
  using L = FwdLayout<W>;
  constexpr int OR = 32 * W;  // O registers a thread: 64 rows x 64 W columns / 128
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t full[L::STAGES], empty[L::STAGES], qbar;
  __shared__ __align__(16) int kpos_s[L::STAGES][KC];
  __shared__ int flag_s[L::STAGES];
  const Params& p = a.p;
  uint8_t* qs = dyn_smem + ((1024 - (ml::smem_u32(dyn_smem) & 1023)) & 1023);
  uint8_t* ring = qs + L::Q_BYTES;
  const int tid = threadIdx.x;
  const int G = p.H / p.Hkv;
  const int b = blockIdx.y / p.Hkv, kvh = blockIdx.y % p.Hkv;
  const int g0 = blockIdx.z * p.gc;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * p.qc;  // the longest causal blocks first
  const int rows = p.gc * p.qc;
  if (tid == 0) {
    for (int i = 0; i < L::STAGES; ++i) {
      ml::mbar_init(&full[i], 32);               // the producer warp's lanes
      ml::mbar_init(&empty[i], ml::CONSUMERS);
    }
    ml::mbar_init(&qbar, 1);
    ml::mbar_init_fence();
  }
  __syncthreads();
  if (tid >= ml::CONSUMERS) {
    ml::setmaxnreg_dec<ml::PRODUCER_REGS>();
    if (tid < ml::CONSUMERS + 32)
      fwd_produce<W>(a, qs, ring, full, empty, &qbar, kpos_s, flag_s, b, kvh, g0, q0);
    return;
  }
  ml::setmaxnreg_inc<ml::CONSUMER_REGS>();

  // Rows of the tile past the Q box (gc x qc < 128): zeros, never stored.
  if (rows < WG_ROWS) {
    const int chunks = (WG_ROWS - rows) * (ROW_BYTES / 16);
    for (int e = tid; e < W * chunks; e += ml::CONSUMERS) {
      const int box = e / chunks, c = e % chunks;
      *reinterpret_cast<uint4*>(qs + box * Q_BOX + rows * ROW_BYTES + c * 16) = make_uint4(0, 0, 0, 0);
    }
    ml::fence_proxy_async();
  }
  ml::consumer_sync();

  // This thread's two rows (wgmma's fragment: row g and g + 8 of its warp's
  // 16), their positions, output offsets and window edges.
  const int wg = tid / 128, lane = tid % 32, t4 = lane % 4;
  int qp[2], qlo[2];
  bool ok[2];
  long long orow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4 + 8 * h;
    const int pl = row / p.gc, g = g0 + row % p.gc;
    ok[h] = row < rows && g < G && q0 + pl < p.Lq;
    qp[h] = ok[h] ? p.qpos[(long long)b * p.Lq + q0 + pl] : kPadPos;
    const long long lo = (long long)qp[h] - p.window;
    qlo[h] = p.window > 0 ? (int)max(lo, (long long)INT_MIN) : INT_MIN;
    orow[h] = (((long long)b * p.Lq + q0 + pl) * p.H + (long long)kvh * G + g) * p.Dv;
  }
  const int ksteps = (p.D + 15) / 16;  // k16 steps of Q K^T; past D the boxes hold zeros
  const float scale2 = p.scale * kLog2e;  // scores and m in the log2 domain

  float o[OR];
#pragma unroll
  for (int i = 0; i < OR; ++i) o[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float s[32];
  uint32_t pa[4][4] = {};  // P of the previous block, bf16, wgmma's A fragment
  int prev = -1;      // the stage whose P V is still to run

  ml::mbar_wait(&qbar, 0);
  for (int it = 0;; ++it) {
    const int st = it % L::STAGES;
    ml::mbar_wait(&full[st], (it / L::STAGES) & 1);
    const int flag = flag_s[st];
    if (flag == FLAG_END) break;
    const uint8_t* ks = ring + st * L::STAGE_BYTES;

    // S = Q K^T of this block (this warpgroup's 64 rows x 64 slots, both
    // K-major), then the previous block's P V, in flight while this
    // block's softmax runs.
    ml::fence_regs(o);
    ml::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * W; ++kk) {
      if (kk < ksteps) {
        const uint64_t dq = ml::smem_desc(qs + (kk / 4) * Q_BOX + wg * 64 * ROW_BYTES + (kk % 4) * 32, 16, 1024);
        const uint64_t dk = ml::smem_desc(ks + (kk / 4) * KV_BOX + (kk % 4) * 32, 16, 1024);
        ml::wgmma_m64n64k16<0, 0>(s, dq, dk, kk > 0 ? 1 : 0);
      }
    }
    ml::wgmma_commit();
    if (prev >= 0) {
      const uint8_t* vs = ring + prev * L::STAGE_BYTES + W * KV_BOX;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(o, pa[kk], ml::smem_desc(vs + kk * 16 * ROW_BYTES, KV_BOX, 1024));
    }
    ml::wgmma_commit();
    ml::wgmma_wait<1>();
    ml::fence_regs(s);

    // Scale (log2(e) folded in), mask, the running max.  Register 4 j + e
    // holds row g + 8 (e / 2), slot 8 j + 2 t4 + e % 2.  A block every row
    // sees whole needs no mask.
    uint32_t vis = 0xffffffffu;
    float mx[2] = {kNeg, kNeg};
    if (flag == FLAG_WHOLE) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = __fmul_rn(s[i], scale2);
        mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int2 kp = *reinterpret_cast<const int2*>(&kpos_s[st][8 * j + 2 * t4]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2, kpv = e % 2 ? kp.y : kp.x;
          float x = __fmul_rn(s[4 * j + e], scale2);
          if (!(kpv >= 0 && (!p.causal || kpv <= qp[h]) && (p.window <= 0 || kpv > qlo[h]))) {
            x = kNeg;
            vis &= ~(1u << (4 * j + e));
          }
          s[4 * j + e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      mx[h] = fmaxf(m[h], mx[h]);  // m_new
    }
    // p = 2^(s - m_new), masked slots 0 explicitly; l takes the fp32 p.
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i % 4) / 2;
      const float e = (vis >> i) & 1u ? ex2(__fsub_rn(s[i], mx[h])) : 0.f;
      s[i] = e;
      sum[h] = __fadd_rn(sum[h], e);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] = __fadd_rn(sum[h], __shfl_xor_sync(0xffffffffu, sum[h], 1));
      sum[h] = __fadd_rn(sum[h], __shfl_xor_sync(0xffffffffu, sum[h], 2));
      alpha[h] = ex2(__fsub_rn(m[h], mx[h]));
      l[h] = __fadd_rn(__fmul_rn(l[h], alpha[h]), sum[h]);
      m[h] = mx[h];
    }
    // The previous block's P V is done: hand its stage back; then
    // acc = acc * alpha, and this block's P, rounded to bf16, becomes the A
    // fragment of each 16-slot step (the S fragment's registers 8 kk ..
    // 8 kk + 7) for the next iteration's P V.
    ml::wgmma_wait<0>();
    ml::fence_regs(o);
    fence_frag(pa);
    if (prev >= 0) ml::mbar_arrive(&empty[prev]);
#pragma unroll
    for (int i = 0; i < OR; ++i) o[i] = __fmul_rn(o[i], alpha[(i % 4) / 2]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    prev = st;
  }
  if (prev >= 0) {  // the last block's P V
    const uint8_t* vs = ring + prev * L::STAGE_BYTES + W * KV_BOX;
    ml::fence_regs(o);
    ml::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(o, pa[kk], ml::smem_desc(vs + kk * 16 * ROW_BYTES, KV_BOX, 1024));
    ml::wgmma_commit();
    ml::wgmma_wait<0>();
    ml::fence_regs(o);
    ml::mbar_arrive(&empty[prev]);
  }

  // Drain: acc / max(l, 1e-30), the one store of each output element (a
  // thread's two neighbouring columns as one pair; Dv is a multiple of 8).
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!ok[h]) continue;
    const float lh = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int j = 0; j < OR / 4; ++j) {
      const int c = 8 * j + 2 * t4;
      if (c < p.Dv)
        *reinterpret_cast<__nv_bfloat162*>(out + orow[h] + c) =
            __floats2bfloat162_rn(__fdiv_rn(o[4 * j + 2 * h], lh), __fdiv_rn(o[4 * j + 2 * h + 1], lh));
    }
  }
}

// Map of a row-major bf16 tensor of `rank` dims (innermost first) with the
// 128-byte swizzle; strides in bytes of dims 1 .. rank - 1.
bool encode_bf16(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                 const cuuint64_t* strides, const cuuint32_t* box) {
  const ml::EncodeTiled encode = ml::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int W>
int launch_wgmma(const Params& p, int B, int nq, int nh, cudaStream_t stream) {
  using L = FwdLayout<W>;
  auto kernel = flash_attn_wgmma_kernel<W>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  FwdArgs a{};
  a.p = p;
  const cuuint64_t G = p.H / p.Hkv, e = 2;
  // q as (B, Lq, Hkv, G, D), boxes of 64 dims x gc heads x 1 x qc positions.
  const cuuint64_t qd[5] = {(cuuint64_t)p.D, G, (cuuint64_t)p.Hkv, (cuuint64_t)p.Lq, (cuuint64_t)B};
  const cuuint64_t qst[4] = {p.D * e, G * p.D * e, (cuuint64_t)p.H * p.D * e,
                             (cuuint64_t)p.Lq * p.H * p.D * e};
  const cuuint32_t qbox[5] = {64, (cuuint32_t)p.gc, 1, (cuuint32_t)p.qc, 1};
  // k, v as (B, S, Hkv, D), boxes of 64 dims x 1 head x 64 slots.
  const cuuint64_t kd[4] = {(cuuint64_t)p.D, (cuuint64_t)p.Hkv, (cuuint64_t)p.S, (cuuint64_t)B};
  const cuuint64_t kst[3] = {p.D * e, (cuuint64_t)p.Hkv * p.D * e, (cuuint64_t)p.S * p.Hkv * p.D * e};
  const cuuint64_t vd[4] = {(cuuint64_t)p.Dv, (cuuint64_t)p.Hkv, (cuuint64_t)p.S, (cuuint64_t)B};
  const cuuint64_t vst[3] = {p.Dv * e, (cuuint64_t)p.Hkv * p.Dv * e,
                             (cuuint64_t)p.S * p.Hkv * p.Dv * e};
  const cuuint32_t kvbox[4] = {64, 1, KC, 1};
  // An empty kv tensor has no map; its walk has no block to load.
  const bool kv = p.S > 0;
  if (!encode_bf16(&a.q, p.q, 5, qd, qst, qbox) ||
      (kv && (!encode_bf16(&a.k, p.k, 4, kd, kst, kvbox) || !encode_bf16(&a.v, p.v, 4, vd, vst, kvbox))))
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<dim3(nq, B * p.Hkv, nh), ml::WIDE_THREADS, L::SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Which route a launch takes (the twin of kernels/flash_attn.py:fwd_route):
// wgmma for bf16 whose TMA'd operands (q, k, v) have 16-byte aligned bases
// and row strides, so D and Dv multiples of 8; SIMT otherwise.
int fwd_route(const void* q, const void* k, const void* v, int D, int Dv, int is_bf16) {
  return is_bf16 && ml::tma_ok(q, 2LL * D) && ml::tma_ok(k, 2LL * D) && ml::tma_ok(v, 2LL * Dv)
             ? ROUTE_WGMMA
             : ROUTE_SIMT;
}

}  // namespace

// C entry point: the forward attention of q over k/v (shapes above), all
// row-major and contiguous, in fp32 (is_bf16 = 0) or bf16 (1); window 0
// means none; `route` is the caller's (1 wgmma, 0 SIMT, from
// kernels/flash_attn.py:fwd_route), and one that differs from fwd_route's
// returns cudaErrorInvalidValue.  Returns cudaGetLastError() after the launch
// (0 on success); the wrapper raises on anything else.  Launches on
// `stream`, does not synchronise and allocates nothing.
extern "C" int flash_attn_fwd_launch(const void* q, const void* k, const void* v,
                                     const void* qpos, const void* kpos, void* out, int B,
                                     int Lq, int S, int H, int Hkv, int D, int Dv, int causal,
                                     int window, float scale, int is_bf16, int route,
                                     void* stream) {
  if (B <= 0 || Lq <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || D <= 0 || D > 128 || Dv <= 0 || Dv > 128 || S < 0 ||
      (long long)B * Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int r = fwd_route(q, k, v, D, Dv, is_bf16);
  if (route != r) return static_cast<int>(cudaErrorInvalidValue);
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
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  const int G = H / Hkv, rows = r == ROUTE_WGMMA ? WG_ROWS : ROWS;
  p.gc = G < rows ? G : rows;
  p.qc = rows / p.gc;
  const int nq = (Lq + p.qc - 1) / p.qc, nh = (G + p.gc - 1) / p.gc;
  if (nh > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = D > 64 || Dv > 64;
  if (r == ROUTE_WGMMA) return wide ? launch_wgmma<2>(p, B, nq, nh, s) : launch_wgmma<1>(p, B, nq, nh, s);
  const dim3 grid(nq, B * Hkv, nh);
  cudaError_t err;
  if (is_bf16)
    err = wide ? launch<__nv_bfloat16, 128>(p, grid, s) : launch<__nv_bfloat16, 64>(p, grid, s);
  else
    err = wide ? launch<float, 128>(p, grid, s) : launch<float, 64>(p, grid, s);
  return static_cast<int>(err);
}
