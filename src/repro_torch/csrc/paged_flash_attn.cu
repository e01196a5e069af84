// Paged int8 decode attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel repro/kernels/flash_attn.py:paged_flash_attention_tpu
// (body _paged_fa_kernel): one decode query token per sequence attends over
// that sequence's int8 K/V pages, reached through a block table of page ids.
//   q        (B, H, D)          fp32 or bf16
//   k, v     (P, page, Hkv, D)  int8 page pools, one fp32 scale per page
//   tables   (B, NP) int32      page ids, -1 = unmapped (clamped to 0 here)
//   lens     (B,) int32         tokens present; the query sits at len - 1
//   out      (B, H, Dv)         q's dtype
// Dequant rides the running softmax, as on the TPU: a score is
// q.k * (scale * k_scale[page]) in fp32 from the widened int8 payload, and
// the PV partial is weighted by v_scale[page], so the dequantized cache never
// exists in memory.  Token t of table slot j sits at kpos = j * page + t;
// kpos < len masks ragged tails and unmapped slots, and a sliding window
// further keeps kpos > len - 1 - window.  Masked scores are -1e30 and their
// probabilities are forced to 0; the running max and denominator are fp32,
// and the drain is acc / max(l, 1e-30), so len = 0 drains zeros.
//
// Schedule.  One CTA per (sequence, KV head, chunk of up to 8 query heads)
// holds that chunk's query rows (GQA), as the TPU kernel folds G heads into
// the rows of one tile; a group of G > 8 (granite-20b's 48 heads over one
// KV head) takes ceil(G / 8) CTAs, each reading the sequence's pages.  Its four
// warps walk the sequence's tokens 32 at a time, one token per lane: warp w
// takes token tiles w, w + 4, w + 8, ... of [first token of the window,
// min(len, NP * page)), so the CTA stops after ceil(len / page) pages and
// never reads a page that only masked slots would come from.  A warp stages
// its tile's int8 K and V rows in shared memory (16-, 8- or 4-byte global
// loads, the widest that divides the head dim), computes each lane's G scores,
// and updates its own fp32 running max, denominator and register accumulator
// (one warp-wide max and sum per query row and tile).  After the last tile the
// four warps' partial softmax states are merged in shared memory (the usual
// flash-decoding rescale by exp(m_w - max m), which reduces to the same result)
// and each output element is stored once.  Head dims above 128 (deepseek-v2-
// lite's MLA head: D = 192, Dv = 128) take the kernel's WIDE form: q at its
// full D in dynamic shared memory, K staged and scored 128 columns at a
// time, and one launch for each 128-wide chunk of Dv (each re-scoring the
// tokens).
//
// What bounds it on the H100: the bytes it must read, B * S * Hkv * (D + Dv)
// of int8 payload plus the scales, q and out, at 3.35 TB/s.  At B = 8 and
// S = 4096 with stablelm-1.6b's heads (Hkv = 32, D = Dv = 64) that is 134 MB,
// 40 us.  On the serve path (B = 1) the grid is only Hkv CTAs on 132 SMs (32
// for stablelm-1.6b, 8 for h2o-danube-3-4b), so there it is bound by launch
// and latency, not bytes.  A split of the pages over CTAs, cp.async/TMA
// double-buffering and tensor cores are later work; the measured times stand
// in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;             // tokens per warp step, one per lane
constexpr int kMaxD = 128;            // largest D and Dv (WIDE: a chunk of them)
constexpr int kMaxRow = kMaxD + 4;    // largest staged row stride (bytes)
constexpr int kMaxG = 8;              // query heads a CTA holds
constexpr float kNeg = -1e30f;

struct Params {
  const void* q;           // (B, H, D), fp32 or bf16
  const int8_t* k;         // (P, page, Hkv, D)
  const int8_t* v;         // (P, page, Hkv, Dv)
  const float* k_scale;    // (P,)
  const float* v_scale;    // (P,)
  const int* tables;       // (B, NP)
  const int* lens;         // (B,)
  void* out;               // (B, H, Dv), q's dtype
  int H, Hkv, D, Dv, page, NP;
  int window;              // <= 0: no window
  float scale;
  int is_bf16;
  int vec;                 // bytes per global load: 16, 8, 4 or 1
  int dv0;                 // WIDE: the launch's first output column
};

// A staged row's stride: the head dim rounded up to 4 bytes, then an odd
// number of 4-byte words, so the 32 lanes reading 32 rows at one column hit
// 32 different banks.
__host__ __device__ inline int row_stride(int d) {
  const int d4 = (d + 3) & ~3;
  return ((d4 / 4) % 2 == 0) ? d4 + 4 : d4;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy the tile's rows (token t0 + r for r < kTile, those in [lo, hi) only)
// from the pool into shared memory.  rows[r] is the row's element offset in
// units of d bytes: (page id * page + slot) * Hkv + head.
template <int VEC>
__device__ __forceinline__ void stage_rows(int8_t* dst, const int8_t* __restrict__ src,
                                           const long long* rows, int d, int rs,
                                           int t0, int lo, int hi, int lane) {
  const int cpr = d / VEC;
  for (int idx = lane; idx < kTile * cpr; idx += 32) {
    const int r = idx / cpr;
    const int c = idx - r * cpr;
    const int t = t0 + r;
    if (t < lo || t >= hi) continue;
    const int8_t* g = src + rows[r] * d + c * VEC;
    int8_t* s = dst + r * rs + c * VEC;
    if constexpr (VEC == 16) {
      const int4 x = *reinterpret_cast<const int4*>(g);
      int* si = reinterpret_cast<int*>(s);
      si[0] = x.x; si[1] = x.y; si[2] = x.z; si[3] = x.w;
    } else if constexpr (VEC == 8) {
      const int2 x = *reinterpret_cast<const int2*>(g);
      int* si = reinterpret_cast<int*>(s);
      si[0] = x.x; si[1] = x.y;
    } else if constexpr (VEC == 4) {
      *reinterpret_cast<int*>(s) = *reinterpret_cast<const int*>(g);
    } else {
      *s = *g;
    }
  }
}

__device__ __forceinline__ void stage(int8_t* dst, const int8_t* src, const long long* rows,
                                      int d, int rs, int t0, int lo, int hi, int lane,
                                      int vec) {
  switch (vec) {
    case 16: stage_rows<16>(dst, src, rows, d, rs, t0, lo, hi, lane); break;
    case 8: stage_rows<8>(dst, src, rows, d, rs, t0, lo, hi, lane); break;
    case 4: stage_rows<4>(dst, src, rows, d, rs, t0, lo, hi, lane); break;
    default: stage_rows<1>(dst, src, rows, d, rs, t0, lo, hi, lane); break;
  }
}

// The WIDE form's staging: columns [c0, c0 + w) of the tile's rows, a row
// of the pool being d bytes (stage_rows with a column window).
template <int VEC>
__device__ __forceinline__ void stage_cols(int8_t* dst, const int8_t* __restrict__ src,
                                           const long long* rows, int d, int c0, int w, int rs,
                                           int t0, int lo, int hi, int lane) {
  const int cpr = w / VEC;
  for (int idx = lane; idx < kTile * cpr; idx += 32) {
    const int r = idx / cpr;
    const int c = idx - r * cpr;
    const int t = t0 + r;
    if (t < lo || t >= hi) continue;
    const int8_t* g = src + rows[r] * d + c0 + c * VEC;
    int8_t* s = dst + r * rs + c * VEC;
    if constexpr (VEC == 16) {
      const int4 x = *reinterpret_cast<const int4*>(g);
      int* si = reinterpret_cast<int*>(s);
      si[0] = x.x; si[1] = x.y; si[2] = x.z; si[3] = x.w;
    } else if constexpr (VEC == 8) {
      const int2 x = *reinterpret_cast<const int2*>(g);
      int* si = reinterpret_cast<int*>(s);
      si[0] = x.x; si[1] = x.y;
    } else if constexpr (VEC == 4) {
      *reinterpret_cast<int*>(s) = *reinterpret_cast<const int*>(g);
    } else {
      *s = *g;
    }
  }
}

__device__ __forceinline__ void stage_window(int8_t* dst, const int8_t* src, const long long* rows,
                                             int d, int c0, int w, int rs, int t0, int lo, int hi,
                                             int lane, int vec) {
  switch (vec) {
    case 16: stage_cols<16>(dst, src, rows, d, c0, w, rs, t0, lo, hi, lane); break;
    case 8: stage_cols<8>(dst, src, rows, d, c0, w, rs, t0, lo, hi, lane); break;
    case 4: stage_cols<4>(dst, src, rows, d, c0, w, rs, t0, lo, hi, lane); break;
    default: stage_cols<1>(dst, src, rows, d, c0, w, rs, t0, lo, hi, lane); break;
  }
}

// WIDE (D or Dv above kMaxD): the launch computes the Dv columns [dv0, dv0 +
// kMaxD) of its query heads; q sits at its full D in dynamic shared memory,
// and each token tile's scores run over D in kMaxD-wide chunks of K staged
// one after another, the dot summed over d in the same order.  The rest is
// the kernel's own code (the WIDE parts sit in `if constexpr` branches).
template <int G_MAX, bool WIDE>
__global__ void __launch_bounds__(kThreads) paged_fa_kernel(Params p) {
  // K and V rows of each warp's tile; reused as the merge buffer at the end.
  __shared__ __align__(16) int8_t kv_s[kWarps][2][kTile * kMaxRow];
  __shared__ __align__(16) float q_s[kMaxG * kMaxD];
  __shared__ long long row_s[kWarps][kTile];
  extern __shared__ float4 q_wide[];     // WIDE: the CTA's q rows at full D

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int Gall = p.H / p.Hkv;          // query heads per KV head
  const int g0 = blockIdx.z * kMaxG;     // this CTA's first one
  const int G = min(kMaxG, Gall - g0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int D4 = (p.D + 3) & ~3;
  const int rs_k = row_stride(WIDE ? kMaxD : p.D);
  const int rs_v = row_stride(WIDE ? kMaxD : p.Dv);
  const int dvn = WIDE ? min(kMaxD, p.Dv - p.dv0) : 0;  // WIDE: the launch's output columns

  // Zero the staging area once: the pad bytes past D in each row then read
  // as 0 in the 4-byte score loads.
  int* kv_words = reinterpret_cast<int*>(&kv_s[0][0][0]);
  for (int i = threadIdx.x; i < kWarps * 2 * kTile * kMaxRow / 4; i += kThreads)
    kv_words[i] = 0;
  for (int i = threadIdx.x; i < G * D4; i += kThreads) {
    const int g = i / D4;
    const int d = i - g * D4;
    float x = 0.f;
    if (d < p.D) {
      const long long qi = ((long long)b * p.H + (long long)h * Gall + g0 + g) * p.D + d;
      x = p.is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.q)[qi])
                    : static_cast<const float*>(p.q)[qi];
    }
    if constexpr (WIDE)
      reinterpret_cast<float*>(q_wide)[g * D4 + d] = x;
    else
      q_s[g * D4 + d] = x;
  }
  __syncthreads();

  const int len = p.lens[b];
  // Tokens the table can address end at NP * page; the window starts at
  // len - window (kpos > len - 1 - window).
  const int hi = min(len, p.NP * p.page);
  const int lo = p.window > 0 ? max(0, len - p.window) : 0;

  float m[G_MAX], l[G_MAX], acc[G_MAX][kMaxD / 32];
#pragma unroll
  for (int g = 0; g < G_MAX; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxD / 32; ++j) acc[g][j] = 0.f;
  }

  int8_t* ks = kv_s[warp][0];
  int8_t* vs = kv_s[warp][1];
  long long* rows = row_s[warp];
  for (int t0 = (lo / kTile + warp) * kTile; t0 < hi; t0 += kWarps * kTile) {
    const int t = t0 + lane;
    const bool live = t >= lo && t < hi;
    float ksc = 0.f, vsc = 0.f;
    if (live) {
      const int pid = max(p.tables[(long long)b * p.NP + t / p.page], 0);
      ksc = p.k_scale[pid];
      vsc = p.v_scale[pid];
      rows[lane] = ((long long)pid * p.page + t % p.page) * p.Hkv + h;
    }
    if constexpr (!WIDE) {
      __syncwarp();
      stage(ks, p.k, rows, p.D, rs_k, t0, lo, hi, lane, p.vec);
      stage(vs, p.v, rows, p.Dv, rs_v, t0, lo, hi, lane, p.vec);
      __syncwarp();
    }

    // This lane's scores against its own token, from the widened payload.
    float s[G_MAX];
#pragma unroll
    for (int g = 0; g < G_MAX; ++g) s[g] = 0.f;
    const int8_t* krow = ks + lane * rs_k;
    if constexpr (!WIDE) {
      for (int d = 0; d < D4; d += 4) {
        const int w = *reinterpret_cast<const int*>(krow + d);
        const float k0 = (float)(int8_t)(w);
        const float k1 = (float)(int8_t)(w >> 8);
        const float k2 = (float)(int8_t)(w >> 16);
        const float k3 = (float)(int8_t)(w >> 24);
#pragma unroll
        for (int g = 0; g < G_MAX; ++g) {
          if (g < G) {
            const float4 qq = *reinterpret_cast<const float4*>(q_s + g * D4 + d);
            s[g] = fmaf(qq.x, k0, s[g]);
            s[g] = fmaf(qq.y, k1, s[g]);
            s[g] = fmaf(qq.z, k2, s[g]);
            s[g] = fmaf(qq.w, k3, s[g]);
          }
        }
      }
    } else {
      const float* qw = reinterpret_cast<const float*>(q_wide);
      for (int c0 = 0; c0 < p.D; c0 += kMaxD) {
        const int w = min(kMaxD, p.D - c0);
        __syncwarp();  // the previous chunk (or tile) is read
        stage_window(ks, p.k, rows, p.D, c0, w, rs_k, t0, lo, hi, lane, p.vec);
        if (c0 == 0) stage_window(vs, p.v, rows, p.Dv, p.dv0, dvn, rs_v, t0, lo, hi, lane, p.vec);
        __syncwarp();
        // Pad columns past D meet q's zeros.
        for (int d = 0; d < ((w + 3) & ~3); d += 4) {
          const int wd = *reinterpret_cast<const int*>(krow + d);
          const float k0 = (float)(int8_t)(wd);
          const float k1 = (float)(int8_t)(wd >> 8);
          const float k2 = (float)(int8_t)(wd >> 16);
          const float k3 = (float)(int8_t)(wd >> 24);
#pragma unroll
          for (int g = 0; g < G_MAX; ++g) {
            if (g < G) {
              const float4 qq = *reinterpret_cast<const float4*>(qw + g * D4 + c0 + d);
              s[g] = fmaf(qq.x, k0, s[g]);
              s[g] = fmaf(qq.y, k1, s[g]);
              s[g] = fmaf(qq.z, k2, s[g]);
              s[g] = fmaf(qq.w, k3, s[g]);
            }
          }
        }
      }
    }

    // Online softmax over this tile; s[g] becomes the PV weight p * v_scale.
    const float fold = p.scale * ksc;
#pragma unroll
    for (int g = 0; g < G_MAX; ++g) {
      if (g < G) {
        const float sg = live ? s[g] * fold : kNeg;
        const float m_new = fmaxf(m[g], warp_max(sg));
        const float pg = live ? expf(sg - m_new) : 0.f;
        const float alpha = expf(m[g] - m_new);
        l[g] = l[g] * alpha + warp_sum(pg);
        m[g] = m_new;
#pragma unroll
        for (int j = 0; j < kMaxD / 32; ++j) acc[g][j] *= alpha;
        s[g] = live ? pg * vsc : 0.f;
      }
    }

    // PV: lane owns output columns lane, lane + 32, ...
    const int r_lo = max(lo - t0, 0);
    const int r_hi = min(hi - t0, kTile);
    for (int r = r_lo; r < r_hi; ++r) {
      const int8_t* vrow = vs + r * rs_v;
      float vv[kMaxD / 32];
#pragma unroll
      for (int j = 0; j < kMaxD / 32; ++j) {
        const int dv = lane + 32 * j;
        vv[j] = dv < (WIDE ? dvn : p.Dv) ? (float)vrow[dv] : 0.f;
      }
#pragma unroll
      for (int g = 0; g < G_MAX; ++g) {
        if (g < G) {
          const float w = __shfl_sync(0xffffffffu, s[g], r);
#pragma unroll
          for (int j = 0; j < kMaxD / 32; ++j) acc[g][j] = fmaf(w, vv[j], acc[g][j]);
        }
      }
    }
    __syncwarp();
  }

  // Merge the four warps' softmax states, then one store per element.
  __syncthreads();
  float* ml = reinterpret_cast<float*>(&kv_s[0][0][0]);   // [warp][g][2]
  float* accs = ml + kWarps * kMaxG * 2;                   // [warp][g][kMaxD]
#pragma unroll
  for (int g = 0; g < G_MAX; ++g) {
    if (g < G) {
      if (lane == 0) {
        ml[(warp * kMaxG + g) * 2] = m[g];
        ml[(warp * kMaxG + g) * 2 + 1] = l[g];
      }
#pragma unroll
      for (int j = 0; j < kMaxD / 32; ++j) {
        const int dv = lane + 32 * j;
        if (dv < (WIDE ? dvn : p.Dv)) accs[(warp * kMaxG + g) * kMaxD + dv] = acc[g][j];
      }
    }
  }
  __syncthreads();
  const int Dn = WIDE ? dvn : p.Dv;  // output columns of this launch
  for (int i = threadIdx.x; i < G * Dn; i += kThreads) {
    const int g = i / Dn;
    const int dv = i - g * Dn;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ml[(w * kMaxG + g) * 2]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(ml[(w * kMaxG + g) * 2] - mx);
      lsum += f * ml[(w * kMaxG + g) * 2 + 1];
      a += f * accs[(w * kMaxG + g) * kMaxD + dv];
    }
    const float o = a / fmaxf(lsum, 1e-30f);
    long long oi = ((long long)b * p.H + (long long)h * Gall + g0 + g) * p.Dv + dv;
    if constexpr (WIDE) oi += p.dv0;
    if (p.is_bf16)
      static_cast<__nv_bfloat16*>(p.out)[oi] = __float2bfloat16_rn(o);
    else
      static_cast<float*>(p.out)[oi] = o;
  }
}

template <int G_MAX>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int chunks = (p.H / p.Hkv + kMaxG - 1) / kMaxG;
  if (p.D <= kMaxD && p.Dv <= kMaxD) {
    paged_fa_kernel<G_MAX, false><<<dim3(p.Hkv, B, chunks), kThreads, 0, stream>>>(p);
    return cudaGetLastError();
  }
  // Head dims above kMaxD: q's rows at full D, one launch a chunk of Dv.
  auto kernel = paged_fa_kernel<G_MAX, true>;
  const int bytes = kMaxG * ((p.D + 3) & ~3) * 4;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  for (int dv0 = 0; err == cudaSuccess && dv0 < p.Dv; dv0 += kMaxD) {
    Params c = p;
    c.dv0 = dv0;
    kernel<<<dim3(p.Hkv, B, chunks), kThreads, bytes, stream>>>(c);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// Plain C entry point: returns cudaGetLastError() after the launch (0 on
// success); the wrapper raises on anything else.  Launches on `stream`,
// does not synchronise and allocates nothing.
extern "C" int paged_flash_attn_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* tables, const void* lens, void* out,
    int B, int H, int Hkv, int D, int Dv, int page, int NP, int window,
    float scale, int is_bf16, int vec, void* stream) {
  if (B <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > 65535 * kMaxG || D <= 0 || Dv <= 0 ||
      page <= 0 || NP < 0 || B > 65535 ||
      (vec != 16 && vec != 8 && vec != 4 && vec != 1) || D % vec || Dv % vec)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = static_cast<const int8_t*>(k);
  p.v = static_cast<const int8_t*>(v);
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.tables = static_cast<const int*>(tables);
  p.lens = static_cast<const int*>(lens);
  p.out = out;
  p.H = H;
  p.Hkv = Hkv;
  p.D = D;
  p.Dv = Dv;
  p.page = page;
  p.NP = NP;
  p.window = window;
  p.scale = scale;
  p.is_bf16 = is_bf16;
  p.vec = vec;
  p.dv0 = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
  cudaError_t err;
  if (G <= 1)
    err = launch<1>(p, B, s);
  else if (G <= 2)
    err = launch<2>(p, B, s);
  else if (G <= 4)
    err = launch<4>(p, B, s);
  else
    err = launch<8>(p, B, s);
  return (int)err;
}
