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
// probabilities are 0; the running max and denominator are fp32, and the
// drain is acc / max(l, 1e-30), so len = 0 drains zeros.
//
// Schedule (flash-decoding, merged in the same launch).  The grid is
// (splits, Hkv, B * chunks * vchunks): one CTA per (split, KV head,
// sequence, chunk of query heads, chunk of output columns).  The wrapper
// (kernels/flash_attn.py: paged_plan, paged_splits) picks the plan:
//  - group: the query heads a CTA holds, the whole group G up to 64
//    (granite-20b's 48 among them), and dvc: the output columns it
//    computes, all of Dv up to 256 (D = 192 with Dv = 128, D = Dv = 256),
//    so chunks = vchunks = 1 and each (sequence, KV head, split) reads each
//    page byte once and scores each token once, whatever G; a G past 64
//    takes chunks of heads, each reading the pages again, and a Dv past
//    256 chunks of whole 16-byte units, each scoring the tokens again
//    (deepseek-v2's absorbed MLA head, D = 576 with Dv = 512: two);
//  - ng: the CTA's token groups (below), 4 / wh by default; where the CTA's
//    shared memory would not hold the plan, fewer token groups, then half
//    the heads, then half the columns, until it does;
//  - dkc: where one token group of one head cannot stage a K row even at
//    16 columns (D above ~3,300), the plan is wide (the WIDE_D form of the
//    kernel, its own instantiations): K rows are staged dkc bytes (1024) at
//    a time through the group's two K stages, unshifted, by cp.async (never
//    TMA), the next chunk in flight while one is scored, and each token's
//    score is summed over the chunks in the CTA before its softmax; q stays
//    whole in shared memory.  Plans that stage whole rows keep their
//    instantiations;
//  - splits: each CTA computes its own tokens on the device from len and
//    window: the live range [lo, hi) = [max(0, len - window), min(len,
//    NP * page)) cut into `splits` equal parts of whole 32-token tiles, so a
//    short or windowed sequence spreads its live tokens over its first
//    splits and a split with none keeps the empty state (m = -1e30, l = 0,
//    acc = 0); the count fills one wave of the card's SMs, at most 8, at
//    most one a table page.
// The splits of a (KV head, sequence, chunk) form one thread-block cluster
// (at most 8 CTAs, the portable most); after its tokens each CTA leaves its
// unnormalized (m, l, acc) in shared memory, and after a cluster barrier
// every CTA merges a slice of the output elements from all ranks' shared
// memory (distributed shared memory) by the usual rescale exp(m_r - max m),
// summed in rank order, so the result is the same from run to run and
// poisoned free pages give bit-identical outputs.  splits = 1 drains
// directly, with no cluster.
//
// Inside a CTA.  Its warps form token groups: the ceil(group / 8) warps of
// a group share a ring of two tiles of 32 tokens' K and V rows in dynamic
// shared memory, each warp holding up to 8 of the query heads; the split's
// tiles go to the groups in turn (a group of one warp needs only
// __syncwarp, a larger one a named barrier, once a tile), and the groups'
// (m, l, acc) merge in order at the end.  The next tile is in flight while
// one is scored.  Feed, two ways, picked by the wrapper (tma_rows):
//  - TMA: where pages hold whole tiles (page % 32 == 0) and a row, or its
//    16-byte window below, is 64 or 128 bytes (stablelm-1.6b's 64, h2o-
//    danube-3-4b's 120 in a 128-byte window, granite-20b's 128), the tiles
//    start at multiples of 32 tokens, so each lies in one page: a token
//    slab of the pool is Hkv rows, so the tile's rows of one head are one
//    strided box, and one thread issues a K box and a V box a tile
//    (cp.async.bulk.tensor, 64- or 128-byte swizzle, completion on the
//    stage's mbarrier); the readers undo the swizzle.  Measured against
//    the cp.async feed with the same tiles (PERF.md): 17 % faster for
//    danube at B = 8, 6-8 % at B = 1, within 1 % on stablelm at B = 8;
//  - cp.async otherwise (16-, 8- or 4-byte copies, the widest that divides
//    both head dims and the pools' bases; byte copies for odd dims), the
//    group's threads on consecutive chunks of the tile's rows.
// Each tile's page ids come from the block table a tile ahead, in a
// register, and its page scales by 4-byte cp.async beside it.  Rows of
// D = 8 (mod 16) bytes (danube's 120) are staged in the 16-byte aligned
// window around them, 0 or 8 bytes in: Hkv * D is whole 16-byte chunks
// there, so the offset is (h * D) % 16 for every token, and a window never
// leaves its token's slab.  Scores: lane = token, each 16-byte chunk of K
// widened once for the warp's heads, q in shared memory in fp32 (fp32 q
// keeps fp32 products); the softmax runs in the log2 domain across the
// warp, all its heads' shuffles interleaved.  PV: lanes own whole 32-bit
// words of V (4 output columns) for the warp's heads and a residue of the
// tile's tokens, the residues summed once, by shuffles, after the last
// tile.  int8 widens by a byte permute into the mantissa of 2^23 (no I2F,
// which issues at a fraction of the FMA rate).
//
// What bounds it on the H100: the bytes it must read, the live tokens'
// Hkv * (D + Dv) int8 payload plus the scales, q and out, at 3.35 TB/s
// (B = 8, S = 4096 with stablelm-1.6b's heads: 134 MB, 40 us); at serving
// batch (B = 1) the launch, the cluster barriers and the chain of
// dependent reads (lens, table, rows) that the splits shorten; for a large
// group (granite-20b's G = 48) the fp32 FMAs.  Measured: PERF.md.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 32;            // tokens a warp's ring stage holds, one a lane
constexpr int kStages = 2;           // ring depth: one tile in flight while one is scored
constexpr int kMaxSplits = 8;        // CTAs of a cluster (the portable most)
constexpr int kMaxWarps = 8;         // warps a CTA holds
constexpr int kMaxGroup = 64;        // query heads a CTA holds (8 warps of 8)
constexpr int kUnits = 2;            // 4-column words of V a lane holds (Dv <= 256)
constexpr int kSmemMax = 232448;     // dynamic shared memory a CTA may use
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// The kernel's argument, kept within 128 bytes: three more ints past that
// made nvcc's code for the GQA and MLA plans 6-12 % slower on the H100
// (PERF.md), so the batch and the chunk counts stay off it (the
// grid carries them; the kernel derives the counts).
struct Params {
  const void* q;           // (B, H, D), fp32 or bf16
  const int8_t* k;         // (P, page, Hkv, D)
  const int8_t* v;         // (P, page, Hkv, Dv)
  const float* k_scale;    // (P,)
  const float* v_scale;    // (P,)
  const int* tables;       // (B, NP)
  const int* lens;         // (B,)
  void* out;               // (B, H, Dv), q's dtype
  int ng;                  // token groups a CTA holds
  int H, Hkv, D, Dv, page, NP;
  int window;              // <= 0: no window
  float scale;
  int is_bf16;
  int vec;                 // bytes per copy: 16, 8, 4 or 1
  int shift;               // 1: rows of D, Dv = 8 (mod 16) bytes copied as the
                           // 16-byte aligned window around them (vec 16)
  union {
    int tma;               // 1: each tile's rows by two TMA boxes (page % 32 == 0,
                           // windows of 64 or 128 bytes), swizzled
    int dkc;               // WIDE_D form (never TMA): K bytes of a row staged at a
                           // time, a multiple of 16 below D
  };
  int group;               // query heads a CTA holds (chunks: ceil(G / group))
  int dvc;                 // output columns a CTA computes, Dv or a multiple of 16
                           // (vchunks: ceil(Dv / dvc))
  int splits;              // CTAs (cluster ranks) per (KV head, sequence, chunk)
};
static_assert(sizeof(Params) <= 128, "Params past 128 bytes slows the kernel");

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The CTA's shape and dynamic shared memory, in bytes from its base.
// kernels/flash_attn.py:_paged_shape and paged_smem_bytes are its twins.
// The TMA feed's tensor maps: the pool as (P * page token slabs, Hkv * D
// bytes), boxes of kTile slabs by one row's window.
struct Maps {
  CUtensorMap k, v;
};

struct Layout {
  int wh;    // warps sharing a token tile (a token group), 8 heads a warp at most
  int hw;    // query heads a warp holds
  int GP;    // hw rounded up to 1, 2, 4 or 8 (the kernel's template argument)
  int ng;    // token groups (each its own ring and softmax states), the plan's
  int NW;    // warps: ng * wh
  int Hp;    // head slots: wh * GP (warp j's heads at j * GP + i)
  int DQ, rsK, rsV, W, OW, R;
  int q, kring, vring, ksc, vsc, kofs, vofs, pid, pw, O, m, l, fac, den, bar, total;
};

// Dv here is the CTA's output columns (the plan's dvc), ng its token groups;
// dkc > 0 (a wide plan): K rows staged dkc bytes at a time.
__host__ __device__ inline Layout make_layout(int group, int ng, int D, int Dv, int shift, int dkc) {
  constexpr int stages = kStages;
  Layout L;
  L.wh = (group + 7) / 8;
  L.hw = (group + L.wh - 1) / L.wh;
  L.GP = L.hw <= 1 ? 1 : L.hw <= 2 ? 2 : L.hw <= 4 ? 4 : 8;
  L.ng = ng;
  L.NW = L.ng * L.wh;
  L.Hp = L.wh * L.GP;
  L.DQ = round_up(D, 16);                           // q's padded row
  const int pad = shift ? 8 : 0;                    // a shifted row's offset
  const int kq = dkc > 0 ? round_up(dkc, 16) : L.DQ;  // a staged K row (or chunk)
  const int rk = round_up(pad + kq, 16);            // its 16-byte reads end there
  L.rsK = (rk / 16) % 2 ? rk : rk + 16;             // odd 16-byte units: no bank conflict
  L.rsV = round_up(Dv + pad, 16);
  L.W = (Dv + 3) / 4;                               // 32-bit words of a V row
  L.OW = 4 * L.W;
  int R = 1;                                        // token residues of a PV word
  while (R < 8 && 2 * R * L.W <= 32) R *= 2;
  L.R = R;
  // The rings start 1024-byte aligned (TMA's swizzle atoms) from kring, which
  // the kernel rounds up within 1024 bytes of slack.
  const int kbytes = round_up(L.ng * stages * kTile * L.rsK, 1024);
  const int ring = 1024 + kbytes + round_up(L.ng * stages * kTile * L.rsV, 1024);
  const int merge = L.ng * L.Hp * (L.OW + 2) * 4;   // the groups' states, on the rings
  int off = 0;
  L.q = off;     off += round_up(L.Hp * L.DQ * 4, 16);
  L.kring = off;
  L.vring = kbytes;                                 // from the aligned K ring
  off += round_up(ring > merge ? ring : merge, 16);
  L.ksc = off;   off += L.ng * stages * kTile * 4;
  L.vsc = off;   off += L.ng * stages * kTile * 4;
  L.kofs = off;  off += L.ng * 2 * kTile * 8;
  L.vofs = off;  off += L.ng * 2 * kTile * 8;
  L.pid = off;   off += L.ng * 2 * kTile * 4;
  L.pw = off;    off += L.NW * kTile * L.GP * 4;
  L.O = off;     off += round_up(L.Hp * L.OW * 4, 16);
  L.m = off;     off += round_up(L.Hp * 4, 16);
  L.l = off;     off += round_up(L.Hp * 4, 16);
  L.fac = off;   off += round_up(kMaxSplits * L.Hp * 4, 16);
  L.den = off;   off += round_up(L.Hp * 4, 16);
  L.bar = off;   off += round_up(L.ng * stages * 8, 16);
  L.total = off;
  return L;
}

// The warp's max (sum) of each of N values, their shuffles interleaved.
template <int N>
__device__ __forceinline__ void warp_max_n(float* x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = fmaxf(x[i], __shfl_xor_sync(0xffffffffu, x[i], o));
}

template <int N>
__device__ __forceinline__ void warp_sum_n(float* x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] += __shfl_xor_sync(0xffffffffu, x[i], o);
}

// Byte j (0-3) of a word of int8, widened without a conversion instruction:
// from the word with each byte's sign bit flipped (b + 128), moved by a byte
// permute into the mantissa of 2^23, and the 2^23 + 128 taken off (exact for
// every int8).  The GEMM kernel's i8_f32_at, copied so that its source and
// SASS stay as they are.
__device__ __forceinline__ float i8_f32_at(uint32_t flipped, int j) {
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7440 | j)) - 8388736.f;
}

__device__ __forceinline__ void widen4(uint32_t w, float* f) {
  const uint32_t x = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = i8_f32_at(x, j);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The TMA feed: a box of the pool into a stage, its bytes counted on the
// stage's mbarrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, uint64_t* bar, int x,
                                        int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(x), "r"(y)
      : "memory");
}

// Byte `o` (a multiple of 4) of staged row r: rows of `pitch` bytes, plain,
// or (TMA) with each 16-byte chunk swizzled by the row's 128-byte line (the
// 128-byte swizzle for 128-byte rows, the 64-byte one for 64-byte rows).
__device__ __forceinline__ int staged(int r, int o, int pitch, bool swz) {
  if (!swz) return r * pitch + o;
  const int mask = pitch == 128 ? 7 : 3;
  return r * pitch + ((((o >> 4) ^ ((r * pitch) >> 7)) & mask) | ((o >> 4) & ~mask)) * 16 +
         (o & 15);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kStages - 2 of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

// The barrier of a token group: its warp alone, or its wh warps (named
// barrier 1 + group; 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int grp, int threads) {
  if (threads == 32)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "r"(threads) : "memory");
}

template <int VEC>
__device__ __forceinline__ void copy_chunk(int8_t* dst, const int8_t* src) {
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  } else if constexpr (VEC == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  } else if constexpr (VEC == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  } else {
    *dst = *src;  // odd head dims: a plain byte copy, seen after the barrier
  }
}

// Copy a tile's rows (ofs[r] >= 0: the row's byte offset in the pool; with
// `window`, from the 16-byte boundary below it) into a stage, `bytes` a row
// in chunks of VEC, the group's nt threads on consecutive chunks.
template <int VEC>
__device__ __forceinline__ void stage_rows(int8_t* dst, const int8_t* __restrict__ src,
                                           const long long* ofs, int bytes, int rs, int t,
                                           int nt, bool window) {
  const int cpr = bytes / VEC;
  const int total = kTile * cpr;
  const int dr = nt / cpr, dc = nt - (nt / cpr) * cpr;
  int r = t / cpr, c = t - (t / cpr) * cpr;
#pragma unroll 4
  for (int idx = t; idx < total; idx += nt) {
    const long long o = ofs[r];
    if (o >= 0) copy_chunk<VEC>(dst + r * rs + c * VEC, src + (window ? o & ~15LL : o) + c * VEC);
    r += dr;
    c += dc;
    if (c >= cpr) {
      c -= cpr;
      ++r;
    }
  }
}

__device__ __forceinline__ void stage(int8_t* dst, const int8_t* src, const long long* ofs,
                                      int bytes, int rs, int t, int nt, int vec, bool window) {
  switch (vec) {
    case 16: stage_rows<16>(dst, src, ofs, bytes, rs, t, nt, window); break;
    case 8: stage_rows<8>(dst, src, ofs, bytes, rs, t, nt, false); break;
    case 4: stage_rows<4>(dst, src, ofs, bytes, rs, t, nt, false); break;
    default: stage_rows<1>(dst, src, ofs, bytes, rs, t, nt, false); break;
  }
}

// 16 int8 of staged K row r from byte o widened to fp32: one 16-byte read
// where o is 16-byte aligned, else (a shifted row) two 8-byte halves.
__device__ __forceinline__ void widen16(const int8_t* ring, int r, int o, int pitch, bool swz,
                                        float* kf) {
  uint4 kw;
  if (o % 16 == 0) {
    kw = *reinterpret_cast<const uint4*>(ring + staged(r, o, pitch, swz));
  } else {
    const uint2 a = *reinterpret_cast<const uint2*>(ring + staged(r, o, pitch, swz));
    const uint2 b = *reinterpret_cast<const uint2*>(ring + staged(r, o + 8, pitch, swz));
    kw = make_uint4(a.x, a.y, b.x, b.y);
  }
  widen4(kw.x, kf);
  widen4(kw.y, kf + 4);
  widen4(kw.z, kf + 8);
  widen4(kw.w, kf + 12);
}

template <int GP>
__device__ __forceinline__ void load_p(const float* src, float* p) {
  if constexpr (GP == 1) {
    p[0] = src[0];
  } else if constexpr (GP == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    p[0] = x.x; p[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < GP / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(src)[i];
      p[4 * i] = x.x; p[4 * i + 1] = x.y; p[4 * i + 2] = x.z; p[4 * i + 3] = x.w;
    }
  }
}

__device__ __forceinline__ void store_out(const Params& p, long long i, float o) {
  if (p.is_bf16)
    static_cast<__nv_bfloat16*>(p.out)[i] = __float2bfloat16_rn(o);
  else
    static_cast<float*>(p.out)[i] = o;
}

// WIDE_D: the wide plans' form (K rows staged p.dkc bytes at a time).
template <int GP, bool WIDE_D>
__global__ void __launch_bounds__(kMaxWarps * 32)
    paged_fa_kernel(Params p, const __grid_constant__ Maps maps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(p.group, p.ng, p.D, p.dvc, p.shift, WIDE_D ? p.dkc : 0);
  constexpr int S = kStages;
  const int NT = 32 * L.NW;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = warp / L.wh;               // this warp's token group
  const int wj = warp - grp * L.wh;          // its place in the group (its heads)
  const int GT = 32 * L.wh;                  // the group's threads
  const int gtid = tid - grp * GT;

  // blockIdx.z: ((sequence, head chunk), column chunk), the column chunk
  // fastest.
  const int vchunks = (p.Dv + p.dvc - 1) / p.dvc;
  const int dv0 = (blockIdx.z % vchunks) * p.dvc;     // first output column
  const int ncol = min(p.dvc, p.Dv - dv0);            // and their count
  const bool shifted = p.shift != 0;
  const bool tma = !WIDE_D && p.tma != 0;
  const int rowK = shifted ? round_up(p.D + 8, 16) : p.D;   // bytes copied a row
  const int rowV = shifted ? round_up(ncol + 8, 16) : ncol;
  const int pitchK = tma ? rowK : L.rsK;                    // a staged row's bytes
  const int pitchV = tma ? rowV : L.rsV;
  float* q_s = reinterpret_cast<float*>(smem + L.q);                    // [Hp][DQ]
  const uint32_t ring0 = smem_addr(smem + L.kring);
  int8_t* ring = reinterpret_cast<int8_t*>(smem + L.kring) + ((1024 - ring0 % 1024) % 1024);
  int8_t* k_ring = ring + grp * S * kTile * pitchK;
  int8_t* v_ring = ring + L.vring + grp * S * kTile * pitchV;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar) + grp * S;   // a stage's TMA bytes
  float* ksc_s = reinterpret_cast<float*>(smem + L.ksc) + grp * S * kTile;
  float* vsc_s = reinterpret_cast<float*>(smem + L.vsc) + grp * S * kTile;
  long long* kofs_s = reinterpret_cast<long long*>(smem + L.kofs) + grp * 2 * kTile;
  long long* vofs_s = reinterpret_cast<long long*>(smem + L.vofs) + grp * 2 * kTile;
  int* pid_s = reinterpret_cast<int*>(smem + L.pid) + grp * 2 * kTile;
  float* P_w = reinterpret_cast<float*>(smem + L.pw) + warp * kTile * GP;  // [kTile][GP]

  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int G = p.H / p.Hkv;
  const int chunks = (G + p.group - 1) / p.group;
  const int zc = blockIdx.z / vchunks;
  const int b = zc / chunks;
  const int g0 = (zc % chunks) * p.group;
  const int Gc = min(p.group, G - g0);
  const int nh = max(0, min(L.hw, Gc - wj * L.hw));   // this warp's heads

  // This split's tokens: the live range cut into p.splits equal parts; the
  // split's tiles of kTile tokens go to the token groups in turn (with TMA
  // they start at multiples of kTile, so none crosses a page).
  const int len = p.lens[b];
  const int hi = static_cast<int>(min(static_cast<long long>(len),
                                      static_cast<long long>(p.NP) * p.page));
  const int lo = p.window > 0 ? max(0, len - p.window) : 0;
  const int n = max(0, hi - lo);
  const int per = round_up((n + p.splits - 1) / p.splits, kTile);   // whole tiles a split
  const int t_begin = lo + static_cast<int>(min(static_cast<long long>(n),
                                                static_cast<long long>(split) * per));
  const int t_end = lo + static_cast<int>(min(static_cast<long long>(n),
                                              static_cast<long long>(split + 1) * per));
  const int tile0 = tma ? t_begin & ~(kTile - 1) : t_begin;
  const int ntile = t_end > t_begin ? (t_end - tile0 + kTile - 1) / kTile : 0;
  const int mine = grp < ntile ? (ntile - grp + L.ng - 1) / L.ng : 0;

  // q of every head slot (zero for the padding slots), fp32.
  for (int i = tid; i < L.Hp * L.DQ; i += NT) {
    const int slot = i / L.DQ;
    const int d = i - slot * L.DQ;
    const int gi = slot % GP;
    const int g = (slot / GP) * L.hw + gi;
    float x = 0.f;
    if (gi < L.hw && g < Gc && d < p.D) {
      const long long qi = ((long long)b * p.H + (long long)h * G + g0 + g) * p.D + d;
      x = p.is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.q)[qi])
                    : static_cast<const float*>(p.q)[qi];
    }
    q_s[i] = x;
  }

  // Tile i of this group: its table entries (a tile ahead, in a register),
  // its rows' byte offsets (slot i & 1), its copies.
  auto tile_at = [&](int i) { return tile0 + (grp + i * L.ng) * kTile; };
  auto table_at = [&](int i) {
    const int t = tile_at(i) + gtid;
    return gtid < kTile && i < mine && t < t_end ? p.tables[(long long)b * p.NP + t / p.page] : 0;
  };
  auto rows_from = [&](int i, int entry) {
    if (gtid < kTile) {
      const int t = tile_at(i) + gtid;
      const int pid = max(entry, 0);
      const bool live = i < mine && t >= t_begin && t < t_end;
      const long long row = ((long long)pid * p.page + t % p.page) * p.Hkv + h;
      kofs_s[(i & 1) * kTile + gtid] = live ? row * p.D : -1;
      vofs_s[(i & 1) * kTile + gtid] = live ? row * p.Dv + dv0 : -1;
      pid_s[(i & 1) * kTile + gtid] = pid;
    }
  };
  auto issue = [&](int i) {
    if (i < mine) {
      const int st = i % S;
      const int sl = (i & 1) * kTile;
      if (tma) {
        if (gtid == 0) {
          const int t = tile_at(i);
          const int y = pid_s[sl] * p.page + t % p.page;
          mbar_expect_tx(bar + st, kTile * (rowK + rowV));
          tma_box(k_ring + st * kTile * pitchK, &maps.k, bar + st, (h * p.D) & ~15, y);
          tma_box(v_ring + st * kTile * pitchV, &maps.v, bar + st, (h * p.Dv) & ~15, y);
        }
      } else {
        if constexpr (!WIDE_D)   // (a wide plan stages K in chunks as it scores)
          stage(k_ring + st * kTile * pitchK, p.k, kofs_s + sl, rowK, pitchK, gtid, GT, p.vec,
                shifted);
        stage(v_ring + st * kTile * pitchV, p.v, vofs_s + sl, rowV, pitchV, gtid, GT, p.vec,
              shifted);
      }
      if (gtid < kTile && kofs_s[sl + gtid] >= 0) {
        const int pid = pid_s[sl + gtid];
        cp_async4(ksc_s + st * kTile + gtid, p.k_scale + pid);
        cp_async4(vsc_s + st * kTile + gtid, p.v_scale + pid);
      }
    }
    cp_async_commit();  // every thread, every tile: the group count stays in step
  };

  // This lane's PV units: words of V (4 output columns) for the warp's GP
  // heads, and a residue of the tile's tokens (R > 1), or up to kUnits
  // words over all tokens.
  const int W = L.W, R = L.R;
  const int rr = R > 1 ? lane / W : 0;
  int w_of[kUnits];
  bool has[kUnits];
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    w_of[k] = R > 1 ? lane - rr * W : lane + 32 * k;
    has[k] = R > 1 ? k == 0 && rr < R : w_of[k] < W;
  }
  float acc[kUnits][GP][4], m[GP], l[GP];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int k = 0; k < kUnits; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[k][g][j] = 0.f;
  }

  if (tma && gtid < S) mbar_init(bar + gtid);
  if (tma) asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();  // q_s, the barriers
  int entry = table_at(0);
  rows_from(0, entry);
  entry = table_at(1);
  for (int j = 0; j + 1 < S; ++j) {
    group_sync(grp, GT);
    issue(j);
    rows_from(j + 1, entry);
    entry = table_at(j + 2);
  }

  const float fold = p.scale * kLog2e;   // softmax in the log2 domain
  const int nc = L.DQ / 16;
  const float* q_w = q_s + wj * GP * L.DQ;
  // Where a shifted row sits in its window: Hkv is even (Hkv * D is whole
  // 16-byte chunks, D is not), so row index = h (mod 2) for every token.
  const int ksh = shifted ? (h * p.D) & 15 : 0;
  const int vsh = shifted ? (h * p.Dv) & 15 : 0;
  for (int i = 0; i < mine; ++i) {
    if (tma) mbar_wait(bar + i % S, (i / S) & 1);   // tile i's boxes have landed,
    cp_async_wait();        // tile i has landed (this thread's copies) ...
    group_sync(grp, GT);    // ... the group's, and its tile i - 1 is done with
    issue(i + S - 1);
    if constexpr (!WIDE_D) {
      rows_from(i + S, entry);
      entry = table_at(i + S + 1);
      if (nh == 0) continue;
    }
    const int st = i % S;
    const int t0 = tile_at(i);
    const int nend = min(kTile, t_end - t0);   // rows past it are past the range
    const bool live = t0 + lane >= t_begin && lane < nend;

    // Scores of this lane's token for the warp's heads (padding slots meet
    // q's zeros).
    float s[GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) s[g] = 0.f;
    if constexpr (WIDE_D) {
      // The tile's K rows chunk by chunk through the group's K stages (the
      // next chunk in flight while one is scored), every thread of the
      // group staging, the score summed over the chunks; then tile i's
      // row offsets (slot i & 1) are free for tile i + S.
      const int sl = (i & 1) * kTile;
      const int nkc = (p.D + p.dkc - 1) / p.dkc;
      auto stage_chunk = [&](int c) {
        const int d0 = c * p.dkc;
        stage(k_ring + (c % S) * kTile * pitchK, p.k + d0, kofs_s + sl, min(p.dkc, p.D - d0), pitchK,
              gtid, GT, p.vec, false);
        cp_async_commit();
      };
      stage_chunk(0);
      for (int c = 0; c < nkc; ++c) {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        group_sync(grp, GT);  // chunk c has landed; chunk c - 1's stage is free
        if (c + 1 < nkc) stage_chunk(c + 1);
        if (live && nh > 0) {
          const int8_t* kst = k_ring + (c % S) * kTile * pitchK;
          const int d0 = c * p.dkc;
          const int ncc = round_up(min(p.dkc, p.D - d0), 16) / 16;
          for (int cc = 0; cc < ncc; ++cc) {
            float kf[16];
            widen16(kst, lane, 16 * cc, pitchK, false, kf);
#pragma unroll
            for (int g = 0; g < GP; ++g) {
              const float4* qv = reinterpret_cast<const float4*>(q_s + (wj * GP + g) * L.DQ + d0 + 16 * cc);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float4 qq = qv[e];
                s[g] = fmaf(qq.x, kf[4 * e], s[g]);
                s[g] = fmaf(qq.y, kf[4 * e + 1], s[g]);
                s[g] = fmaf(qq.z, kf[4 * e + 2], s[g]);
                s[g] = fmaf(qq.w, kf[4 * e + 3], s[g]);
              }
            }
          }
        }
      }
      rows_from(i + S, entry);
      entry = table_at(i + S + 1);
      if (nh == 0) continue;
    } else if (live) {
      const int8_t* kst = k_ring + st * kTile * pitchK;
#pragma unroll 2
      for (int c = 0; c < nc; ++c) {
        float kf[16];
        widen16(kst, lane, ksh + 16 * c, pitchK, tma, kf);
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          const float4* qv = reinterpret_cast<const float4*>(q_w + g * L.DQ + 16 * c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 qq = qv[e];
            s[g] = fmaf(qq.x, kf[4 * e], s[g]);
            s[g] = fmaf(qq.y, kf[4 * e + 1], s[g]);
            s[g] = fmaf(qq.z, kf[4 * e + 2], s[g]);
            s[g] = fmaf(qq.w, kf[4 * e + 3], s[g]);
          }
        }
      }
    }

    // Online softmax over the tile, the warp's heads together; P_w gets
    // p * v_scale (0 for masked tokens and padding slots).
    const float kfold = live ? fold * ksc_s[st * kTile + lane] : 0.f;
    const float vs = live ? vsc_s[st * kTile + lane] : 0.f;
    float x[GP], mx[GP], pe[GP], alpha[GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      x[g] = live && g < nh ? s[g] * kfold : kNeg;
      mx[g] = x[g];
    }
    warp_max_n<GP>(mx);
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      const float m_new = fmaxf(m[g], mx[g]);
      pe[g] = live && g < nh ? exp2f(x[g] - m_new) : 0.f;
      alpha[g] = exp2f(m[g] - m_new);
      m[g] = m_new;
      P_w[lane * GP + g] = pe[g] * vs;
    }
    warp_sum_n<GP>(pe);
#pragma unroll
    for (int g = 0; g < GP; ++g) l[g] = l[g] * alpha[g] + pe[g];
    __syncwarp();

    // PV: acc = acc * alpha + sum over this residue's tokens of p * v.
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      if (!has[k]) continue;
#pragma unroll
      for (int g = 0; g < GP; ++g)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[k][g][j] *= alpha[g];
      const int8_t* vst = v_ring + st * kTile * pitchV;
      const int vo = vsh + 4 * w_of[k];
#pragma unroll 4
      for (int t = rr; t < nend; t += R) {
        float vf[4];
        widen4(*reinterpret_cast<const uint32_t*>(vst + staged(t, vo, pitchV, tma)), vf);
        float pw[GP];
        load_p<GP>(P_w + t * GP, pw);
#pragma unroll
        for (int g = 0; g < GP; ++g)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[k][g][j] = fmaf(pw[g], vf[j], acc[k][g][j]);
      }
    }
  }

  // Each warp's state into its group's slots (on the drained rings): the
  // token residues summed by shuffles, in order.
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  float* Og = reinterpret_cast<float*>(smem + L.kring);      // [ng][Hp][OW]
  float* mg = Og + L.ng * L.Hp * L.OW;                        // [ng][Hp]
  float* lg = mg + L.ng * L.Hp;
  for (int off = R / 2; off > 0; off /= 2)
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[0][g][j] += __shfl_down_sync(0xffffffffu, acc[0][g][j], off * W);
  const int slot0 = grp * L.Hp + wj * GP;
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    if (!has[k] || rr != 0) continue;
#pragma unroll
    for (int g = 0; g < GP; ++g)
      if (g < nh)
#pragma unroll
        for (int j = 0; j < 4; ++j) Og[(slot0 + g) * L.OW + 4 * w_of[k] + j] = acc[k][g][j];
  }
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < GP; ++g)
      if (g < nh) {
        mg[slot0 + g] = m[g];
        lg[slot0 + g] = l[g];
      }
  __syncthreads();

  // The CTA's state: the token groups merged in order by exp2(m_k - max m).
  float* O_s = reinterpret_cast<float*>(smem + L.O);          // [Hp][OW]
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);
  const int E = Gc * ncol;
  const long long out0 = ((long long)b * p.H + (long long)h * G + g0) * p.Dv + dv0;
  auto out_at = [&](int g, int dv) { return out0 + (long long)g * p.Dv + dv; };
  auto slot_of = [&](int g) { return (g / L.hw) * GP + g % L.hw; };
  for (int i = tid; i < E; i += NT) {
    const int g = i / ncol;
    const int dv = i - g * ncol;
    const int sl = slot_of(g);
    float M = kNeg;
    for (int k = 0; k < L.ng; ++k) M = fmaxf(M, mg[k * L.Hp + sl]);
    float o = 0.f, ls = 0.f;
    for (int k = 0; k < L.ng; ++k) {
      const float f = exp2f(mg[k * L.Hp + sl] - M);
      o += f * Og[(k * L.Hp + sl) * L.OW + dv];
      ls += f * lg[k * L.Hp + sl];
    }
    if (p.splits == 1) {
      store_out(p, out_at(g, dv), o / fmaxf(ls, 1e-30f));
    } else {
      O_s[sl * L.OW + dv] = o;
      if (dv == 0) {
        m_s[sl] = M;
        l_s[sl] = ls;
      }
    }
  }
  if (p.splits == 1) return;

  // Merge the cluster's splits: factors exp2(m_r - max m) per head, then
  // this rank's slice of the elements, each summed over the ranks in order.
  float* fac_s = reinterpret_cast<float*>(smem + L.fac);      // [kMaxSplits][Hp]
  float* den_s = reinterpret_cast<float*>(smem + L.den);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int SP = p.splits;
  for (int g = tid; g < Gc; g += NT) {
    const int sl = slot_of(g);
    float mr[kMaxSplits];
    float M = kNeg;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      mr[r] = r < SP ? *cluster.map_shared_rank(m_s + sl, r) : kNeg;
      M = fmaxf(M, mr[r]);
    }
    float ls = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r < SP) {
        const float f = exp2f(mr[r] - M);
        fac_s[r * L.Hp + sl] = f;
        ls += f * *cluster.map_shared_rank(l_s + sl, r);
      }
    }
    den_s[sl] = fmaxf(ls, 1e-30f);
  }
  __syncthreads();
  const int per_e = (E + SP - 1) / SP;
  const int e_end = min(E, (split + 1) * per_e);
  for (int i = split * per_e + tid; i < e_end; i += NT) {
    const int g = i / ncol;
    const int dv = i - g * ncol;
    const int sl = slot_of(g);
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < SP) a += fac_s[r * L.Hp + sl] * *cluster.map_shared_rank(O_s + sl * L.OW + dv, r);
    store_out(p, out_at(g, dv), a / den_s[sl]);
  }
  cluster.sync();  // every rank's shared memory stays until all have read it
}

template <int GP, bool WIDE_D>
cudaError_t allow_smem() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_fa_kernel<GP, WIDE_D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  return attr;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
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

// The pool as (slabs, slab_bytes) int8, read in boxes of kTile slabs by
// `box` bytes (64 or 128: the swizzle of that span).
bool encode_pool(CUtensorMap* map, const void* pool, long long slabs, int slab_bytes, int box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(slab_bytes), static_cast<cuuint64_t>(slabs)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(slab_bytes)};
  const cuuint32_t boxes[2] = {static_cast<cuuint32_t>(box), static_cast<cuuint32_t>(kTile)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(pool), dims, strides,
                boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                box == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// `cells`: the (sequence, head chunk, column chunk) CTAs a (split, KV head).
template <int GP, bool WIDE_D>
cudaError_t launch(const Params& p, const Layout& L, const Maps& maps, int cells,
                   cudaStream_t stream) {
  auto kernel = paged_fa_kernel<GP, WIDE_D>;
  const cudaError_t attr = allow_smem<GP, WIDE_D>();
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, p.Hkv, cells);
  cfg.blockDim = dim3(32 * L.NW, 1, 1);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = p.splits;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = p.splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p, maps);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Plain C entry point: returns cudaGetLastError() after the launch (0 on
// success); the wrapper raises on anything else.  Launches on `stream`,
// does not synchronise and allocates nothing.  `shift`, `tma`, `group`,
// `ng`, `dvc`, `dkc` and `splits` are the wrapper's plan
// (kernels/flash_attn.py: paged_plan, paged_splits); a plan the CTA cannot
// hold (more than kMaxGroup query heads or kMaxWarps warps, a Dv chunk
// above 256 or not whole 16-byte units, a K chunk (dkc < D) not whole
// 16-byte units or with shifted rows or TMA, shared memory past kSmemMax)
// is refused (cudaErrorInvalidValue).
extern "C" int paged_flash_attn_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* tables, const void* lens, void* out,
    int B, int H, int Hkv, int D, int Dv, int page, int NP, int window,
    float scale, int is_bf16, int vec, int shift, int tma, int P, int group, int ng, int dvc,
    int dkc, int splits, void* stream) {
  if (B <= 0) return 0;
  // A shifted row's window stays inside its token's slab of Hkv rows (a
  // multiple of 16 bytes), so no copy reaches past the pool.
  const bool window_ok = vec == 16 && D % 16 == 8 && Dv % 16 == 8 && (Hkv * D) % 16 == 0 &&
                         (Hkv * Dv) % 16 == 0;
  const int rowK = shift ? round_up(D + 8, 16) : D, rowV = shift ? round_up(Dv + 8, 16) : Dv;
  const bool tma_ok = vec == 16 && page % kTile == 0 && (rowK == 64 || rowK == 128) &&
                      (rowV == 64 || rowV == 128) && P > 0 && dvc >= Dv;
  if (Hkv <= 0 || Hkv > 65535 || H % Hkv != 0 || D <= 0 || Dv <= 0 || page <= 0 || NP < 0 ||
      (vec != 16 && vec != 8 && vec != 4 && vec != 1) || (!shift && (D % vec || Dv % vec)) ||
      (shift && !window_ok) || (tma && !tma_ok) || group < 1 || group > H / Hkv ||
      group > kMaxGroup || ng < 1 || dvc < 1 || (dvc < Dv && dvc % 16) || splits < 1 ||
      splits > kMaxSplits || dkc < 1 || dkc > D || (dkc < D && (dkc % 16 || shift || tma)))
    return (int)cudaErrorInvalidValue;
  const bool wide = dkc < D;
  const int G = H / Hkv;
  const int chunks = (G + group - 1) / group;
  const int vchunks = (Dv + dvc - 1) / dvc;
  const Layout L = make_layout(group, ng, D, dvc < Dv ? dvc : Dv, shift, wide ? dkc : 0);
  if ((long long)B * chunks * vchunks > 65535 || L.total > kSmemMax || L.W > 32 * kUnits ||
      L.NW > kMaxWarps)
    return (int)cudaErrorInvalidValue;
  const int cells = B * chunks * vchunks;
  Params p;
  p.q = q;
  p.k = static_cast<const int8_t*>(k);
  p.v = static_cast<const int8_t*>(v);
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.tables = static_cast<const int*>(tables);
  p.lens = static_cast<const int*>(lens);
  p.out = out;
  p.ng = ng;
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
  p.shift = shift;
  if (wide)
    p.dkc = dkc;
  else
    p.tma = tma;
  p.group = group;
  p.dvc = dvc < Dv ? dvc : Dv;
  p.splits = splits;
  Maps maps = {};
  if (tma && !(encode_pool(&maps.k, k, (long long)P * page, Hkv * D, rowK) &&
               encode_pool(&maps.v, v, (long long)P * page, Hkv * Dv, rowV)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (L.GP) {
    case 1: err = wide ? launch<1, true>(p, L, maps, cells, s) : launch<1, false>(p, L, maps, cells, s); break;
    case 2: err = wide ? launch<2, true>(p, L, maps, cells, s) : launch<2, false>(p, L, maps, cells, s); break;
    case 4: err = wide ? launch<4, true>(p, L, maps, cells, s) : launch<4, false>(p, L, maps, cells, s); break;
    default: err = wide ? launch<8, true>(p, L, maps, cells, s) : launch<8, false>(p, L, maps, cells, s); break;
  }
  return (int)err;
}
