// The device body of the two paged decode kernels, for Hopper, in f32 and
// bf16: paged_decode_attention.cu (one query token a slot over its
// self-attention pages, length and window masks) and
// paged_cross_decode_attention.cu (the same read over the slot's
// read-only cross pages, masked only by enc_len).  They replace the TPU
// kernels src/repro/kernels/paged_decode_attention.py
// (paged_decode_attention -> pl.pallas_call) and
// src/repro/kernels/paged_cross_decode_attention.py
// (paged_cross_decode_attention -> pl.pallas_call).
//
// What bounds it on an H100: per (KV head, key) a slot reads 2 * hd
// values of K/V once and does 4 * hd * rep FLOPs on them (rep <= 8), so
// at every served shape it is bound by the bytes of the live pages
// (3.35 TB/s): Llama-3.2-Vision's cross decode moves 52.4 MB a launch
// (16 us).  Keeping that rate takes about 25 KB of loads in flight an
// SM all the time, and arithmetic cheap enough to keep up.  The design:
//
//   grid       one block per (slot, KV head g, split).  The host picks
//              `splits` from the grid alone (slots x KV heads x splits
//              of at least 2 blocks an SM, and as many as fit the card
//              at once, at most the table's width; decode_plan.py) and
//              never reads the lengths; each block cuts ITS slot's
//              live pages [p_lo, p_hi) (from len and the window) into
//              `splits` shares of whole pages, share s the pages
//              [p_lo + s * n / splits, p_lo + (s + 1) * n / splits).
//              Keys outside [max(p_lo * page, len - window), len) are
//              never read: their table slots may point at freed or
//              scratch pages.  A block with an empty share returns at
//              once (split 0 of a slot without keys writes its zeros);
//              the live shares are numbered densely for the combine.
//   warps      the block's 4 warps take the share's key tiles in turn
//              (warp w tiles w, w + 4, ...), each with its own ring of
//              STAGES tiles in shared memory and its own online softmax
//              (m, l, acc) for the rep query rows of KV head g.  No
//              block-wide barrier inside the walk.
//   K/V ring   a tile is STAGE_BYTES of K rows then V rows, kept in
//              their storage type T (no f32 staging), filled by 16-byte
//              cp.async.cg copies, each key's row found through the
//              block table (its page ids read one tile ahead); keys past
//              the share are zero-filled (not read); the pieces of a row
//              XOR-swizzled against bank conflicts.  Commit/wait groups
//              and a warp barrier hand the stages over: STAGES - 1 tiles
//              (12 KB a warp, about 140 KB an SM) stay in flight while
//              one is computed.
//   compute    bf16 at hd <= 128 on the tensor cores (MmaWarp): the rep
//              query rows are the M rows of mma.sync m16n8k16, the
//              tile's keys its N columns, the softmax on the score
//              fragments, P straight from them into O += P V (m16n8k8).
//              On the CUDA cores the arithmetic alone (shuffle sums, a
//              softmax in every lane of a key) took as long as the
//              loads alone.  f32 (tensor cores would take it as TF32)
//              and bf16 at hd 256 run on the CUDA cores (CoreWarp),
//              scores as FMAs on each lane's 16-byte pieces and shuffle
//              sums.
//   merge      at the end the key groups (CUDA cores) merge by shuffles,
//              the warps through shared memory (one barrier), and the
//              block writes its rows, or, with more than one live share,
//              its partial state (m, l, unnormalised sums) to a
//              workspace; the last block of a (slot, KV head) to finish,
//              found by an acquire-release atomic counter it then resets
//              to 0, merges the live shares in registers and writes the
//              output.  One launch either way.
//
// Numerics follow the TPU kernels: f32 sums in both dtypes, finite
// NEG_INF, division by max(l, 1e-20), and exact zeros for a row with no
// key it may attend (len = 0: an empty decode slot, every iteration).
// Scores are kept in log2 units (scaled by scale * log2 e): exp2f for
// f32, one ex2.approx for bf16, whose P is rounded to bf16 before PV (at
// most 2^-9 of each weight), as in the prefill tensor-core body.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "paged_attention.cuh"

namespace decode_attn {
// internal linkage: both decode libraries hold these templates, and the
// static flag in launch_one must stay one per library (a function-local
// static of a template with external linkage is one per process)
namespace {

using bf16 = __nv_bfloat16;
using paged_attn::NEG_INF;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 4;              // ring depth a warp
constexpr int STAGE_BYTES = 4096;      // a tile: K rows then V rows
constexpr int SMEM = WARPS * STAGES * STAGE_BYTES;
constexpr int MAX_REP = 8;
constexpr float LOG2E = 1.4426950408889634f;

// How a K or V row of HD values of T spreads over a warp's lanes, and
// where its 16-byte pieces lie in a ring stage.
template <typename T, int HD>
struct Geometry {
  static constexpr int VEC = 16 / sizeof(T);     // values a piece
  static constexpr int NC = HD / VEC;            // pieces a row
  static constexpr int LK = NC < 32 ? NC : 32;   // lanes a key
  static constexpr int CPL = NC / LK;            // pieces a lane (1 or 2)
  static constexpr int KW = 32 / LK;             // keys a warp copies at once
  static constexpr int E = CPL * VEC;            // values a lane holds
  static constexpr int ROUNDS = 4 / CPL;         // KW-key rounds a tile
  static constexpr int TILE = ROUNDS * KW;       // keys a tile
  static constexpr int ROW = HD * (int)sizeof(T);
  static_assert(TILE * 2 * ROW == STAGE_BYTES, "a tile fills its stage");
  // byte offset of piece c of tile key t (K rows; V rows follow at
  // TILE * ROW): the pieces XOR-permuted within each row so that one
  // piece of 8 consecutive keys lies in 8 distinct bank groups
  __device__ __forceinline__ static int at(int t, int c) {
    const int sw = ROW >= 128 ? (t & 7) : ((t >> 1) & 3);
    return t * ROW + ((c ^ sw) << 4);
  }
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ float exp2_t(float x) {
  if constexpr (std::is_same<T, float>::value) return exp2f(x);
  return paged_attn::fast_exp2(x);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}
// d (m16n8, f32) += a (m16k16 bf16: a0 rows 0-7 k 0-7, a2 rows 0-7 k
// 8-15; rows 8-15 zero) * b (k16n8 bf16)
__device__ __forceinline__ void mma_k16(float (&d)[4], uint32_t a0,
                                        uint32_t a2, uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %5}, {%7, %8}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(b0), "r"(b1));
}
// d (m16n8, f32) += a (m16k8 bf16: rows 0-7; rows 8-15 zero) * b (k8n8)
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0,
                                       uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(b0));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A warp's walk on the CUDA cores (f32, and bf16 at hd 256): a key's row
// spreads over LK lanes, one or two 16-byte pieces a lane, so the warp
// reads KW keys at once, each lane exactly the pieces it copied.  Each
// lane holds its pieces of every Q row (prescaled to log2 units) and of
// every accumulator row; scores are FMAs on the pieces and a shuffle sum
// over the LK lanes.  Each key group keeps its own (m, l) and rescales
// once a tile; the groups merge at the end.
template <typename T, int HD, int REP>
struct CoreWarp {
  using G = Geometry<T, HD>;
  static constexpr int E = G::E, R = G::ROUNDS;
  float qr[REP][E], acc[REP][E], m[REP], l[REP];
  int kg, c;

  // q_rows: the block's REP query rows, HD apart
  __device__ __forceinline__ void init(const T* q_rows, int lane,
                                       float sl2) {
    kg = lane / G::LK;
    c = lane % G::LK;
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      m[r] = NEG_INF;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
#pragma unroll
      for (int u = 0; u < G::CPL; ++u)
        paged_attn::unpack(*reinterpret_cast<const uint4*>(
                               q_rows + r * HD + (c + u * G::LK) * G::VEC),
                           qr[r] + u * G::VEC, q_rows);
#pragma unroll
      for (int e = 0; e < E; ++e) qr[r][e] *= sl2;
    }
  }

  // this lane's pieces of tile key t (K or V rows at st) -> E floats
  __device__ __forceinline__ void row(const unsigned char* st, int t,
                                      float* f) const {
#pragma unroll
    for (int u = 0; u < G::CPL; ++u)
      paged_attn::unpack(*reinterpret_cast<const uint4*>(
                             st + G::at(t, c + u * G::LK)),
                         f + u * G::VEC, static_cast<const T*>(nullptr));
  }

  // one tile at st (generic pointer; st_s its shared address, unused
  // here); its keys from n_valid on are past the share
  __device__ __forceinline__ void tile(const unsigned char* st, uint32_t,
                                       int n_valid, float, int) {
    float s[REP][R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float kf[E];
      row(st, j * G::KW + kg, kf);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qr[r][e], kf[e], d);
        s[r][j] = d;
      }
    }
#pragma unroll
    for (int o = G::LK / 2; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < REP; ++r)
#pragma unroll
        for (int j = 0; j < R; ++j)
          s[r][j] += __shfl_xor_sync(0xffffffffu, s[r][j], o);
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < R; ++j)
        if (j * G::KW + kg < n_valid) mx = fmaxf(mx, s[r][j]);
      const float corr = exp2_t<T>(m[r] - mx);
      m[r] = mx;
      l[r] *= corr;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= corr;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p =
            j * G::KW + kg < n_valid ? exp2_t<T>(s[r][j] - mx) : 0.f;
        s[r][j] = p;
        l[r] += p;
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float vf[E];
      row(st + G::TILE * G::ROW, j * G::KW + kg, vf);
#pragma unroll
      for (int r = 0; r < REP; ++r)
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[r][e] = fmaf(s[r][j], vf[e], acc[r][e]);
    }
  }

  // merge the key groups (lanes LK apart hold the same pieces), then the
  // warp's record: m[REP], l[REP], REP rows of HD sums
  __device__ __forceinline__ void record(float* rec, int lane) {
#pragma unroll
    for (int o = G::LK; o < 32; o <<= 1)
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
        const float mn = fmaxf(m[r], mo);
        const float a = exp2_t<T>(m[r] - mn), b = exp2_t<T>(mo - mn);
        m[r] = mn;
        l[r] = l[r] * a + lo * b;
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[r][e] = acc[r][e] * a +
                      __shfl_xor_sync(0xffffffffu, acc[r][e], o) * b;
      }
    if (kg != 0) return;
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (lane == 0) {
        rec[r] = m[r];
        rec[REP + r] = l[r];
      }
#pragma unroll
      for (int u = 0; u < G::CPL; ++u)
#pragma unroll
        for (int e = 0; e < G::VEC; ++e)
          rec[2 * REP + r * HD + (c + u * G::LK) * G::VEC + e] =
              acc[r][u * G::VEC + e];
    }
  }
};

// A warp's walk on the tensor cores (bf16, hd <= 128): the REP query
// rows are the M rows of mma.sync m16n8k16 (rows REP-15 zero), a tile's
// keys its N columns 8 at a time (K rows read by ldmatrix as they lie),
// S = Q K^T in f32; the softmax runs on the score fragments (lane: row
// lane / 4, keys 2 (lane % 4) + {0, 1}); P, rounded to bf16, is straight
// the A operand of O += P V (m16n8k8, V read by ldmatrix.trans).  One
// (m, l) a row for the warp; l is summed over each quad at the end.
template <int HD, int REP>
struct MmaWarp {
  using G = Geometry<bf16, HD>;
  static constexpr int NT = HD / 8;          // n8 tiles of an output row
  static constexpr int CH = G::TILE / 8;     // 8-key chunks a tile
  static_assert(G::TILE % 8 == 0 && HD % 32 == 0, "mma tiles");
  uint32_t qa[HD / 16][2];                   // Q: a0, a2 of each k16 step
  float o[NT][4];
  float m, l;
  int gid, tq;

  __device__ __forceinline__ void init(const bf16* q_rows, int lane,
                                       float) {
    gid = lane >> 2;
    tq = lane & 3;
    m = NEG_INF;
    l = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    const uint32_t* src =
        reinterpret_cast<const uint32_t*>(q_rows + gid * HD);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qa[kk][0] = gid < REP ? __ldg(src + 8 * kk + tq) : 0u;
      qa[kk][1] = gid < REP ? __ldg(src + 8 * kk + 4 + tq) : 0u;
    }
  }

  __device__ __forceinline__ void tile(const unsigned char*, uint32_t st,
                                       int n_valid, float sl2, int lane) {
    const int t8 = lane & 7, pc = lane >> 3;   // ldmatrix row, matrix
    float s[CH][4];
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ch][e] = 0.f;
#pragma unroll
      for (int kp = 0; kp < HD / 32; ++kp) {
        uint32_t b[4];
        ldsm_x4(b, st + G::at(8 * ch + t8, 4 * kp + pc));
        mma_k16(s[ch], qa[2 * kp][0], qa[2 * kp][1], b[0], b[1]);
        mma_k16(s[ch], qa[2 * kp + 1][0], qa[2 * kp + 1][1], b[2], b[3]);
      }
    }
    float mx = m;
#pragma unroll
    for (int ch = 0; ch < CH; ++ch)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[ch][e] *= sl2;
        if (8 * ch + 2 * tq + e < n_valid) mx = fmaxf(mx, s[ch][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float corr = paged_attn::fast_exp2(m - mx);
    m = mx;
    l *= corr;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      o[j][0] *= corr;
      o[j][1] *= corr;
    }
    const uint32_t vs = st + G::TILE * G::ROW;
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      float p[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[e] = 8 * ch + 2 * tq + e < n_valid
                   ? paged_attn::fast_exp2(s[ch][e] - mx)
                   : 0.f;
        l += p[e];
      }
      const uint32_t a = pack_bf16(p[0], p[1]);
#pragma unroll
      for (int np = 0; np < HD / 32; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, vs + G::at(8 * ch + t8, 4 * np + pc));
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) mma_k8(o[4 * np + q4], a, b[q4]);
      }
    }
  }

  __device__ __forceinline__ void record(float* rec, int) {
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (gid >= REP) return;
    if (tq == 0) {
      rec[gid] = m;
      rec[REP + gid] = l;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<float2*>(rec + 2 * REP + gid * HD + 8 * j + 2 * tq) =
          make_float2(o[j][0], o[j][1]);
  }
};

// The share of the live pages that split `split` of `splits` walks, as
// keys [*k_begin, *k_end) (empty when k_end <= k_begin); *active of the
// splits have a share that is not empty (min(splits, live pages)), and
// this one, if it has, is the *rank-th of them.  Mirrored by
// decode_plan.share_keys.
__device__ __forceinline__ void share_keys(int len, int window, int page,
                                           int n_slots, int split,
                                           int splits, int* k_begin,
                                           int* k_end, int* rank,
                                           int* active) {
  const int k_lo = window > 0 && len > window ? len - window : 0;
  const int p_lo = k_lo / page;
  const int p_hi = min(n_slots, (len + page - 1) / page);
  const int n = max(0, p_hi - p_lo);
  const int s_lo = p_lo + (int)((long long)split * n / splits);
  const int s_hi = p_lo + (int)((long long)(split + 1) * n / splits);
  *k_begin = max(k_lo, s_lo * page);
  *k_end = min(len, s_hi * page);
  *active = min(splits, n);
  *rank = n < splits ? s_lo - p_lo : split;   // one page a share then
}

// One block of (slot, KV head g, split) = blockIdx (x, y, z).  q (b, h,
// HD), pools (n_pages, page, kvh, HD), out (b, h, HD), all T; bt (b,
// n_slots) and lens (b,) int32.  With gridDim.z > 1, part holds b * kvh *
// splits records of REP * (HD + 2) floats (m[REP], l[REP], REP * HD
// sums) and counters b * kvh zeros, left at zero.
template <typename T, int HD, int REP>
__global__ void __launch_bounds__(THREADS)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                  const T* __restrict__ v_pool, const int* __restrict__ bt,
                  const int* __restrict__ lens, T* __restrict__ out,
                  float* __restrict__ part, int* __restrict__ counters,
                  int kvh, int page, int n_slots, int window, float scale) {
  using G = Geometry<T, HD>;
  using Warp = std::conditional_t<std::is_same<T, bf16>::value && HD <= 128,
                                  MmaWarp<HD, REP>, CoreWarp<T, HD, REP>>;
  constexpr int R = G::ROUNDS;
  constexpr int REC = REP * (HD + 2);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const int slot = blockIdx.x, g = blockIdx.y, split = blockIdx.z;
  const int splits = gridDim.z;
  const int h = kvh * REP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kg = lane / G::LK, c = lane % G::LK;   // the copy mapping

  const float sl2 = scale * LOG2E;
  Warp w;   // Q's loads overlap the length's
  w.init(q + ((long long)slot * h + g * REP) * HD, lane, sl2);
  int k_begin, k_end, rank, active;
  share_keys(lens[slot], window, page, n_slots, split, splits, &k_begin,
             &k_end, &rank, &active);
  T* out_row = out + ((long long)slot * h + g * REP) * HD;
  if (k_end <= k_begin) {
    // no work: an empty share is not counted, and split 0 of a slot with
    // no key writes its zeros
    if (active == 0 && split == 0)
      for (int i = threadIdx.x; i < REP * HD; i += THREADS)
        paged_attn::store_f(out_row, i, 0.f);
    return;
  }
  const int n_tiles = (k_end - k_begin + G::TILE - 1) / G::TILE;
  const int mine = n_tiles > warp ? (n_tiles - warp + WARPS - 1) / WARPS : 0;
  const int* __restrict__ row_bt = bt + (long long)slot * n_slots;
  const int shift = (page & (page - 1)) == 0 ? __ffs(page) - 1 : -1;
  unsigned char* ring = smem + warp * STAGES * STAGE_BYTES;
  const uint32_t ring_s = paged_attn::smem_u32(ring);
  auto tile_k0 = [&](int i) {
    return k_begin + (warp + i * WARPS) * G::TILE;
  };
  auto page_of = [&](int k) { return shift >= 0 ? k >> shift : k / page; };

  // The page ids of the keys this lane copies for this warp's i-th tile
  // (share tile warp + i * WARPS), read one tile ahead of its copies so
  // the table read never stands in the copies' way.
  auto lookup = [&](int i, int (&ids)[R]) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int k = tile_k0(i) + j * G::KW + kg;
      ids[j] = i < mine && k < k_end ? __ldg(row_bt + page_of(k)) : 0;
    }
  };
  // the i-th tile into stage i % STAGES: lane (kg, c) copies pieces c +
  // u * LK of keys j * KW + kg; keys past the share are zero-filled, not
  // read; a group is committed even when empty
  auto issue = [&](int i, const int (&ids)[R]) {
    if (i < mine) {
      const uint32_t st = ring_s + (i % STAGES) * STAGE_BYTES;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int t = j * G::KW + kg;
        const int k = tile_k0(i) + t;
        const bool ok = k < k_end;
        const long long row =
            ((long long)ids[j] * page + (k - page_of(k) * page)) * kvh + g;
#pragma unroll
        for (int u = 0; u < G::CPL; ++u) {
          const int col = c + u * G::LK;
          const long long off = ok ? row * HD + col * G::VEC : 0;
          paged_attn::cp_async16(st + G::at(t, col), k_pool + off, ok);
          paged_attn::cp_async16(st + G::TILE * G::ROW + G::at(t, col),
                                 v_pool + off, ok);
        }
      }
    }
    cp_async_commit();
  };
  int ids[STAGES][R];   // the first tiles' ids all read at once
#pragma unroll
  for (int i = 0; i < STAGES; ++i) lookup(i, ids[i]);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i, ids[i]);

  for (int i = 0; i < mine; ++i) {
    __syncwarp();
    issue(i + STAGES - 1, ids[STAGES - 1]);
    lookup(i + STAGES, ids[STAGES - 1]);
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    const int off = (i % STAGES) * STAGE_BYTES;
    w.tile(ring + off, ring_s + off, k_end - tile_k0(i), sl2, lane);
  }
  cp_async_wait<0>();
  __syncwarp();

  // each warp's record (m, l, sums) over its own ring, then across warps
  w.record(reinterpret_cast<float*>(ring), lane);
  __syncthreads();
  const float* recs = reinterpret_cast<const float*>(smem);
  constexpr int WSTRIDE = STAGES * STAGE_BYTES / 4;   // floats a warp
  float* my_part = active == 1 ? nullptr
                                : part + ((long long)(slot * kvh + g) *
                                              splits + rank) * REC;
  for (int i = threadIdx.x; i < REP * HD; i += THREADS) {
    const int r = i / HD;
    float mm = NEG_INF;
#pragma unroll
    for (int wp = 0; wp < WARPS; ++wp)
      mm = fmaxf(mm, recs[wp * WSTRIDE + r]);
    float sl = 0.f, sa = 0.f;
#pragma unroll
    for (int wp = 0; wp < WARPS; ++wp) {
      const float* rw = recs + wp * WSTRIDE;
      const float wt = exp2_t<T>(rw[r] - mm);
      sl = fmaf(rw[REP + r], wt, sl);
      sa = fmaf(rw[2 * REP + i], wt, sa);
    }
    if (active == 1) {
      paged_attn::store_f(out_row, i,
                          mm == NEG_INF ? 0.f : sa / fmaxf(sl, 1e-20f));
      continue;
    }
    if (i % HD == 0) {
      my_part[r] = mm;
      my_part[REP + r] = sl;
    }
    my_part[2 * REP + i] = sa;
  }
  if (active == 1) return;

  // the last live split of (slot, g) to finish combines them all: the
  // block's writes released and the others' acquired through the counter
  // by thread 0, ordered for the block by its barriers
  __syncthreads();
  if (threadIdx.x == 0) {
    int* ctr = counters + slot * kvh + g;
    int done;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(done)
                 : "l"(ctr)
                 : "memory");
    last = done == active - 1;
    if (last) *ctr = 0;
  }
  __syncthreads();
  if (!last) return;
  // each thread merges its outputs' rows over the live splits in
  // registers, U splits a round trip: their m, l and sums all loaded at
  // once, then rescaled online as within a block
  const float* base = part + (long long)(slot * kvh + g) * splits * REC;
  constexpr int PER = (REP * HD + THREADS - 1) / THREADS;   // outputs
  constexpr int U = PER >= 16 ? 2 : PER >= 8 ? 4 : 32 / PER; // splits
  float mo[PER], lo[PER], ao[PER];
#pragma unroll
  for (int ii = 0; ii < PER; ++ii) {
    mo[ii] = NEG_INF;
    lo[ii] = ao[ii] = 0.f;
  }
  for (int s0 = 0; s0 < active; s0 += U) {
    float vm[U][PER], vl[U][PER], va[U][PER];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int ii = 0; ii < PER; ++ii) {
        const int i = threadIdx.x + ii * THREADS;
        const bool ok = s0 + u < active && i < REP * HD;
        const float* rec = base + (s0 + u) * REC;
        vm[u][ii] = ok ? __ldcg(rec + i / HD) : NEG_INF;
        vl[u][ii] = ok ? __ldcg(rec + REP + i / HD) : 0.f;
        va[u][ii] = ok ? __ldcg(rec + 2 * REP + i) : 0.f;
      }
#pragma unroll
    for (int ii = 0; ii < PER; ++ii) {
      float mx = mo[ii];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, vm[u][ii]);
      const float c = exp2_t<T>(mo[ii] - mx);
      lo[ii] *= c;
      ao[ii] *= c;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float wt = exp2_t<T>(vm[u][ii] - mx);
        lo[ii] = fmaf(vl[u][ii], wt, lo[ii]);
        ao[ii] = fmaf(va[u][ii], wt, ao[ii]);
      }
      mo[ii] = mx;
    }
  }
#pragma unroll
  for (int ii = 0; ii < PER; ++ii) {
    const int i = threadIdx.x + ii * THREADS;
    if (i < REP * HD)
      paged_attn::store_f(out_row, i, ao[ii] / fmaxf(lo[ii], 1e-20f));
  }
}

template <typename T, int HD, int REP>
int launch_one(const long long* a, float scale, cudaStream_t stream) {
  static unsigned smem_set = 0;
  cudaError_t err =
      paged_attn::allow_max_smem(decode_kernel<T, HD, REP>, &smem_set);
  if (err != cudaSuccess) return (int)err;
  const int b = (int)a[8], kvh = (int)a[10], page = (int)a[12],
            n_slots = (int)a[13], splits = (int)a[14], window = (int)a[15];
  decode_kernel<T, HD, REP><<<dim3(b, kvh, splits), THREADS, SMEM, stream>>>(
      reinterpret_cast<const T*>(a[0]), reinterpret_cast<const T*>(a[1]),
      reinterpret_cast<const T*>(a[2]), reinterpret_cast<const int*>(a[3]),
      reinterpret_cast<const int*>(a[4]), reinterpret_cast<T*>(a[5]),
      reinterpret_cast<float*>(a[6]), reinterpret_cast<int*>(a[7]), kvh,
      page, n_slots, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD, int REP = 1>
int with_rep(int rep, const long long* a, float scale, cudaStream_t s) {
  if (rep == REP) return launch_one<T, HD, REP>(a, scale, s);
  if constexpr (REP < MAX_REP)
    return with_rep<T, HD, REP + 1>(rep, a, scale, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int with_width(int hd, int rep, const long long* a, float scale,
               cudaStream_t s) {
  switch (hd) {
    case 32: return with_rep<T, 32>(rep, a, scale, s);
    case 64: return with_rep<T, 64>(rep, a, scale, s);
    case 128: return with_rep<T, 128>(rep, a, scale, s);
    case 256: return with_rep<T, 256>(rep, a, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// One launch, its arguments packed as 64-bit integers, in order: q,
// k_pool, v_pool, block_table, lens, out, part, counters, b, h, kvh, hd,
// page, n_slots, splits, window, dtype (0 = float32, 1 = bfloat16; q,
// pools and out share it).  hd (= hd_v) is 32, 64, 128 or 256 and h / kvh
// 1 to 8 (decode_plan.py refuses the rest).  part and counters are used
// only with splits > 1 (see decode_kernel).  Returns the cudaError_t of
// the launch (0 on success).
inline int launch(const long long* a, float scale, void* stream) {
  const int h = (int)a[9], kvh = (int)a[10], hd = (int)a[11];
  const int dtype = (int)a[16];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kvh < 1 || h % kvh) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return with_width<float>(hd, h / kvh, a, scale, s);
  if (dtype == 1) return with_width<__nv_bfloat16>(hd, h / kvh, a, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace decode_attn
