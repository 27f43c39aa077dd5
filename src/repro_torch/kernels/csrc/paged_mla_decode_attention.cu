// Paged MLA decode attention (DeepSeek-V2, absorbed form) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/paged_mla_decode_attention.py
// (paged_mla_decode_attention -> pl.pallas_call).  Each slot's one query
// token attends the slot's live LATENT pages through its block-table row:
//
//   s[h][t] = (q_lat[h] . ckv[t] + q_rope[h] . kr[t]) * scale
//   o_lat[h] = softmax_t(s[h]) . ckv          (PV in the latent space)
//
// masked by tok < lens and, with a window, tok > lens - 1 - window.  The
// caller absorbed W_uk into q_lat (in f32) and up-projects o_lat through
// W_uv.  The TPU kernel walked a slot's pages in one sequential grid
// dimension with all heads in VMEM.
//
// What bounds it on an H100: all heads share one latent "KV head" of key
// width lora + rope (576 at full width) whose values ARE the key's first
// lora columns, so a token's 1,152 bf16 bytes serve 2 * h * (2 * lora +
// rope) FLOPs, 278 k at 128 heads: 242 FLOP/B, near the card's ridge of
// 295.  The CUDA cores (67 TFLOP/s) cannot come near that bound; the
// tensor cores can.  But the model's queries are f32 (absorbed through
// W_uk in f32) and the output is held to 2e-5 of the f32 plain version,
// which a bf16 query misses 280-fold; so each f32 query value runs as
// three bf16 terms q1 + q2 + q3 (each the bf16 rounding of what the
// others leave: three MMAs on one K fragment) and each softmax weight as
// two, 2.5 times the nominal MMA work.  A bf16 pool is exact in bf16.
// The design:
//
//   grid     one block per (slot, 16 heads, split), 2 blocks an SM.  The
//            host picks `splits` from the grid alone (mla_plan.py) and
//            never reads the lengths; each block cuts its own slot's live
//            pages into whole-page shares (paged_attn::share_keys, the
//            decode body's cut) and an empty share returns at once.
//   Q        the block's query rows are copied by cp.async, beside the
//            first tile, into shared memory, and from there into each
//            warp's fragments.
//   tiles    the share's keys 32 at a time: each key's [ckv | kr] row, in
//            the pool's type, found through the block table and copied by
//            cp.async into a ring of 2 tiles (keys past the share
//            zero-filled, not read); one tile serves QK^T (all lora + rope
//            columns) and PV (its first lora) from the same bytes.
//   QK^T     bf16 pools (Mma): the 16 heads are the M rows of mma.sync,
//            the keys its N columns.  The 8 warps split the k dimension
//            evenly (576 = 8 x 72 columns: four m16n8k16 steps and one
//            m16n8k8) and keep their query terms' fragments in registers
//            for the whole walk; their partial scores meet in shared
//            memory.
//   softmax  each warp 2 heads (4 on the CUDA cores), each lane a key of
//            the tile: the partial scores summed, the online max by
//            shuffles, P and each row's rescale in f32 (log2 units), l
//            summed per lane from the f32 P and across the lanes at the
//            end.
//   PV       each warp owns lora / 8 columns of the 16 heads; P, split
//            into two bf16 terms (one for bf16 queries), is the A operand
//            (ldmatrix from shared memory) and V the tile's ckv columns
//            (ldmatrix.trans); the sums stay in registers.
//   merge    the sums go through shared memory and out in whole rows:
//            with one live share as o = acc / l; with more, each block
//            writes its partial state (m, l, acc) to a workspace and the
//            last block of a (slot, head block), found by an
//            acquire-release counter it resets to 0, merges them.  One
//            launch.
//   f32      f32 pools run the same grid, ring, softmax and merge on the
//            CUDA cores (Core): 4 warps, Q read from shared memory, 4
//            heads x 1 key a lane for the scores, 16 heads x 4 columns a
//            thread for PV.
//
// Registers set the shape: the query fragments (54 a thread) and the PV
// sums (32) stay live across the walk, and 2 blocks an SM allow 128 a
// thread.  Measured on the card: the phases run one after another inside
// a block, each latency-bound (a 10-tile walk of one block an SM spends
// per tile about 1,400 cycles on the scores, 900 on the softmax, 900 on
// PV and 800 issuing copies), so a second block an SM fills in; 16 warps
// on 32 heads (one block an SM) or 4 warps holding all 9 query steps ran
// slower, and per-key TMA bulk copies slower still (one warp issues them
// one at a time).
//
// Numerics follow the TPU kernel: f32 scores, softmax and sums, NEG_INF =
// -1e30, division by max(l, 1e-20), and exact zeros for a slot with lens
// = 0 (an empty decode slot).  Pages past lens and pages slid out of the
// window are never read: their table slots may point at freed or scratch
// pages.
#include "paged_attention.cuh"

namespace {

using bf16 = __nv_bfloat16;
using paged_attn::ldsm_x4;
using paged_attn::ldsm_x4_t;
using paged_attn::NEG_INF;

constexpr int TK = 32;          // keys a tile: the softmax's lanes
constexpr int SST = TK + 8;     // score row stride, floats
constexpr int PST = TK + 8;     // P row stride, bf16 (80 B: ldmatrix
                                // reads 8 rows on distinct banks)
constexpr int MAX_SPLITS = 64;  // mla_plan.MAX_SPLITS
constexpr float LOG2E = 1.4426950408889634f;

// The block's shape and shared memory (mirrored by mla_plan.py): STAGES
// key tiles of TK rows of RS bytes, the KQ partial scores, P, then corr,
// m and l of each head.  The query rows (QS bytes apart) lie over the
// last stage, the scores and P on the tensor cores (read once, before
// those are written), after the rest on the CUDA cores (read every
// tile).
template <typename TQ, typename TP, int LORA, int ROPE>
struct Cfg {
  static constexpr bool TC = std::is_same<TP, bf16>::value;
  static constexpr bool F32Q = std::is_same<TQ, float>::value;
  static constexpr int QT = TC && F32Q ? 3 : 1;  // bf16 terms a query value
  static constexpr int PT = TC && F32Q ? 2 : 1;  // bf16 terms a weight
  static constexpr int HB = 16;                  // heads a block: one M tile
  static constexpr int KQ = TC ? 8 : 1;          // partial scores a head
  static constexpr int WARPS = TC ? KQ : 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int RPW = HB / WARPS;         // heads a warp's softmax
  static constexpr int W = LORA + ROPE;
  static constexpr int VEC = 16 / sizeof(TP);    // values a 16-byte chunk
  static constexpr int CH = W / VEC;             // chunks a key row
  static constexpr int LCH = LORA / VEC;         // of them ckv's
  // an odd number of chunks a row: 8 keys' chunk c on distinct banks
  static constexpr int RS = 16 * (CH | 1);
  static constexpr int STAGES = 2;
  static constexpr int MINB = TC ? 2 : 1;         // blocks an SM at least
  static constexpr int TILE = TK * RS;
  static constexpr int QS = W * sizeof(TQ) + 16;  // query row stride
  static constexpr int S_OFF = STAGES * TILE;
  static constexpr int P_OFF = S_OFF + KQ * HB * SST * 4;
  static constexpr int P_END =
      P_OFF + (TC ? PT * HB * PST * 2 : TK * (HB + 4) * 4);
  static constexpr int Q_OFF = TC ? (STAGES - 1) * TILE : P_END;
  static constexpr int C_OFF = TC ? P_END : P_END + HB * QS;
  static constexpr int SMEM = C_OFF + 3 * HB * 4;
  static_assert(LORA % 16 == 0 && ROPE % 16 == 0, "whole k16 steps");
  static_assert(RPW * WARPS == HB, "whole heads a warp");
  static_assert(Q_OFF + HB * QS <= C_OFF, "the query rows fit");
  static_assert(STAGES * TILE >= MAX_SPLITS * HB * 4,
                "the merge's weights fit over the ring");
};

// d (m16n8, f32) += a (m16k16 bf16) * b (k16n8 bf16)
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a)
      : "memory");
}

// d (m16n8, f32) += a (m16k8 bf16) * b (k8n8 bf16)
__device__ __forceinline__ void mma1688(float (&d)[4],
                                        const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// (lo, hi) as N bf16 pairs whose sum is (lo, hi): term i is the bf16
// rounding of what terms 0..i-1 leave (each residual exact in f32)
template <int N>
__device__ __forceinline__ void split_pack(float lo, float hi,
                                           uint32_t (&t)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    t[i] = *reinterpret_cast<const uint32_t*>(&v);
    const float2 f = __bfloat1622float2(v);
    lo -= f.x;
    hi -= f.y;
  }
}

// n values of T at p, to f32 (n = 2 or 4; p aligned to n values)
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const float2 a = ld2(p), b = ld2(p + 2);
  return make_float4(a.x, a.y, b.x, b.y);
}

// 2^x: one MUFU.EX2 on the tensor-core body, exp2f on the CUDA cores
template <bool FAST>
__device__ __forceinline__ float ex2(float x) {
  return FAST ? paged_attn::fast_exp2(x) : exp2f(x);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(bf16* p, float4 v) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y),
                         __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

// The tensor-core body (bf16 pools).  The block's 16 heads are the M
// rows of every MMA.  The warps split QK^T's k dimension evenly in steps
// of 8 columns (576 = 8 warps x 72): warp w's k8 steps [s0, s1) are its
// aligned pairs as k16 steps (m16n8k16) and at most NS lone k8 steps at
// either end (m16n8k8), their query terms' A fragments held in registers
// for the whole walk.  Warp w also owns PV's column pairs (16 columns
// each) [np0, np0 + nnp).
template <typename TQ, typename TP, int LORA, int ROPE>
struct Mma {
  using C = Cfg<TQ, TP, LORA, ROPE>;
  static constexpr int W8 = C::WARPS;
  static constexpr int K8 = C::W / 8;                   // k8 steps
  static constexpr int K8W = (K8 + W8 - 1) / W8;        // most a warp takes
  static constexpr int KP = K8W > 1 ? K8W / 2 : 1;      // most k16 pairs
  // lone k8 steps: one where every warp takes the same odd count
  static constexpr int NS = K8 % W8 == 0 && K8W % 2 == 1 ? 1 : 2;
  static constexpr int NP = LORA / 16;                  // PV column pairs
  static constexpr int NPW = (NP + W8 - 1) / W8;
  uint32_t qa[KP][C::QT][4];       // the k16 pairs' A fragments
  uint32_t q8[NS][C::QT][2];       // the lone k8 steps'
  float o[2 * NPW][4];             // the PV sums

  // warp w's share of QK^T's k: npair k16 steps from kp0, and nlone lone
  // k8 steps (lone0, then lone1).  Recomputed where used (a few integer
  // operations) rather than held in registers across the walk.
  struct Steps {
    int kp0, npair, nlone, lone0, lone1;
  };
  __device__ __forceinline__ static Steps steps(int warp) {
    const int s0 = warp * K8 / W8, s1 = (warp + 1) * K8 / W8;
    const int lead = (s0 & 1) && s1 > s0;
    const int trail = (s1 - s0 - lead) & 1;
    return {(s0 + lead) / 2, (s1 - s0 - lead) / 2, lead + trail,
            lead ? s0 : s1 - 1, s1 - 1};
  }

  // q_s: the block's query rows in shared memory, C::QS bytes apart
  __device__ __forceinline__ void init(const unsigned char* q_s, int warp,
                                       int lane) {
    const int gid = lane >> 2, tq = lane & 3;
    const Steps k = steps(warp);
#pragma unroll
    for (int j = 0; j < 2 * NPW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    auto pair = [&](int row, int col) {
      return ld2(reinterpret_cast<const TQ*>(q_s + row * C::QS) + col);
    };
    // a0: (row gid, k 2tq + {0, 1}), a1: row gid + 8, a2 / a3: k + 8
#pragma unroll
    for (int s = 0; s < KP; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 v =
            s < k.npair ? pair(gid + 8 * (e & 1),
                               16 * (k.kp0 + s) + 8 * (e >> 1) + 2 * tq)
                        : make_float2(0.f, 0.f);
        uint32_t t[C::QT];
        split_pack<C::QT>(v.x, v.y, t);
#pragma unroll
        for (int i = 0; i < C::QT; ++i) qa[s][i][e] = t[i];
      }
#pragma unroll
    for (int u = 0; u < NS; ++u)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float2 v = u < k.nlone ? pair(gid + 8 * e,
                                            8 * (u ? k.lone1 : k.lone0) +
                                                2 * tq)
                                     : make_float2(0.f, 0.f);
        uint32_t t[C::QT];
        split_pack<C::QT>(v.x, v.y, t);
#pragma unroll
        for (int i = 0; i < C::QT; ++i) q8[u][i][e] = t[i];
      }
  }

  // this warp's partial scores of the 16 heads x the tile's 32 keys
  // (tile at shared address st) -> S[warp][head][key], one 16-key half
  // at a time (8 accumulator registers)
  __device__ __forceinline__ void scores(const unsigned char*, uint32_t st,
                                         float* S, int warp, int lane) {
    const Steps k = steps(warp);
    // ldmatrix x4 of a k16 pair: keys 8 (lane / 16) + lane % 8 of a
    // 16-key half, the low or high 8 columns by (lane / 8) % 2; x2 of a
    // lone k8 step: key lane % 16 of the half
    const uint32_t base = st + (8 * (lane >> 4) + (lane & 7)) * C::RS +
                          (((lane >> 3) & 1) << 4);
    const uint32_t base8 = st + (lane & 15) * C::RS;
    float* row = S + (warp * C::HB + (lane >> 2)) * SST + 2 * (lane & 3);
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      float sc[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int s = 0; s < KP; ++s) {
        if (s < k.npair) {
          uint32_t b[4];
          ldsm_x4(b, base + 16 * jp * C::RS + 32 * (k.kp0 + s));
#pragma unroll
          for (int i = 0; i < C::QT; ++i) {
            mma16816(sc[0], qa[s][i], b[0], b[1]);
            mma16816(sc[1], qa[s][i], b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < NS; ++u) {
        if (u < k.nlone) {
          uint32_t b[2];   // the k8 step's B of the half's 2 n8 tiles
          ldsm_x2(b,
                  base8 + 16 * jp * C::RS + 16 * (u ? k.lone1 : k.lone0));
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i = 0; i < C::QT; ++i) mma1688(sc[j], q8[u][i], b[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float* at = row + 16 * jp + 8 * j;
        *reinterpret_cast<float2*>(at) = make_float2(sc[j][0], sc[j][1]);
        *reinterpret_cast<float2*>(at + 8 * SST) =
            make_float2(sc[j][2], sc[j][3]);
      }
    }
  }

  // head r's weight of key t, f32 -> its PT bf16 terms in P
  __device__ __forceinline__ static void store_p(unsigned char* P, int r,
                                                 int t, float p) {
    bf16* pp = reinterpret_cast<bf16*>(P);
#pragma unroll
    for (int i = 0; i < C::PT; ++i) {
      const bf16 v = __float2bfloat16_rn(p);
      pp[(i * C::HB + r) * PST + t] = v;
      p -= __bfloat162float(v);
    }
  }

  // o = o * corr + P V over the tile (at shared address st); warp w owns
  // PV's column pairs (16 columns each) [np0, np1)
  __device__ __forceinline__ void pv(const unsigned char*, uint32_t st,
                                     const unsigned char* P,
                                     const float* corr, int warp, int lane) {
    const int gid = lane >> 2;
    const int np0 = warp * NP / W8, nnp = (warp + 1) * NP / W8 - np0;
    const float c0 = corr[gid], c1 = corr[gid + 8];
#pragma unroll
    for (int j = 0; j < 2 * NPW; ++j) {
      o[j][0] *= c0;
      o[j][1] *= c0;
      o[j][2] *= c1;
      o[j][3] *= c1;
    }
    // P (A, ldmatrix): heads lane % 8 + 8 ((lane / 8) % 2), keys + 8
    // (lane / 16); V (B, ldmatrix.trans): keys lane % 8 + 8 ((lane / 8) %
    // 2), columns + 8 (lane / 16)
    const int r8 = (lane & 7) + 8 * ((lane >> 3) & 1);
    const uint32_t pbase =
        paged_attn::smem_u32(P) + (r8 * PST + 8 * (lane >> 4)) * 2;
    const uint32_t vbase = st + r8 * C::RS + ((lane >> 4) << 4);
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t pa[C::PT][4];
#pragma unroll
      for (int i = 0; i < C::PT; ++i)
        ldsm_x4(pa[i], pbase + (i * C::HB * PST + 16 * kk) * 2);
#pragma unroll
      for (int jp = 0; jp < NPW; ++jp) {
        if (jp < nnp) {
          uint32_t b[4];
          ldsm_x4_t(b, vbase + 16 * kk * C::RS + 32 * (np0 + jp));
#pragma unroll
          for (int i = 0; i < C::PT; ++i) {
            mma16816(o[2 * jp], pa[i], b[0], b[1]);
            mma16816(o[2 * jp + 1], pa[i], b[2], b[3]);
          }
        }
      }
    }
  }

  // f(head r of the block, column, the sums of columns (col, col + 1))
  // for this thread's sums
  template <typename F>
  __device__ __forceinline__ void each(int warp, int lane, F f) const {
    const int gid = lane >> 2, tq = lane & 3;
    const int np0 = warp * NP / W8, nnp = (warp + 1) * NP / W8 - np0;
#pragma unroll
    for (int jp = 0; jp < NPW; ++jp)
      if (jp < nnp)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 16 * (np0 + jp) + 8 * e + 2 * tq;
          f(gid, col, o[2 * jp + e][0], o[2 * jp + e][1]);
          f(gid + 8, col, o[2 * jp + e][2], o[2 * jp + e][3]);
        }
  }
};

// The CUDA-core body (f32 pools).  Scores: warp w's lanes take the tile's
// 32 keys for heads 4w..4w+3, FMAs on 16-byte pieces (Q broadcast from
// shared memory).  PV: thread t < LORA / 4 owns 4 columns of the 16
// heads.
template <typename TQ, typename TP, int LORA, int ROPE>
struct Core {
  using C = Cfg<TQ, TP, LORA, ROPE>;
  static constexpr int NCG = LORA / 4;           // 4-column groups
  static constexpr int PS = C::HB + 4;           // P row stride (floats)
  static_assert(C::RPW == 4 && C::HB == 16 && NCG <= C::THREADS,
                "4 heads a warp, 16 a thread");
  float acc[16][4];
  const unsigned char* q_s;
  int cg;
  bool on;

  __device__ __forceinline__ void init(const unsigned char* q, int, int) {
    q_s = q;
    on = threadIdx.x < NCG;
    cg = threadIdx.x;
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
  }

  __device__ __forceinline__ void scores(const unsigned char* st, uint32_t,
                                         float* S, int warp, int lane) {
    const float4* k = reinterpret_cast<const float4*>(st + lane * C::RS);
    const unsigned char* q = q_s + 4 * warp * C::QS;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < C::W / 4; ++d) {
      const float4 kv = k[d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 qv =
            ld4(reinterpret_cast<const TQ*>(q + j * C::QS) + 4 * d);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) S[(4 * warp + j) * SST + lane] = s[j];
  }

  __device__ __forceinline__ static void store_p(unsigned char* P, int r,
                                                 int t, float p) {
    reinterpret_cast<float*>(P)[t * PS + r] = p;
  }

  __device__ __forceinline__ void pv(const unsigned char* st, uint32_t,
                                     const unsigned char* P,
                                     const float* corr, int, int) {
    if (!on) return;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float c = corr[r];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] *= c;
    }
    const float* pf = reinterpret_cast<const float*>(P);
    for (int t = 0; t < TK; ++t) {
      const float4 v = *reinterpret_cast<const float4*>(st + t * C::RS +
                                                        16 * cg);
      float p[16];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        *reinterpret_cast<float4*>(p + 4 * u) =
            *reinterpret_cast<const float4*>(pf + t * PS + 4 * u);
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        acc[r][0] = fmaf(p[r], v.x, acc[r][0]);
        acc[r][1] = fmaf(p[r], v.y, acc[r][1]);
        acc[r][2] = fmaf(p[r], v.z, acc[r][2]);
        acc[r][3] = fmaf(p[r], v.w, acc[r][3]);
      }
    }
  }

  template <typename F>
  __device__ __forceinline__ void each(int, int, F f) const {
    if (!on) return;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      f(r, 4 * cg, acc[r][0], acc[r][1]);
      f(r, 4 * cg + 2, acc[r][2], acc[r][3]);
    }
  }
};

// One block of (slot, head block, split) = blockIdx (x, y, z).  q_lat (b,
// h, LORA), q_rope (b, h, ROPE) and out (b, h, LORA) of TQ; ckv_pool
// (n_pages, page, LORA) and kr_pool (n_pages, page, ROPE) of TP; bt (b,
// n_slots) and lens (b,) int32.  With gridDim.z > 1, part holds b *
// gridDim.y * splits records of HB * (LORA + 2) floats (m[HB], l[HB], HB
// rows of LORA sums) and counters b * gridDim.y zeros, left at zero.
template <typename TQ, typename TP, int LORA, int ROPE>
__global__ void __launch_bounds__(Cfg<TQ, TP, LORA, ROPE>::THREADS,
                                  Cfg<TQ, TP, LORA, ROPE>::MINB)
    mla_kernel(const TQ* __restrict__ q_lat, const TQ* __restrict__ q_rope,
               const TP* __restrict__ ckv_pool,
               const TP* __restrict__ kr_pool, const int* __restrict__ bt,
               const int* __restrict__ lens, TQ* __restrict__ out,
               float* __restrict__ part, int* __restrict__ counters, int h,
               int page, int n_slots, int window, float scale) {
  using C = Cfg<TQ, TP, LORA, ROPE>;
  using Body = std::conditional_t<C::TC, Mma<TQ, TP, LORA, ROPE>,
                                  Core<TQ, TP, LORA, ROPE>>;
  constexpr int HB = C::HB, THREADS = C::THREADS, STAGES = C::STAGES;
  constexpr int RPW = C::RPW;
  constexpr int REC = HB * (LORA + 2);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int share_at[2];   // this share's rank, the live shares
  __shared__ int last;
  const int slot = blockIdx.x, hb = blockIdx.y, split = blockIdx.z;
  const int n_hb = gridDim.y, splits = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int head0 = hb * HB;
  TQ* out_s = out + (long long)slot * h * LORA;
  float* S = reinterpret_cast<float*>(smem + C::S_OFF);
  unsigned char* P = smem + C::P_OFF;
  float* corr_s = reinterpret_cast<float*>(smem + C::C_OFF);
  float* m_s = corr_s + HB;
  float* l_s = m_s + HB;
  const uint32_t ring_s = paged_attn::smem_u32(smem);

  // the block's query rows, [q_lat | q_rope] in 16-byte chunks (rows
  // past h zero-filled), copied while the slot's length is read: a
  // commit group of their own, before the first tile's
  {
    constexpr int QV = 16 / sizeof(TQ), QCH = C::W / QV, QLCH = LORA / QV;
    const TQ* ql = q_lat + ((long long)slot * h + head0) * LORA;
    const TQ* qr = q_rope + ((long long)slot * h + head0) * ROPE;
    for (int i = tid; i < HB * QCH; i += THREADS) {
      const int r = i / QCH, c = i - r * QCH;
      const bool ok = head0 + r < h;
      const TQ* src = c < QLCH ? ql + r * LORA + c * QV
                               : qr + r * ROPE + (c - QLCH) * QV;
      paged_attn::cp_async16(ring_s + C::Q_OFF + r * C::QS + 16 * c,
                             ok ? src : q_lat, ok);
    }
    paged_attn::cp_async_commit();
  }

  int kb, ke, rank, active;
  paged_attn::share_keys(lens[slot], window, page, n_slots, split, splits,
                         &kb, &ke, &rank, &active);
  if (ke <= kb) {
    paged_attn::cp_async_wait<0>();
    // no work: an empty share is not counted, and split 0 of a slot with
    // no key writes its zeros
    if (active == 0 && split == 0)
      for (int i = tid; i < HB * LORA; i += THREADS)
        if (head0 + i / LORA < h)
          paged_attn::store_f(out_s, (long long)head0 * LORA + i, 0.f);
    return;
  }

  // the tiles of TK keys from kb: THREADS / TK threads a key, its ckv
  // chunks ck_sub, + TPK, ... then its kr chunks so, by cp.async; keys
  // past the share zero-filled (row 0 named, not read)
  constexpr int TPK = THREADS / TK;
  constexpr int KR = C::CH - C::LCH;             // kr chunks a key
  const int ck = tid / TPK, ck_sub = tid % TPK;
  const int* __restrict__ row_bt = bt + (long long)slot * n_slots;
  const int shift = (page & (page - 1)) == 0 ? __ffs(page) - 1 : -1;
  auto page_of = [&](int k) { return shift >= 0 ? k >> shift : k / page; };
  // the page id of this thread's key of the tile from key k0, read a tile
  // ahead of its copies
  auto lookup = [&](int k0) {
    const int k = k0 + ck;
    return k < ke ? __ldg(row_bt + page_of(k)) : 0;
  };
  auto issue = [&](int k0, int stage, int id) {
    if (k0 < ke) {
      const int k = k0 + ck;
      const bool ok = k < ke;
      const long long row =
          ok ? (long long)id * page + (k - page_of(k) * page) : 0;
      const uint32_t dst =
          ring_s + stage * C::TILE + ck * C::RS + 16 * ck_sub;
      const TP* cs = ckv_pool + row * LORA + ck_sub * C::VEC;
#pragma unroll
      for (int j = 0; j < C::LCH / TPK; ++j)
        paged_attn::cp_async16(dst + 16 * TPK * j, cs + TPK * C::VEC * j, ok);
      if (C::LCH % TPK && ck_sub < C::LCH % TPK)
        paged_attn::cp_async16(dst + 16 * (C::LCH / TPK) * TPK,
                               cs + (C::LCH / TPK) * TPK * C::VEC, ok);
      const TP* ks = kr_pool + row * ROPE + ck_sub * C::VEC;
#pragma unroll
      for (int j = 0; j < (KR + TPK - 1) / TPK; ++j)
        if (ck_sub + TPK * j < KR)
          paged_attn::cp_async16(dst + 16 * (C::LCH + TPK * j),
                                 ks + TPK * C::VEC * j, ok);
    }
    paged_attn::cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t)
    issue(kb + t * TK, t, lookup(kb + t * TK));
  int id_next = lookup(kb + (STAGES - 1) * TK);
  // the merge's share numbers, kept out of the walk's registers
  if (tid == 0) {
    share_at[0] = rank;
    share_at[1] = active;
  }
  paged_attn::cp_async_wait<STAGES - 1>();   // the query rows landed
  __syncthreads();
  Body body;
  body.init(smem + C::Q_OFF, warp, lane);

  // softmax state of heads RPW warp + j: m (warp-uniform), l (this lane's
  // keys)
  const float sl2 = scale * LOG2E;
  float m[RPW], l[RPW];
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    m[j] = NEG_INF;
    l[j] = 0.f;
  }
  int stage = 0;
  for (int k0 = kb; k0 < ke; k0 += TK) {
    // this tile landed for every thread, and every warp is done with the
    // last one (and, at the first, with the query rows), whose stage the
    // next copies take
    paged_attn::cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int off = stage * C::TILE;
    body.scores(smem + off, ring_s + off, S, warp, lane);
    // the next tile's copies, after the scores' MMAs are issued
    issue(k0 + (STAGES - 1) * TK, stage == 0 ? STAGES - 1 : stage - 1,
          id_next);
    id_next = lookup(k0 + STAGES * TK);
    __syncthreads();
    const bool valid = k0 + lane < ke;
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int r = RPW * warp + j;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < C::KQ; ++q) s += S[(q * HB + r) * SST + lane];
      s = valid ? s * sl2 : NEG_INF;
      const float mx = fmaxf(m[j], paged_attn::warp_max(s));
      const float corr = ex2<C::TC>(m[j] - mx);
      const float p = valid ? ex2<C::TC>(s - mx) : 0.f;
      m[j] = mx;
      l[j] = fmaf(l[j], corr, p);
      Body::store_p(P, r, lane, p);
      if (lane == 0) corr_s[r] = corr;
    }
    __syncthreads();
    body.pv(smem + off, ring_s + off, P, corr_s, warp, lane);
    stage = stage + 1 == STAGES ? 0 : stage + 1;
  }
  paged_attn::cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const float lt = paged_attn::warp_sum(l[j]);
    if (lane == 0) {
      m_s[RPW * warp + j] = m[j];
      l_s[RPW * warp + j] = lt;
    }
  }
  __syncthreads();

  // the sums through shared memory (over the ring, no longer read), so
  // that the output or the share's record is written in whole rows
  constexpr int NC4 = LORA / 4, OS = LORA + 4;
  static_assert(HB * OS * 4 <= C::S_OFF, "the sums fit over the ring");
  float* o_s = reinterpret_cast<float*>(smem);
  body.each(warp, lane, [&](int r, int col, float a0, float a1) {
    *reinterpret_cast<float2*>(o_s + r * OS + col) = make_float2(a0, a1);
  });
  __syncthreads();
  if (share_at[1] == 1) {
    for (int i = tid; i < HB * NC4; i += THREADS) {
      const int r = i / NC4, head = head0 + r;
      if (head >= h) continue;
      const float4 v = *reinterpret_cast<const float4*>(
          o_s + r * OS + 4 * (i - r * NC4));
      const float d = fmaxf(l_s[r], 1e-20f);
      st4(out_s + (long long)head * LORA + 4 * (i - r * NC4),
          m_s[r] == NEG_INF
              ? make_float4(0.f, 0.f, 0.f, 0.f)
              : make_float4(v.x / d, v.y / d, v.z / d, v.w / d));
    }
    return;
  }
  rank = share_at[0];
  active = share_at[1];
  float* rec =
      part + (((long long)slot * n_hb + hb) * splits + rank) * REC;
  for (int r = tid; r < HB; r += THREADS) {
    rec[r] = m_s[r];
    rec[HB + r] = l_s[r];
  }
  for (int i = tid; i < HB * NC4; i += THREADS) {
    const int r = i / NC4;
    st4(rec + 2 * HB + 4 * i,
        *reinterpret_cast<const float4*>(o_s + r * OS + 4 * (i - r * NC4)));
  }

  // the last live split of (slot, head block) to finish merges them all:
  // the block's writes released and the others' acquired through the
  // counter by thread 0, ordered for the block by its barriers
  __syncthreads();
  if (tid == 0) {
    int* ctr = counters + slot * n_hb + hb;
    int done;
    __threadfence();
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(done)
                 : "l"(ctr)
                 : "memory");
    last = done == active - 1;
    if (last) *ctr = 0;
  }
  __syncthreads();
  if (!last) return;
  // each share's weight of each head, w_s / sum_s(w_s l_s) with w_s =
  // 2^(m_s - max m), over the ring (no longer read); then each output the
  // weighted sum of the shares' sums, a thread's NI groups of 4 columns
  // of U shares loaded at once
  const float* base = part + ((long long)slot * n_hb + hb) * splits * REC;
  float* coef = reinterpret_cast<float*>(smem);
  for (int r = tid; r < HB; r += THREADS) {
    float mm = NEG_INF;
    for (int s = 0; s < active; ++s)
      mm = fmaxf(mm, __ldcg(base + s * REC + r));
    float lt = 0.f;
    for (int s = 0; s < active; ++s)
      lt = fmaf(__ldcg(base + s * REC + HB + r),
                ex2<C::TC>(__ldcg(base + s * REC + r) - mm), lt);
    const float inv = mm == NEG_INF ? 0.f : 1.f / fmaxf(lt, 1e-20f);
    for (int s = 0; s < active; ++s)
      coef[s * HB + r] = ex2<C::TC>(__ldcg(base + s * REC + r) - mm) * inv;
  }
  __syncthreads();
  constexpr int NI = (HB * NC4 + THREADS - 1) / THREADS;
  constexpr int U = NI >= 8 ? 1 : 4;
  float4 a[NI];
#pragma unroll
  for (int ii = 0; ii < NI; ++ii) a[ii] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < active; s0 += U) {
    float4 v[U][NI];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int ii = 0; ii < NI; ++ii) {
        const int i = tid + ii * THREADS;
        v[u][ii] = s0 + u < active && i < HB * NC4
                       ? __ldcg(reinterpret_cast<const float4*>(
                             base + (s0 + u) * REC + 2 * HB + 4 * i))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int ii = 0; ii < NI; ++ii) {
        const int i = tid + ii * THREADS;
        const float c =
            s0 + u < active && i < HB * NC4 ? coef[(s0 + u) * HB + i / NC4]
                                            : 0.f;
        a[ii].x = fmaf(c, v[u][ii].x, a[ii].x);
        a[ii].y = fmaf(c, v[u][ii].y, a[ii].y);
        a[ii].z = fmaf(c, v[u][ii].z, a[ii].z);
        a[ii].w = fmaf(c, v[u][ii].w, a[ii].w);
      }
  }
#pragma unroll
  for (int ii = 0; ii < NI; ++ii) {
    const int i = tid + ii * THREADS, head = head0 + i / NC4;
    if (i >= HB * NC4 || head >= h) continue;
    st4(out_s + (long long)head * LORA + 4 * (i % NC4), a[ii]);
  }
}

template <typename TQ, typename TP, int LORA, int ROPE>
int launch_one(const long long* a, float scale, cudaStream_t stream) {
  using C = Cfg<TQ, TP, LORA, ROPE>;
  static unsigned smem_set = 0;
  const int b = (int)a[9], h = (int)a[10], page = (int)a[13],
            n_slots = (int)a[14], splits = (int)a[15], window = (int)a[16];
  // the host's plan (mla_plan.py) must mirror this instantiation
  if (a[17] != C::SMEM || a[18] != C::THREADS || splits < 1 ||
      splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = paged_attn::allow_max_smem(
      mla_kernel<TQ, TP, LORA, ROPE>, &smem_set);
  if (err != cudaSuccess) return (int)err;
  const int n_hb = (h + C::HB - 1) / C::HB;
  mla_kernel<TQ, TP, LORA, ROPE>
      <<<dim3(b, n_hb, splits), C::THREADS, C::SMEM, stream>>>(
          reinterpret_cast<const TQ*>(a[0]), reinterpret_cast<const TQ*>(a[1]),
          reinterpret_cast<const TP*>(a[2]), reinterpret_cast<const TP*>(a[3]),
          reinterpret_cast<const int*>(a[4]),
          reinterpret_cast<const int*>(a[5]), reinterpret_cast<TQ*>(a[6]),
          reinterpret_cast<float*>(a[7]), reinterpret_cast<int*>(a[8]), h,
          page, n_slots, window, scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TP>
int with_latent(int lora, int rope, const long long* a, float scale,
                cudaStream_t s) {
  if (lora == 512 && rope == 64)
    return launch_one<TQ, TP, 512, 64>(a, scale, s);
  if (lora == 64 && rope == 16) return launch_one<TQ, TP, 64, 16>(a, scale, s);
  if (lora == 32 && rope == 16) return launch_one<TQ, TP, 32, 16>(a, scale, s);
  return (int)cudaErrorInvalidValue;
}

template <typename TQ>
int with_pool(int pool_dtype, int lora, int rope, const long long* a,
              float scale, cudaStream_t s) {
  if (pool_dtype == 0) return with_latent<TQ, float>(lora, rope, a, scale, s);
  if (pool_dtype == 1) return with_latent<TQ, bf16>(lora, rope, a, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One launch, its arguments packed as 64-bit integers, in order: q_lat,
// q_rope, ckv_pool, kr_pool, block_table, lens, out, part, counters, b, h,
// lora, rope, page, n_slots, splits, window, smem, threads, q_dtype (q_lat,
// q_rope and out) and pool_dtype (both pools): 0 = float32, 1 = bfloat16.
// (lora, rope) is (512, 64), (64, 16) or (32, 16); smem and threads are
// the plan's (mla_plan.py), checked against the instantiation's.  part and
// counters are used only with splits > 1 (see mla_kernel).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int paged_mla_decode_attention_launch(const long long* a,
                                                 float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lora = (int)a[11], rope = (int)a[12];
  if (a[19] == 0) return with_pool<float>((int)a[20], lora, rope, a, scale, s);
  if (a[19] == 1) return with_pool<bf16>((int)a[20], lora, rope, a, scale, s);
  return (int)cudaErrorInvalidValue;
}
