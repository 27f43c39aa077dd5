// Backward of the dense chunked-prefill attention (kernel 5) for Hopper.
//
// Replaces JAX's autodiff of the reference's blocked flash attention,
// `flash_attn` (src/repro/models/attention.py:49), which the reference
// trains through.  In the port every train-mode attention (gqa_forward,
// mla_forward, cross_forward) runs its forward on kernel 5
// (chunked_prefill_attention.cu, the counterpart of the TPU kernel
// src/repro/kernels/chunked_prefill_attention.py), and its gradient
// here.  Kernel 5 is left untouched, so no served path moves.
//
// Function: q (b, sq, h, hd) at the shared absolute start q_offset, keys
// k (b, skv, kvh, hd) and values v (b, skv, kvh, hd_v) at positions 0..,
// key j live for query position p when j < kv_len[b] and, if causal, j
// <= p, and, with a window, j > p - window.  With P the masked softmax of
// (q . k) * scale over the live keys, out = P v and dout given:
//   dV_j = sum_i P_ij dO_i          D_i  = dO_i . O_i
//   dS_ij = P_ij (dO_i . v_j - D_i)
//   dQ_i = scale sum_j dS_ij k_j    dK_j = scale sum_i dS_ij q_i
// summed over the rep query heads that read one KV head.  A query row
// with no live key (kernel 5 writes 0 for it) and a key row no query
// reaches, those at or past kv_len included, get exactly 0.
//
// What bounds it on an H100: five products (Q K^T, dO V^T, P^T dO,
// dS^T Q, dS K), each 2 * hd FLOPs per live (query head, key) pair,
// against one read of q, k, v, out, dout and one write of dq, dk, dv: at
// the training shapes (sequences of 128-4,096, heads of 64-256) that is
// hundreds of FLOPs a byte, so the tensor cores bound it: 989 TFLOP/s
// for bf16 inputs (or 3.35 TB/s where a shape has too few pairs), and
// 989 / 6 = 165 TFLOP/s effective for f32 inputs, which take six bf16
// products a product (below; the same as 3xTF32's 495 / 3).
//
// Design: two launches on the caller's stream, no atomics, so the result
// is deterministic (every output element is written by one block, its
// sums always in one order), and the forward saves nothing, so the
// backward recomputes each row's max and sum.
//   (a) dq_kernel, one block per (request, query head, tile of 64 query
//       positions, share of dQ's columns): loop 1 over the live key
//       tiles computes S = Q K^T for each row's max m and sum l; m, 1/l
//       (0 for a row with no live key) and D go to `stats` for (b).
//       Loop 2 walks the tiles again: S, dP = dO V^T, P, dS and dQ +=
//       dS K.
//   (b) dkdv_kernel, one block per (request, KV head, tile of 64 keys,
//       share of dV's and dK's columns), its K and V rows resident in
//       shared memory: it walks the rep query heads x the query tiles
//       that can see its keys (causal, window) and computes the
//       transposed scores S^T = K Q^T and dP^T = V dO^T, P^T and dS^T in
//       registers, and dV += P^T dO, dK += dS^T Q.
// A warp's accumulators are 16 rows x the columns its block sums.  Where
// hd + hd_v <= 160 one block sums all of dV and dK (64 + 64 columns at
// hd 64: 64 registers a thread).  Wider, dV and dK have blocks of their
// own, and a sum wider than 128 columns (hd 192 and 256, hd_v 256) is
// split in halves over two blocks; each recomputes its scores (S^T for
// dV, S^T and dP^T for dK).  At hd 64 the split blocks need fewer
// registers (168 against 255) but walk every query tile twice, and
// measured 1.3x slower on the H100 at OPT-125M-cls's training shape.
// So a narrow tile pair takes 8 products of the width (S thrice, dP
// twice, dS K, P^T dO and dS^T Q), where five would do with atomics and
// a saved log-sum-exp.
// Every product takes one of two forms on `mma.sync` (4 warps a block, 16
// of the block's 64 rows each): `qk`, C = X Y^T with X the warp's
// resident rows and Y a walked tile's, and `pv`, C += A Z with A the f32
// result of a `qk` still in registers (its C fragments are A fragments
// after a repack) and Z a walked tile's rows.  The walked tiles (K and V
// in (a), Q, dO and the stats in (b)) come through a ring of `cp.async`
// stages, so the next tile's copies overlap this one's math; rows past
// the live range are zero-filled, never read, so garbage past kv_len
// never meets a product.  Tiles where every (query, key) pair is live
// skip the per-element masks; the softmax runs in base 2 (ex2.approx,
// as accurate as expf) with m kept in log2 units.
//
// Types.  Every product runs on m16n8k16 bf16 with f32 sums.  bf16
// inputs: Q, K, V and dO enter exactly; the f32 intermediates P and dS
// enter as three bf16 terms each (hi + mid + lo, each the bf16 rounding
// of what the earlier ones leave, as kernel 3 splits its f32 queries):
// with one term the gradients' f32 values would move by a few parts in a
// thousand, enough to flip the bf16 rounding of gradients of 4-16
// against the plain version's, beyond the 2e-2 limit.  So the three `pv`
// products cost three bf16 products each.  f32 inputs ("6xBF16"): every
// operand as three bf16 terms too, 24 bits, and each product the six
// term pairs whose weight reaches 2^-24: the tensor-core work of 3xTF32
// (CUTLASS's fast f32: three TF32 products of two-term operands, about 22
// bits), which was this body's first form and measured up to 64x
// farther from an f64 witness than the f32 plain version (RecurrentGemma's
// 4,096 positions); most of that was the
// tensor cores' truncating sums, which every split product here avoids
// (mma_group: each step of 16 products summed from zero and added to its
// accumulator on the CUDA cores).  The f32 operand a warp owns (its
// resident rows) is split as it is read; a walked tile, read by all four
// warps, is split once a tile into three bf16 planes that the products
// read with ldmatrix.
//
// Head widths (hd, hd_v): (32, 32), (64, 64), (80, 64) (the DeepSeek-V2
// smoke config's MLA), (128, 128), (192, 128) (MLA decompressed) and
// (256, 256); these are the only list of them: for any other pair the
// launch returns NO_WIDTHS (-1) before launching anything, and the
// wrapper raises ValueError.  Shared memory: the 64 resident rows, the
// ring and, for f32, the planes; bf16 walks tiles of 64 rows in 2 stages
// (32 at (192, 128), where 64 leaves one block an SM and 32 fits two:
// 1.2x faster there), f32 tiles of 32 rows (16 at (256, 256)), in 2
// stages up to hd + hd_v = 256 and 1 above, to fit 227 KB.
// kernels/bwd_plan.py mirrors Cfg; the launch checks that the wrapper's
// plan agrees and returns PLAN_MISMATCH (-2) if not.
#include "paged_attention.cuh"

namespace {

using bf16 = __nv_bfloat16;
using paged_attn::cp_async16;
using paged_attn::cp_async_commit;
using paged_attn::cp_async_wait;
using paged_attn::fast_exp2;
using paged_attn::ldsm_x4;
using paged_attn::ldsm_x4_t;
using paged_attn::NEG_INF;
using paged_attn::smem_u32;

constexpr int NO_WIDTHS = -1;     // (hd, hd_v) not instantiated
constexpr int PLAN_MISMATCH = -2;  // the wrapper's plan is not Cfg's
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16 * WARPS;  // a block's own rows: queries or keys
constexpr int PT = 3;             // bf16 terms of an f32 value
constexpr float LOG2E = 1.4426950408889634f;
constexpr int FUSE_MAX = 160;     // hd + hd_v up to which one block sums
                                  // both dV and dK
constexpr int SM_SMEM = 233472;   // shared memory of an H100 SM

// Shared memory of either launch for inputs of E at a walked tile of bt
// rows: the 64 resident rows (8 elements of pad a row), the ring (a
// stage: bt rows of both operands as copied, 16 bytes of pad a row, then
// 3 x bt f32 stats for (b)), and for f32 the tile's bf16 planes
template <typename E>
__host__ __device__ constexpr int smem_bytes(int hd, int hd_v, int bt) {
  const bool f32 = std::is_same<E, float>::value;
  const int es = sizeof(E), w = hd + hd_v;
  const int stages = f32 && w > 256 ? 1 : 2;
  return ROWS * (w + 16) * es + stages * (bt * (w + 32 / es) * es + 12 * bt) +
         (f32 ? PT * bt * (w + 16) * 2 : 0);
}

// blocks of smem bytes an H100 SM holds (each takes 1 KB more)
__host__ __device__ constexpr int sm_blocks(int smem) {
  return SM_SMEM / (smem + 1024);
}

// The launch of one (dtype, hd, hd_v); mirrored by bwd_plan.py.
template <typename E, int HD, int HD_V>
struct Cfg {
  static constexpr bool F32 = std::is_same<E, float>::value;
  static constexpr int ES = sizeof(E);
  static constexpr int TERMS = F32 ? PT : 1;   // bf16 terms of an input
  // the block's own 64 rows, resident: 8 elements of pad a row (ldmatrix
  // rows, or f32 pairs, on distinct banks)
  static constexpr int RK = HD + 8, RV = HD_V + 8;
  // a walked tile of BT rows: as copied (16 bytes of pad a row) and as
  // the operand rows the products read, bf16 of HD + 8 and HD_V + 8 (for
  // bf16 inputs the copy itself; for f32 TERMS planes PLANE apart)
  static constexpr int WK = HD + 16 / ES, WV = HD_V + 16 / ES;
  static constexpr int PK = HD + 8, PV = HD_V + 8;
  static constexpr int STAGES = F32 && HD + HD_V > 256 ? 1 : 2;
  // f32: 32 rows (16 above hd + hd_v = 384), to fit beside the planes;
  // bf16: 64, or 32 where 64 leaves one block an SM and 32 fits two
  static constexpr int BT =
      F32 ? (HD + HD_V > 384 ? 16 : 32)
          : (sm_blocks(smem_bytes<E>(HD, HD_V, 64)) == 1 &&
                     sm_blocks(smem_bytes<E>(HD, HD_V, 32)) >= 2
                 ? 32
                 : 64);
  static constexpr int PLANE = BT * (PK + PV);
  static constexpr int RES = ROWS * (RK + RV) * ES;
  static constexpr int STAGE = BT * (WK + WV) * ES + 12 * BT;
  static constexpr int SMEM = smem_bytes<E>(HD, HD_V, BT);
  // a block's accumulator columns: one block sums dV and dK where hd +
  // hd_v <= FUSE_MAX, else each on its own, 128 columns at most
  static constexpr bool FUSED = HD + HD_V <= FUSE_MAX;
  static constexpr int CV = HD_V <= 128 ? HD_V : HD_V / 2;
  static constexpr int CK = HD <= 128 ? HD : HD / 2;
  static constexpr int V_PARTS = HD_V / CV;
  static constexpr int KV_PARTS = FUSED ? 1 : V_PARTS + HD / CK;
  static constexpr int Q_PARTS = HD / CK;
  static_assert(SMEM == RES + STAGES * STAGE + (F32 ? PT * PLANE * 2 : 0),
                "one layout");
  static_assert(HD % 16 == 0 && HD_V % 16 == 0, "whole k16 steps");
  static_assert(CV % 16 == 0 && CK % 16 == 0, "n8 tiles in pairs");
  static_assert(SMEM <= 232448, "fits an H100 block");
};

template <typename E>
struct Args {
  const E *q, *k, *v, *out, *dout;
  const int* kv_len;
  E *dq, *dk, *dv;
  float* stats;  // m (log2 units), then 1/l, then D, each (b, h, sq)
  int b, q_offset, sq, skv, h, kvh, window, causal;
  float scale;
};

// ---- copies ---------------------------------------------------------------

// 4 bytes global -> shared (zeros with valid false)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// rows [0, N) of a tile of W values a row, row i from src + i * stride
// (elements), to dst at a row stride of LD elements; rows at or past
// n_valid are zeros (and not read)
template <typename E, int W, int N, int LD>
__device__ __forceinline__ void copy_rows(E* dst, const E* src,
                                          long long stride, int n_valid) {
  constexpr int VEC = 16 / sizeof(E), CH = W / VEC;
  for (int idx = threadIdx.x; idx < N * CH; idx += THREADS) {
    const int i = idx / CH, c = idx - i * CH;
    const bool ok = i < n_valid;
    cp_async16(smem_u32(dst + i * LD + c * VEC),
               src + (ok ? i * stride + c * VEC : 0), ok);
  }
}

// The ring: tile t of n lands in stage t % STAGES; issue(t, stage) starts
// its copies and body(t, stage) runs once they have landed.  Every thread
// commits one cp.async group a tile (empty past the end), so wait_group
// counts tiles; a group committed before the walk (the resident rows)
// has landed by the first body.
template <int STAGES, typename Issue, typename Body>
__device__ __forceinline__ void walk(int n, Issue&& issue, Body&& body) {
#pragma unroll
  for (int s = 0; s + 1 < STAGES; ++s) {
    if (s < n) issue(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < n; ++t) {
    if (t + STAGES - 1 < n) issue(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    body(t, t % STAGES);
    __syncthreads();
  }
}

// ---- tensor-core products -------------------------------------------------

// d (m16n8, f32) += a (m16k16 bf16) * b (k16n8 bf16); not volatile, so
// the compiler may interleave independent products
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) as N bf16 pairs whose sum is (lo, hi): term i is the bf16
// rounding of what terms 0..i-1 leave (each residual exact in f32); with
// N = 3 the sum is (lo, hi) to 2^-24 of each, f32's own precision
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

// register r of every term of a fragment: the PT-term split of (lo, hi)
template <int R>
__device__ __forceinline__ void put_terms(uint32_t (&f)[PT][R], int r,
                                          float lo, float hi) {
  uint32_t t[PT];
  split_pack<PT>(lo, hi, t);
#pragma unroll
  for (int i = 0; i < PT; ++i) f[i][r] = t[i];
}

// acc[j0 + g] += sum of a[i] b[g][k] over the term pairs with i + k < PT
// (three for three terms against one, six for three against three: the
// dropped ones are below 2^-24 of the product), the smallest first, for
// G n8 tiles g at once so that G independent products separate two that
// depend on each other.  Each tile's terms are summed by the tensor cores
// from zero and added to acc on the CUDA cores.  The tensor cores sum
// with truncation (round toward zero), so a long sum kept in their
// accumulator drifts by an ulp of the running total an instruction:
// about 1e-4 of a gradient summed over 4,096 queries.  Summed this way
// each truncation is an ulp of one step's 16 products, and the running
// sum rounds to nearest, as an f32 FMA chain does.
template <int TA, int TB, int G, int NT>
__device__ __forceinline__ void mma_group(float (&acc)[NT][4], int j0,
                                          const uint32_t (&a)[TA][4],
                                          const uint32_t (&b)[G][TB][2]) {
  float t[G][4] = {};
#pragma unroll
  for (int s = PT - 1; s >= 0; --s)
#pragma unroll
    for (int i = 0; i < TA; ++i)
      if (s - i >= 0 && s - i < TB)
#pragma unroll
        for (int g = 0; g < G; ++g)
          mma_bf16(t[g], a[i], b[g][s - i][0], b[g][s - i][1]);
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j0 + g][e] += t[g][e];
}

// n8 tiles a group of mma_group
template <int NT>
constexpr int GROUP = NT % 4 == 0 ? 4 : 2;

// The A fragment of the warp's 16 rows X (row stride ldx) at columns
// kk..kk+15: bf16 rows by ldmatrix (one exact term), f32 rows by pairs
// (8 floats of row pad put a quad's pairs on distinct banks) split into
// PT terms.
__device__ __forceinline__ void a_frag(uint32_t (&a)[1][4], const bf16* X,
                                       int ldx, int kk, int lane) {
  ldsm_x4(a[0], smem_u32(X + (lane & 15) * ldx + (lane >> 4) * 8 + kk));
}
__device__ __forceinline__ void a_frag(uint32_t (&a)[PT][4], const float* X,
                                       int ldx, int kk, int lane) {
  const float* x = X + (lane >> 2) * ldx + kk + 2 * (lane & 3);
  const float2 v0 = *reinterpret_cast<const float2*>(x);
  const float2 v1 = *reinterpret_cast<const float2*>(x + 8 * ldx);
  const float2 v2 = *reinterpret_cast<const float2*>(x + 8);
  const float2 v3 = *reinterpret_cast<const float2*>(x + 8 * ldx + 8);
  put_terms(a, 0, v0.x, v0.y);
  put_terms(a, 1, v1.x, v1.y);
  put_terms(a, 2, v2.x, v2.y);
  put_terms(a, 3, v3.x, v3.y);
}

// qk: acc[j] += X . Y_j^T over W values, X the warp's 16 resident rows
// (E, row stride ldx), Y_j rows 8j..8j+7 of a walked tile's TB bf16
// planes (row stride ldy, planes `plane` apart), for j < NT.  In an m16n8
// C fragment lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8,
// columns 2t and 2t + 1.  For bf16 inputs (one exact term each) this sum
// of at most 16 steps stays in the tensor cores' accumulator.
template <int W, int NT, int TB, typename E>
__device__ __forceinline__ void qk(float (&acc)[NT][4], const E* X, int ldx,
                                   const bf16* Y, int ldy, int plane,
                                   int lane) {
  constexpr int TA = std::is_same<E, float>::value ? PT : 1;
  static_assert(NT % 2 == 0, "n8 tiles in pairs");
  const uint32_t ya = smem_u32(Y + ((lane & 7) + ((lane >> 4) << 3)) * ldy +
                               ((lane >> 3) & 1) * 8);
#pragma unroll
  for (int kk = 0; kk < W; kk += 16) {
    uint32_t a[TA][4];
    a_frag(a, X, ldx, kk, lane);
    if constexpr (TA == 1 && TB == 1) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t y[4];
        ldsm_x4(y, ya + (j * 8 * ldy + kk) * 2);
        mma_bf16(acc[j], a[0], y[0], y[1]);
        mma_bf16(acc[j + 1], a[0], y[2], y[3]);
      }
    } else {
      constexpr int G = GROUP<NT>;
#pragma unroll
      for (int j = 0; j < NT; j += G) {
        uint32_t b[G][TB][2];
#pragma unroll
        for (int p = 0; p < G; p += 2)
#pragma unroll
          for (int i = 0; i < TB; ++i) {
            uint32_t y[4];
            ldsm_x4(y, ya + (i * plane + (j + p) * 8 * ldy + kk) * 2);
            b[p][i][0] = y[0], b[p][i][1] = y[1];
            b[p + 1][i][0] = y[2], b[p + 1][i][1] = y[3];
          }
        mma_group(acc, j, a, b);
      }
    }
  }
}

// pv: acc[j] += A . Z[:, 8j..8j+7] for j < NT, A the warp's 16 x K f32
// tile as `qk` left it (c[i] the C fragment of columns 8i..8i+7), in PT
// bf16 terms; Z K rows of a walked tile's TB planes (row stride ldz from
// its first column, planes `plane` apart); each step of 16 rows promoted
// to acc on its own (mma_group)
template <int K, int NT, int TB>
__device__ __forceinline__ void pv(float (&acc)[NT][4],
                                   const float (&c)[K / 8][4], const bf16* Z,
                                   int ldz, int plane, int lane) {
  static_assert(NT % 2 == 0, "n8 tiles in pairs");
  const uint32_t za = smem_u32(Z + (lane & 15) * ldz + (lane >> 4) * 8);
#pragma unroll
  for (int s = 0; s < K / 16; ++s) {
    uint32_t a[PT][4];
    put_terms(a, 0, c[2 * s][0], c[2 * s][1]);
    put_terms(a, 1, c[2 * s][2], c[2 * s][3]);
    put_terms(a, 2, c[2 * s + 1][0], c[2 * s + 1][1]);
    put_terms(a, 3, c[2 * s + 1][2], c[2 * s + 1][3]);
    constexpr int G = GROUP<NT>;
#pragma unroll
    for (int j = 0; j < NT; j += G) {
      uint32_t b[G][TB][2];
#pragma unroll
      for (int p = 0; p < G; p += 2)
#pragma unroll
        for (int i = 0; i < TB; ++i) {
          uint32_t z[4];
          ldsm_x4_t(z, za + (i * plane + 16 * s * ldz + 8 * (j + p)) * 2);
          b[p][i][0] = z[0], b[p][i][1] = z[1];
          b[p + 1][i][0] = z[2], b[p + 1][i][1] = z[3];
        }
      mma_group(acc, j, a, b);
    }
  }
}

// A walked f32 tile's N rows of W values (row stride W + 4 at src) as PT
// bf16 planes at dst (row stride W + 8, planes `plane` apart), once for
// the block's four warps
template <int W, int N>
__device__ __forceinline__ void to_planes(bf16* dst, int plane,
                                          const float* src) {
  constexpr int CH = W / 8;
  for (int idx = threadIdx.x; idx < N * CH; idx += THREADS) {
    const int i = idx / CH, c = idx - i * CH;
    const float* x = src + i * (W + 4) + 8 * c;
    const float4 x0 = *reinterpret_cast<const float4*>(x);
    const float4 x1 = *reinterpret_cast<const float4*>(x + 4);
    uint32_t t[4][PT];
    split_pack<PT>(x0.x, x0.y, t[0]);
    split_pack<PT>(x0.z, x0.w, t[1]);
    split_pack<PT>(x1.x, x1.y, t[2]);
    split_pack<PT>(x1.z, x1.w, t[3]);
#pragma unroll
    for (int p = 0; p < PT; ++p)
      *reinterpret_cast<uint4*>(dst + p * plane + i * (W + 8) + 8 * c) =
          make_uint4(t[0][p], t[1][p], t[2][p], t[3][p]);
  }
}

// ---- small helpers ----------------------------------------------------------

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// rows r0 and r0 + 8 (those below n) of a warp's accumulator of NT n8
// tiles, times `scale`, to dst + row * stride + col
template <typename E, int NT>
__device__ __forceinline__ void store_acc(E* dst, long long stride,
                                          const float (&acc)[NT][4], int r0,
                                          int n, int t, float scale) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + 8 * hf;
    if (r < n)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        store2(dst + r * stride + 8 * j + 2 * t, scale * acc[j][2 * hf],
               scale * acc[j][2 * hf + 1]);
  }
}

__device__ __forceinline__ bool live(int qpos, int kpos, int window,
                                     bool causal) {
  return (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
}

// ---- (a) dQ and the row statistics --------------------------------------

// D[r] = dO_r . O_r for rows r < n_rows of the block's 64 (row r at
// elements row0 + r * stride), two threads a row reading 16 bytes at a
// time; 0 past n_rows
template <typename E, int HD_V>
__device__ __forceinline__ void row_dots(float* D, const E* dout,
                                         const E* out, long long row0,
                                         long long stride, int n_rows) {
  constexpr int VEC = 16 / sizeof(E), CH = HD_V / VEC;
  const int r = threadIdx.x >> 1;
  float x = 0.f;
  if (r < n_rows) {
    const long long at = row0 + r * stride;
    for (int c = threadIdx.x & 1; c < CH; c += 2) {
      float f[VEC], o[VEC];
      paged_attn::unpack(*reinterpret_cast<const uint4*>(dout + at + c * VEC),
                         f, dout);
      paged_attn::unpack(*reinterpret_cast<const uint4*>(out + at + c * VEC),
                         o, out);
#pragma unroll
      for (int i = 0; i < VEC; ++i) x += f[i] * o[i];
    }
  }
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  if ((threadIdx.x & 1) == 0) D[r] = x;
}

// Loop 1's step over one key tile: the scores x = s * c2 (log2 units,
// NEG_INF where masked) into each row's running max m and a lane's share
// of its sum l.  FULL: every pair of the tile is live.
template <bool FULL, int NT, typename Ok>
__device__ __forceinline__ void stats_step(float (&sc)[NT][4], float (&m)[2],
                                           float (&l)[2], float c2, Ok&& ok,
                                           int r0, int k0, int t4) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hf = e >> 1;
      const float x =
          FULL || ok(r0 + 8 * hf, k0 + 8 * j + 2 * t4 + (e & 1))
              ? sc[j][e] * c2
              : NEG_INF;
      sc[j][e] = x;
      mx[hf] = fmaxf(mx[hf], x);
    }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float m_new = fmaxf(m[hf], quad_max(mx[hf]));
    l[hf] *= fast_exp2(m[hf] - m_new);
    m[hf] = m_new;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hf = e >> 1;
      if (FULL || sc[j][e] != NEG_INF) l[hf] += fast_exp2(sc[j][e] - m[hf]);
    }
}

// Loop 2's step: dS = P (dP - D) into sc, 0 where masked
template <bool FULL, int NT, typename Ok>
__device__ __forceinline__ void ds_step(float (&sc)[NT][4],
                                        const float (&dp)[NT][4],
                                        const float (&m)[2],
                                        const float (&il)[2],
                                        const float (&D)[2], float c2,
                                        Ok&& ok, int r0, int k0, int t4) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hf = e >> 1;
      const float p = fast_exp2(sc[j][e] * c2 - m[hf]) * il[hf];
      sc[j][e] = FULL || ok(r0 + 8 * hf, k0 + 8 * j + 2 * t4 + (e & 1))
                     ? p * (dp[j][e] - D[hf])
                     : 0.f;
    }
}

template <typename E, int HD, int HD_V>
__global__ void __launch_bounds__(THREADS) dq_kernel(const Args<E> a) {
  using C = Cfg<E, HD, HD_V>;
  constexpr int BT = C::BT, NT = BT / 8, TB = C::TERMS;
  extern __shared__ float4 smem4[];
  __shared__ float D_s[ROWS];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
  E* Qs = reinterpret_cast<E*>(base);
  E* dOs = Qs + ROWS * C::RK;
  auto stage = [&](int s) {
    return reinterpret_cast<E*>(base + C::RES + s * C::STAGE);
  };
  bf16* planes = reinterpret_cast<bf16*>(base + C::RES +
                                         C::STAGES * C::STAGE);
  // the walked K (and V) rows as the products read them
  auto operand = [&](int s) -> const bf16* {
    if constexpr (C::F32) return planes;
    else return reinterpret_cast<const bf16*>(stage(s));
  };

  const bool causal = a.causal != 0;
  const int n_tiles = (a.sq + ROWS - 1) / ROWS;
  const int part = blockIdx.x % C::Q_PARTS;
  // the last query tiles, which see the most keys, first
  const int q0 = (n_tiles - 1 - (int)blockIdx.x / C::Q_PARTS) * ROWS;
  const int hh = blockIdx.y, bi = blockIdx.z;
  const int g = hh / (a.h / a.kvh), n_q = min(ROWS, a.sq - q0);
  const int len = min(a.kv_len[bi], a.skv);
  const long long qrow = ((long long)bi * a.sq + q0) * a.h + hh;
  const long long krow = (long long)bi * a.skv * a.kvh + g;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * warp + (lane >> 2), t4 = lane & 3;
  const float c2 = a.scale * LOG2E;

  copy_rows<E, HD, ROWS, C::RK>(Qs, a.q + qrow * HD, (long long)a.h * HD,
                                n_q);
  copy_rows<E, HD_V, ROWS, C::RV>(dOs, a.dout + qrow * HD_V,
                                  (long long)a.h * HD_V, n_q);
  cp_async_commit();
  // D of row r lands from threads 2r and 2r + 1: the warp owning row r
  row_dots<E, HD_V>(D_s, a.dout, a.out, qrow * HD_V, (long long)a.h * HD_V,
                    n_q);
  __syncwarp();
  const float D_r[2] = {D_s[r0], D_s[r0 + 8]};

  // the live keys of the tile's rows: [k_lo, k_hi); rows at or past n_q
  // read zeros and are never stored, so they need no mask
  const int p_lo = a.q_offset + q0, p_hi = p_lo + n_q - 1;
  const int k_lo = a.window > 0 ? max(0, p_lo - a.window + 1) : 0;
  const int k_hi = causal ? min(len, p_hi + 1) : len;
  const int n_kt = k_hi > k_lo ? (k_hi - k_lo + BT - 1) / BT : 0;
  auto ok = [&](int r, int key) {
    return key < k_hi && live(p_lo + r, key, a.window, causal);
  };
  auto full = [&](int k0) {
    return k0 + BT <= k_hi && (!causal || k0 + BT - 1 <= p_lo) &&
           (a.window <= 0 || k0 > p_hi - a.window);
  };
  const E* Qw = Qs + 16 * warp * C::RK;
  const E* dOw = dOs + 16 * warp * C::RV;

  // loop 1: each row's max and sum (a lane sums its columns; the four
  // lanes of a row share the max and add their sums at the end)
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  walk<C::STAGES>(
      n_kt,
      [&](int t, int s) {
        const int k0 = k_lo + t * BT;
        copy_rows<E, HD, BT, C::WK>(
            stage(s), a.k + (krow + (long long)k0 * a.kvh) * HD,
            (long long)a.kvh * HD, k_hi - k0);
      },
      [&](int t, int s) {
        const int k0 = k_lo + t * BT;
        if constexpr (C::F32) {
          to_planes<HD, BT>(planes, C::PLANE,
                            reinterpret_cast<const float*>(stage(s)));
          __syncthreads();
        }
        float sc[NT][4] = {};
        qk<HD, NT, TB>(sc, Qw, C::RK, operand(s), C::PK, C::PLANE, lane);
        if (full(k0))
          stats_step<true>(sc, m_r, l_r, c2, ok, r0, k0, t4);
        else
          stats_step<false>(sc, m_r, l_r, c2, ok, r0, k0, t4);
      });
  float il_r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float l = quad_sum(l_r[hf]);
    il_r[hf] = l > 0.f ? 1.f / l : 0.f;
    const int r = r0 + 8 * hf;
    if (part == 0 && t4 == 0 && r < n_q) {
      const long long at = ((long long)bi * a.h + hh) * a.sq + q0 + r;
      const long long plane = (long long)a.b * a.h * a.sq;
      a.stats[at] = m_r[hf];
      a.stats[plane + at] = il_r[hf];
      a.stats[2 * plane + at] = D_r[hf];
    }
  }

  // loop 2: S, dP, dS and dQ += dS K over this block's CK columns
  constexpr int NQ = C::CK / 8;
  const int c0 = part * C::CK;
  float acc[NQ][4] = {};
  walk<C::STAGES>(
      n_kt,
      [&](int t, int s) {
        const int k0 = k_lo + t * BT;
        const long long at = krow + (long long)k0 * a.kvh;
        copy_rows<E, HD, BT, C::WK>(stage(s), a.k + at * HD,
                                    (long long)a.kvh * HD, k_hi - k0);
        copy_rows<E, HD_V, BT, C::WV>(stage(s) + BT * C::WK, a.v + at * HD_V,
                                      (long long)a.kvh * HD_V, k_hi - k0);
      },
      [&](int t, int s) {
        const int k0 = k_lo + t * BT;
        if constexpr (C::F32) {
          const float* src = reinterpret_cast<const float*>(stage(s));
          to_planes<HD, BT>(planes, C::PLANE, src);
          to_planes<HD_V, BT>(planes + BT * C::PK, C::PLANE,
                              src + BT * C::WK);
          __syncthreads();
        }
        const bf16* Kt = operand(s);
        float sc[NT][4] = {}, dp[NT][4] = {};
        qk<HD, NT, TB>(sc, Qw, C::RK, Kt, C::PK, C::PLANE, lane);
        qk<HD_V, NT, TB>(dp, dOw, C::RV, Kt + BT * C::PK, C::PV, C::PLANE,
                         lane);
        if (full(k0))
          ds_step<true>(sc, dp, m_r, il_r, D_r, c2, ok, r0, k0, t4);
        else
          ds_step<false>(sc, dp, m_r, il_r, D_r, c2, ok, r0, k0, t4);
        pv<BT, NQ, TB>(acc, sc, Kt + c0, C::PK, C::PLANE, lane);
      });
  store_acc<E, NQ>(a.dq + qrow * HD + c0, (long long)a.h * HD, acc, r0,
                   n_q, t4, a.scale);
}

// ---- (b) dK and dV --------------------------------------------------------

// The transposed step: P^T into sc and, for dK, dS^T into dp, 0 where
// masked; st: the tile's m, 1/l and D by query
template <bool FULL, bool DK, int NT, int BT, typename Ok>
__device__ __forceinline__ void pds_step(float (&sc)[NT][4], float (&dp)[NT][4],
                                         const float* st, float c2, Ok&& ok,
                                         int r0, int t4) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = 8 * j + 2 * t4;
    const float2 m = *reinterpret_cast<const float2*>(st + c);
    const float2 il = *reinterpret_cast<const float2*>(st + BT + c);
    float2 D;
    if constexpr (DK) D = *reinterpret_cast<const float2*>(st + 2 * BT + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool y = e & 1;
      const bool on = FULL || ok(r0 + 8 * (e >> 1), c + y);
      const float p =
          on ? fast_exp2(sc[j][e] * c2 - (y ? m.y : m.x)) * (y ? il.y : il.x)
             : 0.f;
      sc[j][e] = p;
      if constexpr (DK) dp[j][e] = p * (dp[j][e] - (y ? D.y : D.x));
    }
  }
}

// One block's share: dV's columns [cv0, cv0 + 8 NCV) if NCV > 0 and
// dK's [ck0, ck0 + 8 NCK) if NCK > 0.  Rows at or past i_hi of a query
// tile read zeros, their stats too, so their P is 0 with no mask.
template <typename E, int HD, int HD_V, int NCV, int NCK>
__device__ __forceinline__ void dkdv_body(const Args<E>& a,
                                          unsigned char* base, int cv0,
                                          int ck0) {
  using C = Cfg<E, HD, HD_V>;
  constexpr int BT = C::BT, NT = BT / 8, TB = C::TERMS;
  constexpr bool DV = NCV > 0, DK = NCK > 0;
  E* Ks = reinterpret_cast<E*>(base);
  E* Vs = Ks + ROWS * C::RK;
  auto stage = [&](int s) {
    return reinterpret_cast<E*>(base + C::RES + s * C::STAGE);
  };
  auto stat = [&](int s) {
    return reinterpret_cast<const float*>(base + C::RES + s * C::STAGE +
                                          BT * (C::WK + C::WV) * C::ES);
  };
  bf16* planes = reinterpret_cast<bf16*>(base + C::RES +
                                         C::STAGES * C::STAGE);
  auto operand = [&](int s) -> const bf16* {
    if constexpr (C::F32) return planes;
    else return reinterpret_cast<const bf16*>(stage(s));
  };

  const bool causal = a.causal != 0;
  const int kb = (blockIdx.x / C::KV_PARTS) * ROWS;
  const int g = blockIdx.y, bi = blockIdx.z, rep = a.h / a.kvh;
  const int n_k = min(ROWS, a.skv - kb);
  const int len = min(a.kv_len[bi], a.skv);
  const int k_end = min(kb + ROWS, len);   // live keys [kb, k_end)
  const long long krow = ((long long)bi * a.skv + kb) * a.kvh + g;
  const long long plane = (long long)a.b * a.h * a.sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * warp + (lane >> 2), t4 = lane & 3;
  const float c2 = a.scale * LOG2E;

  copy_rows<E, HD, ROWS, C::RK>(Ks, a.k + krow * HD, (long long)a.kvh * HD,
                                k_end - kb);
  if constexpr (DK)
    copy_rows<E, HD_V, ROWS, C::RV>(Vs, a.v + krow * HD_V,
                                    (long long)a.kvh * HD_V, k_end - kb);
  cp_async_commit();
  // the query positions that can see a key of the tile: [i_lo, i_hi),
  // walked in tiles of BT from i_lo rounded down
  int i_lo = causal ? max(0, kb - a.q_offset) : 0;
  i_lo -= i_lo % BT;
  const int i_hi = a.window > 0
                       ? min(a.sq, k_end - 1 + a.window - a.q_offset)
                       : a.sq;
  const int n_qt =
      k_end > kb && i_hi > i_lo ? (i_hi - i_lo + BT - 1) / BT : 0;
  const E* Kw = Ks + 16 * warp * C::RK;
  const E* Vw = Vs + 16 * warp * C::RV;

  float acc_v[DV ? NCV : 1][4] = {}, acc_k[DK ? NCK : 1][4] = {};
  walk<C::STAGES>(
      rep * n_qt,
      [&](int t, int s) {
        const int hh = g * rep + t / n_qt, q0 = i_lo + (t % n_qt) * BT;
        const long long qrow = ((long long)bi * a.sq + q0) * a.h + hh;
        E* Qt = stage(s);
        copy_rows<E, HD, BT, C::WK>(Qt, a.q + qrow * HD, (long long)a.h * HD,
                                    i_hi - q0);
        copy_rows<E, HD_V, BT, C::WV>(Qt + BT * C::WK, a.dout + qrow * HD_V,
                                      (long long)a.h * HD_V, i_hi - q0);
        const long long at = ((long long)bi * a.h + hh) * a.sq + q0;
        float* st = const_cast<float*>(stat(s));
        for (int idx = threadIdx.x; idx < 3 * BT; idx += THREADS) {
          const int pl = idx / BT, i = idx - pl * BT;
          const bool on = q0 + i < i_hi;
          cp_async4(smem_u32(st + idx),
                    a.stats + pl * plane + at + (on ? i : 0), on);
        }
      },
      [&](int t, int s) {
        const int q0 = i_lo + (t % n_qt) * BT;
        if constexpr (C::F32) {
          const float* src = reinterpret_cast<const float*>(stage(s));
          to_planes<HD, BT>(planes, C::PLANE, src);
          to_planes<HD_V, BT>(planes + BT * C::PK, C::PLANE,
                              src + BT * C::WK);
          __syncthreads();
        }
        const bf16* Qt = operand(s);
        const bf16* dOt = Qt + BT * C::PK;
        float sc[NT][4] = {}, dp[NT][4] = {};
        qk<HD, NT, TB>(sc, Kw, C::RK, Qt, C::PK, C::PLANE, lane);  // S^T
        if constexpr (DK)                                         // dP^T
          qk<HD_V, NT, TB>(dp, Vw, C::RV, dOt, C::PV, C::PLANE, lane);
        auto ok = [&](int r, int i) {
          const int key = kb + r;
          return key < k_end && live(a.q_offset + q0 + i, key, a.window,
                                     causal);
        };
        const bool full =
            k_end == kb + ROWS &&
            (!causal || kb + ROWS - 1 <= a.q_offset + q0) &&
            (a.window <= 0 || kb > a.q_offset + q0 + BT - 1 - a.window);
        if (full)
          pds_step<true, DK, NT, BT>(sc, dp, stat(s), c2, ok, r0, t4);
        else
          pds_step<false, DK, NT, BT>(sc, dp, stat(s), c2, ok, r0, t4);
        if constexpr (DV)
          pv<BT, NCV, TB>(acc_v, sc, dOt + cv0, C::PV, C::PLANE, lane);
        if constexpr (DK)
          pv<BT, NCK, TB>(acc_k, dp, Qt + ck0, C::PK, C::PLANE, lane);
      });
  if constexpr (DV)
    store_acc<E, NCV>(a.dv + krow * HD_V + cv0, (long long)a.kvh * HD_V,
                      acc_v, r0, n_k, t4, 1.f);
  if constexpr (DK)
    store_acc<E, NCK>(a.dk + krow * HD + ck0, (long long)a.kvh * HD, acc_k,
                      r0, n_k, t4, a.scale);
}

template <typename E, int HD, int HD_V>
__global__ void __launch_bounds__(THREADS) dkdv_kernel(const Args<E> a) {
  using C = Cfg<E, HD, HD_V>;
  extern __shared__ float4 smem4[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
  const int part = blockIdx.x % C::KV_PARTS;
  if constexpr (C::FUSED)
    dkdv_body<E, HD, HD_V, HD_V / 8, HD / 8>(a, base, 0, 0);
  else if (part < C::V_PARTS)
    dkdv_body<E, HD, HD_V, C::CV / 8, 0>(a, base, part * C::CV, 0);
  else
    dkdv_body<E, HD, HD_V, 0, C::CK / 8>(a, base, 0,
                                         (part - C::V_PARTS) * C::CK);
}

template <typename E, int HD, int HD_V>
int launch(const long long* args, float scale, cudaStream_t stream) {
  using C = Cfg<E, HD, HD_V>;
  // the wrapper's plan (bwd_plan.py): rows, tile, stages, dQ and dK/dV
  // parts, shared-memory bytes
  if (args[21] != ROWS || args[22] != C::BT || args[23] != C::STAGES ||
      args[24] != C::Q_PARTS || args[25] != C::KV_PARTS ||
      args[26] != C::SMEM)
    return PLAN_MISMATCH;
  Args<E> a;
  a.q = reinterpret_cast<const E*>(args[0]);
  a.k = reinterpret_cast<const E*>(args[1]);
  a.v = reinterpret_cast<const E*>(args[2]);
  a.out = reinterpret_cast<const E*>(args[3]);
  a.dout = reinterpret_cast<const E*>(args[4]);
  a.kv_len = reinterpret_cast<const int*>(args[5]);
  a.dq = reinterpret_cast<E*>(args[6]);
  a.dk = reinterpret_cast<E*>(args[7]);
  a.dv = reinterpret_cast<E*>(args[8]);
  a.stats = reinterpret_cast<float*>(args[9]);
  a.b = (int)args[10];
  a.q_offset = (int)args[11];
  a.sq = (int)args[12];
  a.skv = (int)args[13];
  a.h = (int)args[14];
  a.kvh = (int)args[15];
  a.window = (int)args[18];
  a.causal = (int)args[19];
  a.scale = scale;
  static unsigned set_dq = 0, set_dkdv = 0;
  cudaError_t err =
      paged_attn::allow_max_smem(dq_kernel<E, HD, HD_V>, &set_dq);
  if (err == cudaSuccess)
    err = paged_attn::allow_max_smem(dkdv_kernel<E, HD, HD_V>, &set_dkdv);
  if (err != cudaSuccess) return (int)err;
  dq_kernel<E, HD, HD_V><<<dim3((a.sq + ROWS - 1) / ROWS * C::Q_PARTS, a.h,
                                a.b),
                           THREADS, C::SMEM, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv_kernel<E, HD, HD_V><<<dim3((a.skv + ROWS - 1) / ROWS * C::KV_PARTS,
                                  a.kvh, a.b),
                             THREADS, C::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename E>
int with_widths(const long long* args, float scale, cudaStream_t stream) {
  const int hd = (int)args[16], hd_v = (int)args[17];
  if (hd == 32 && hd_v == 32) return launch<E, 32, 32>(args, scale, stream);
  if (hd == 64 && hd_v == 64) return launch<E, 64, 64>(args, scale, stream);
  if (hd == 80 && hd_v == 64) return launch<E, 80, 64>(args, scale, stream);
  if (hd == 128 && hd_v == 128)
    return launch<E, 128, 128>(args, scale, stream);
  if (hd == 192 && hd_v == 128)
    return launch<E, 192, 128>(args, scale, stream);
  if (hd == 256 && hd_v == 256)
    return launch<E, 256, 256>(args, scale, stream);
  return NO_WIDTHS;
}

}  // namespace

// One backward, its two launches on `stream`, the arguments packed as
// 64-bit integers, in order: q, k, v, out, dout, kv_len, dq, dk, dv,
// stats (3 * b * h * sq floats of scratch), b, q_offset, sq, skv, h, kvh,
// hd, hd_v, window, causal, dtype (0 = float32, 1 = bfloat16), then the
// plan: rows, tile, stages, dQ parts, dK/dV parts, shared-memory bytes.
// Every tensor is contiguous; q, k, v, out, dout and the gradients are
// 16-byte aligned and share the dtype.  Returns the cudaError_t of the
// launches (0 on success), NO_WIDTHS for head widths without an
// instantiation, or PLAN_MISMATCH.
extern "C" int chunked_prefill_attention_bwd_launch(const long long* args,
                                                    float scale,
                                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (args[20] == 0) return with_widths<float>(args, scale, s);
  if (args[20] == 1) return with_widths<bf16>(args, scale, s);
  return (int)cudaErrorInvalidValue;
}
