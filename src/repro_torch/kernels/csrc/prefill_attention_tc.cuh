// Tensor-core device body of the two prefill-attention kernels for bf16
// inputs: the paged one (paged_prefill_attention.cu) and the dense one
// (chunked_prefill_attention.cu, which views a request's cache as
// one-token pages under the identity table).  f32 inputs keep the
// CUDA-core body `attend` of paged_attention.cuh.
//
// It computes what `attend` computes: the same live slots [p_lo, p_hi),
// the same length, causal and window masks, finite NEG_INF and division
// by max(l, 1e-20), and 0 for a row that never meets a key it may
// attend.  The design, for the H100's tensor cores:
//
//   rows       a block holds R = n_q * rep query rows of one KV head g
//              (row = qi * rep + r, as in attend) in one or two
//              warpgroups of 64 rows; the Q rows stay in shared memory
//              and each warp reads its 16 rows' fragments for every tile
//              (ldmatrix), a group of up to 8 k-steps at a time
//   K/V ring   the keys [p_lo * page, min(kv_len, p_hi * page)) in tiles
//              of 64, STAGES tiles in shared memory, filled by one copy
//              warp through 16-byte cp.async.cg copies, each key's
//              source read through the block table (the paged gather);
//              keys past the live range are zero-filled (src-size 0),
//              never read.  mbarriers hand the stages between the copy
//              warp and the consumer warps, so the loads never stand in
//              the MMAs' way.  Tiles stay bf16, in the 128-byte (64-byte
//              for widths of 32) swizzled layout wgmma reads
//   scores     S = Q K^T as wgmma m64n64k16 (Q from registers, K from
//              shared memory, f32 sums); S stays in the accumulator
//              fragments
//   softmax    in registers, in log2 units (ex2.approx after a log2(e)
//              prescale): row max over the quad by two shuffles, corr
//              rescales the output fragments; masks are applied only on
//              tiles that cross kv_len, the diagonal or the window edge
//              for this warp's rows
//   PV         O += P V as wgmma m64n{hd_v}k16: P packed to bf16 straight
//              from the score fragments into the A registers, V read
//              MN-major from shared memory
//   splits     where the grid would leave SMs idle (few segments, few
//              KV heads), each block's live tiles are split in shares
//              walked by blocks of their own, which write their partial
//              softmax state (m, l, unnormalised sums) for a second,
//              elementwise launch to combine (combine_kernel)
//
// The grid walks q tiles last first, so the longest causal walks start
// first.
//
// A row masked over a whole tile while its running max is still NEG_INF
// takes p = exp2(0) = 1 there; a later tile's corr = exp2(-1e30 - m)
// zeroes that garbage exactly, and a row whose max stays NEG_INF writes
// 0, as in attend.
//
// Head width 256 (hd = hd_v = 256, RecurrentGemma's local attention):
// a consumer thread's f32 output tile of its 16 rows is 128 registers
// before the scores, so such a block keeps one warpgroup of 64 rows (160
// threads, launch-bounded to the 255 registers a thread may hold); its
// Q K^T reads Q fragments 4 k-steps at a time (16 registers, not 64),
// and its PV runs as two m64n128k16 halves of the V width.  The tiles
// keep the 128-byte swizzle: a 256-wide row is four 64-value chunk rows,
// as a 128-wide one is two.  Shared memory: the Q rows (64 x 264 bf16,
// 33 KB) and two stages of 64 keys x (256 + 256) bf16 (128 KB).
//
// Head widths hd 192, hd_v 128 (MLA decompressed for the dense prefill:
// 128 nope + 64 RoPE key dims, 128 value dims; DeepSeek-V2 is then rep 1
// over its 128 heads, 128-row blocks).  Swizzle: a 192-wide K row is
// three 64-value chunk rows under the 128-byte swizzle, so the copy
// warp's 24 pieces a key land at chunk rows kc = c / 8 of TILE keys, and
// k-step kk's descriptor starts at chunk row kk * 16 / 64, byte (kk * 16
// % 64) * 2 inside it, with the stride offset 8 * 128 of every width;
// no descriptor crosses a chunk row, so the three chunks need nothing
// the two of hd 128 do not.  Registers: the output tile at hd_v 128 is
// 64 a thread, as at (128, 128); Q K^T is 12 k16 steps, read as 3
// groups of 4 (16 registers of Q fragments, fewer than the 32 of hd
// 128's one group of 8).  Shared memory at two warpgroups: the Q rows
// 128 x (192 + 8) bf16 = 51,200 bytes, two stages of 64 keys x (192 +
// 128) bf16 = 81,920, in 134,176 bytes with the alignment and the
// barriers: one block an SM.
//
// Numerics: products are exact in the f32 accumulators and only the
// summation order differs from attend; P is rounded to bf16 before PV
// (at most 2^-9 of each weight).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "paged_attention.cuh"

namespace prefill_tc {

using bf16 = __nv_bfloat16;
using paged_attn::NEG_INF;

constexpr int TILE = 64;        // keys a K/V tile
constexpr int QPAD = 8;         // bf16 of padding a shared-memory Q row
constexpr int MAX_WARPS = 8;    // two consumer warpgroups: 128 query rows
constexpr int THREADS_MAX = 32 * (MAX_WARPS + 1);   // and the copy warp

// The most threads a block of widths (HD, HD_V) may have: one consumer
// warpgroup and the copy warp at hd_v 256 (see the note above), else
// THREADS_MAX.  The kernels' launch bounds.
template <int HD, int HD_V>
constexpr int max_threads() {
  return HD_V > 128 ? 32 * (4 + 1) : THREADS_MAX;
}
constexpr float LOG2E = 1.4426950408889634f;

// A K or V tile of TILE keys of width W in the swizzled layout wgmma
// reads: W splits in chunks of CW = min(W, 64) values (four at W = 256);
// chunk kc of key t
// is the RB = 2 * CW byte row kc * TILE + t, and its 16-byte pieces are
// XOR-permuted within each 8-row group (the 128-byte swizzle; 64-byte
// for W = 32), which also keeps the copies free of bank conflicts.
template <int W>
struct Swizzled {
  static constexpr int CW = W < 64 ? W : 64;
  static constexpr int RB = 2 * CW;                 // bytes a row
  static constexpr int BYTES = TILE * W * 2;
  static constexpr uint64_t MODE = RB == 128 ? 1 : 2;   // 128B / 64B
  // byte offset of 16-byte piece c (0 .. W / 8) of key t
  __device__ __forceinline__ static uint32_t offset(int t, int c) {
    const int kc = c / (CW / 8), cc = c % (CW / 8);
    const int sw = RB == 128 ? (t & 7) : ((t >> 1) & 3);
    return (kc * TILE + t) * RB + ((cc ^ sw) << 4);
  }
};

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets, swizzle mode (PTX ISA, "matrix descriptor")
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | mode << 62;
}

// The block's shared memory: up to 1 KB to align the start, the Q rows
// (16 a consumer warp, padded for ldmatrix), STAGES K/V tiles, each
// 1 KB-aligned as the swizzle needs, then a "full" and an "empty"
// mbarrier a stage.  Two stages where K + V rows are 256 wide (hd 128):
// a third would cost a 64-row block its second resident block.
template <int HD, int HD_V>
struct Layout {
  static constexpr int STAGES = HD + HD_V >= 256 ? 2 : 3;
  static constexpr int QS = HD + QPAD;      // Q row stride, elements
  static constexpr int STAGE = Swizzled<HD>::BYTES + Swizzled<HD_V>::BYTES;
  __host__ __device__ static constexpr size_t q_bytes(int warps) {
    return ((size_t)warps * 16 * QS * 2 + 1023) / 1024 * 1024;
  }
  __host__ __device__ static constexpr size_t smem_bytes(int warps) {
    return 1024 + q_bytes(warps) + (size_t)STAGES * STAGE + 16 * STAGES;
  }
};

using paged_attn::cp_async16;
using paged_attn::smem_u32;
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// arrive on the mbarrier at bar once every earlier cp.async of this
// thread has landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// wait for the phase of parity `parity` of the mbarrier at bar to end
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// make shared memory written through the generic proxy (cp.async)
// visible to wgmma, which reads it through the async proxy
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile(
      "wgmma.commit_group.sync.aligned;\n"
      "wgmma.wait_group.sync.aligned 0;\n" ::
          : "memory");
}
// keep the compiler from moving an accumulator across the asynchronous
// wgmma that writes it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (m64n32, f32) = (scale_d ? d : 0) + a (m64k16 bf16, registers) *
// B (k16n32 bf16, shared memory at desc_b; trans_b: B is MN-major)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n32(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
        "n"(TRANS_B));
}

// d (m64n64, f32) = (scale_d ? d : 0) + a (m64k16 bf16, registers) *
// B (k16n64 bf16, shared memory at desc_b; trans_b: B is MN-major)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
        "n"(TRANS_B));
}

// d (m64n128, f32) = (scale_d ? d : 0) + a (m64k16 bf16, registers) *
// B (k16n128 bf16, shared memory at desc_b; trans_b: B is MN-major)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
        "n"(TRANS_B));
}

template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma(float (&d)[N / 2],
                                      const uint32_t (&a)[4],
                                      uint64_t desc_b) {
  if constexpr (N == 32) wgmma_n32<TRANS_B>(d, a, desc_b, 1);
  if constexpr (N == 64) wgmma_n64<TRANS_B>(d, a, desc_b, 1);
  if constexpr (N == 128) wgmma_n128<TRANS_B>(d, a, desc_b, 1);
}

// two f32 -> one register of two bf16 (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

using paged_attn::fast_exp2;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Where a block finds key k of KV head g: pool + ((page_id * page + k %
// page) * kvh + g) * W, page_id = bt[k / page], or k / page under the
// identity table (bt null).  Pages of a power of two take shifts.
struct KeyMap {
  const int* __restrict__ bt;
  int page, shift, kvh, g;    // shift < 0: page is no power of two

  __device__ __forceinline__ int slot(int k) const {
    return shift >= 0 ? k >> shift : k / page;
  }
  __device__ __forceinline__ long long row(int k, int s) const {
    const long long pid = bt != nullptr ? __ldg(bt + s) : s;
    return (pid * page + (k - s * page)) * kvh + g;
  }
};

// The copy warp's share of the keys [k0, k0 + TILE) at width W into the
// swizzled tile at shared address dst: lane l copies keys l and l + 32,
// each whole (one table read a key); keys at or past k_end are
// zero-filled.
template <int W>
__device__ __forceinline__ void copy_rows(const bf16* __restrict__ pool,
                                         uint32_t dst,
                                         const long long (&row)[2],
                                         int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const bf16* src = row[j] >= 0 ? pool + row[j] * W : pool;
#pragma unroll
    for (int c = 0; c < W / 8; ++c)
      cp_async16(dst + Swizzled<W>::offset(lane + 32 * j, c),
                 row[j] >= 0 ? src + c * 8 : pool, row[j] >= 0);
  }
}

// q_base / out_base point at (segment, first query of the block, head
// 0), n_q of its query positions exist, q_pos0 is the first one's
// absolute position, bt the segment's block-table row or nullptr.
// blockDim.x is 32 * (warps + 1): `warps` consumer warps, 4 per 64 rows
// (ceil(block_q * rep / 64) warpgroups), then one copy warp.  The copy
// warp runs ahead through the ring: it fills stage s once the consumers
// have released it ("empty" barrier) and has each lane signal the
// "full" barrier when its copies land; the consumers wait for "full",
// compute, and release.  No block-wide barrier inside the walk, so the
// loads never stand on the MMAs' path and the two warpgroups drift
// apart.  A warpgroup past the rows computes on zero rows and writes
// nothing.
//
// With splits > 1 the block walks only split `split` of its live tiles
// (split s of n gets tiles [s * ceil(n / splits), ...)) and writes, in
// place of its output, each row's partial state to part (laid out as
// out_base, a record of HD_V + 2 floats a row: m in log2 units, l, then
// the HD_V unnormalised sums) for combine_kernel.
template <int HD, int HD_V>
__device__ __forceinline__ void attend(
    const bf16* __restrict__ q_base, const bf16* __restrict__ k_pool,
    const bf16* __restrict__ v_pool, const int* __restrict__ bt,
    bf16* __restrict__ out_base, float* __restrict__ part, int n_q,
    int q_pos0, int kv_len, bool causal, int window, int h, int kvh, int g,
    int page, int n_slots, int split, int splits, float scale) {
  using L = Layout<HD, HD_V>;
  using SK = Swizzled<HD>;
  using SV = Swizzled<HD_V>;
  static_assert(HD % 16 == 0 && HD_V % 16 == 0, "widths of 16");
  constexpr int STAGES = L::STAGES;
  constexpr int KT = HD / 16;     // k16 steps of Q K^T
  constexpr int KG = KT > 8 ? 4 : KT;   // k-steps a group of Q fragments
  constexpr int NS = TILE / 8;    // n8 score tiles a key tile
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int warps = (blockDim.x >> 5) - 1;          // consumer warps
  const uint32_t base = (smem_u32(smem_tc) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t ring = base + (uint32_t)L::q_bytes(warps);
  const uint32_t full = ring + STAGES * L::STAGE;   // STAGES mbarriers
  const uint32_t empty = full + 8 * STAGES;         // STAGES mbarriers
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rep = h / kvh;
  const int rows = n_q * rep;

  // the live slots, as attend() computes them
  const int q_max = q_pos0 + n_q - 1;
  int p_hi = min(n_slots, (kv_len + page - 1) / page);
  if (causal && q_max >= 0) p_hi = min(p_hi, q_max / page + 1);
  int p_lo = 0;
  if (window) {
    const int x = q_pos0 - window + 1;
    p_lo = x > 0 ? x / page : 0;
  }
  const int k_begin = p_lo * page;
  const int k_end = min(kv_len, p_hi * page);   // keys past it: masked
  const int n_live = k_end > k_begin ? (k_end - k_begin + TILE - 1) / TILE
                                     : 0;
  const int per = (n_live + splits - 1) / splits;
  const int t_lo = min(n_live, split * per);
  const int n_tiles = min(n_live, t_lo + per) - t_lo;   // this split's

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + 8 * st, 32);          // each copy lane's copies
      mbar_init(empty + 8 * st, warps);      // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (n_tiles > 0) {
    // Q rows (pad rows zero-filled), copied by every thread
    constexpr int CPR = HD / 8;
    const int c = tid % CPR;
    for (int r = tid / CPR; r < warps * 16; r += blockDim.x / CPR) {
      const bool ok = r < rows;
      const bf16* src = q_base;
      if (ok) {
        const int qi = r / rep;
        src = q_base + ((long long)qi * h + g * rep + (r - qi * rep)) * HD +
              c * 8;
      }
      cp_async16(q_s + (r * L::QS + c * 8) * 2, src, ok);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  if (warp == warps) {
    // the copy warp: tile t into stage t % STAGES, once its consumers
    // are done with tile t - STAGES
    const KeyMap map{bt, page,
                     (page & (page - 1)) == 0 ? __ffs(page) - 1 : -1, kvh, g};
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % STAGES;
      if (t >= STAGES) mbar_wait(empty + 8 * st, (t / STAGES - 1) & 1);
      const int k0 = k_begin + (t_lo + t) * TILE;
      long long row[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = k0 + lane + 32 * j;
        row[j] = k < k_end ? map.row(k, map.slot(k)) : -1;
      }
      const uint32_t ks = ring + st * L::STAGE;
      copy_rows<HD>(k_pool, ks, row, lane);
      copy_rows<HD_V>(v_pool, ks + SK::BYTES, row, lane);
      cp_async_arrive(full + 8 * st);
    }
    cp_async_wait_all();
    return;
  }

  // this thread's two rows (r0 and r0 + 8 of its warp's 16) and the
  // query positions of its warp's rows (pad rows included: they only
  // widen the range)
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16 + gq, r1 = r0 + 8;
  int qp0 = q_pos0 + r0 / rep, qp1 = q_pos0 + r1 / rep;
  asm("" : "+r"(qp0), "+r"(qp1));   // kept: no divisions in the mask
  const int w_qmin = q_pos0 + warp * 16 / rep;
  const int w_qmax = q_pos0 + (warp * 16 + 15) / rep;

  float o[HD_V / 2];
#pragma unroll
  for (int i = 0; i < HD_V / 2; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  const float sl2 = scale * LOG2E;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % STAGES;
    mbar_wait(full + 8 * st, (i / STAGES) & 1);
    fence_async_shared();
    const int k0 = k_begin + (t_lo + i) * TILE;
    const uint32_t ks = ring + st * L::STAGE;
    const uint32_t vs = ks + SK::BYTES;

    // S = Q K^T: Q fragments from shared memory (they are not kept in
    // registers across tiles), K rows the K-major B operand as they
    // lie.  Every warpgroup runs every tile: a branch around a wgmma
    // would serialise them all, and a tile wholly masked for a
    // warpgroup leaves its rows' state as it was.
    float s[NS * 4];
#pragma unroll
    for (int j = 0; j < NS * 4; ++j) s[j] = 0.f;
#pragma unroll
    for (int k0g = 0; k0g < KT; k0g += KG) {
      uint32_t qf[KG][4];
      uint64_t dk[KG];
#pragma unroll
      for (int j = 0; j < KG; ++j) {
        const int kk = k0g + j;
        ldmatrix_x4(qf[j], q_s + ((warp * 16 + (lane & 7) +
                                   ((lane >> 3) & 1) * 8) * L::QS +
                                  kk * 16 + (lane >> 4) * 8) * 2);
        dk[j] = descriptor(ks + (kk * 16 / SK::CW) * TILE * SK::RB +
                               (kk * 16 % SK::CW) * 2,
                           16, 8 * SK::RB, SK::MODE);
      }
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < KG; ++j) wgmma<64, 0>(s, qf[j], dk[j]);
      wgmma_commit_wait();
      fence_regs(s);
    }

    // scale to log2 units; mask only where the tile crosses a mask edge
    const bool masked = k0 + TILE > k_end ||
                        (causal && k0 + TILE - 1 > w_qmin) ||
                        (window && k0 <= w_qmax - window);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * sl2;
        if (masked) {
          const int kp = k0 + j * 8 + 2 * tq + (e & 1);
          const int qp = e < 2 ? qp0 : qp1;
          bool ok = kp < k_end;
          if (causal) ok = ok && kp <= qp;
          if (window) ok = ok && kp > qp - window;
          x = ok ? x : NEG_INF;
        }
        s[4 * j + e] = x;
      }

    // online softmax on the fragments: rows r0 (e 0, 1) and r1 (e 2, 3)
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float c0 = fast_exp2(m0 - mn0), c1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int j = 0; j < HD_V / 8; ++j) {
      o[4 * j] *= c0;
      o[4 * j + 1] *= c0;
      o[4 * j + 2] *= c1;
      o[4 * j + 3] *= c1;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[4 * j] = fast_exp2(s[4 * j] - mn0);
      s[4 * j + 1] = fast_exp2(s[4 * j + 1] - mn0);
      s[4 * j + 2] = fast_exp2(s[4 * j + 2] - mn1);
      s[4 * j + 3] = fast_exp2(s[4 * j + 3] - mn1);
      l0 += s[4 * j] + s[4 * j + 1];
      l1 += s[4 * j + 2] + s[4 * j + 3];
    }

    // O += P V: score tiles 2kk, 2kk + 1 are the A registers of k-step
    // kk; V rows (keys) are the MN-major B operand
    uint32_t pa[NS / 2][4];
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    uint64_t dv[NS / 2];
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk)
      dv[kk] = descriptor(vs + kk * 16 * SV::RB, TILE * SV::RB, 8 * SV::RB,
                          SV::MODE);
    fence_regs(o);
    wgmma_fence();
    if constexpr (HD_V == 256) {
      // two m64n128 halves: columns 128..255 are V's chunk rows 2 and 3
      float(&o_lo)[64] = *reinterpret_cast<float(*)[64]>(o);
      float(&o_hi)[64] = *reinterpret_cast<float(*)[64]>(o + 64);
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        wgmma_n128<1>(o_lo, pa[kk], dv[kk], 1);
        wgmma_n128<1>(o_hi, pa[kk],
                      descriptor(vs + 2 * TILE * SV::RB + kk * 16 * SV::RB,
                                 TILE * SV::RB, 8 * SV::RB, SV::MODE),
                      1);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) wgmma<HD_V, 1>(o, pa[kk], dv[kk]);
    }
    wgmma_commit_wait();
    fence_regs(o);
    // this warp is done with the stage
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }

  // each quad lane summed its own keys: add the quad's sums up
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= rows) continue;
    const float m = half ? m1 : m0, l = half ? l1 : l0;
    const int qi = r / rep;
    const long long row = (long long)qi * h + g * rep + (r - qi * rep);
    if (part != nullptr) {
      float* rec = part + row * (HD_V + 2);
      if (tq == 0) {
        rec[0] = m;
        rec[1] = l;
      }
#pragma unroll
      for (int j = 0; j < HD_V / 8; ++j)
        *reinterpret_cast<float2*>(rec + 2 + j * 8 + 2 * tq) =
            make_float2(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
      continue;
    }
    const float inv = m == NEG_INF ? 0.f : 1.f / fmaxf(l, 1e-20f);
    bf16* dst = out_base + row * HD_V + 2 * tq;
#pragma unroll
    for (int j = 0; j < HD_V / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) = __floats2bfloat162_rn(
          o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
  }
}

// Second launch after a split one: each of n_rows output rows (hd_v
// values) from its splits' partial records (part[s * n_rows + row], as
// attend writes them).  Every split is rescaled by exp2(m_s - max m);
// a row whose every split saw no key writes 0.  A thread takes two
// values of a row.
__global__ void combine_kernel(const float* __restrict__ part,
                               bf16* __restrict__ out, long long n_rows,
                               int hd_v, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int pairs = hd_v / 2;
  if (i >= n_rows * pairs) return;
  const long long row = i / pairs;
  const int d = 2 * (int)(i - row * pairs);
  const long long stride = n_rows * (hd_v + 2);
  const float* rec = part + row * (hd_v + 2);
  float m = NEG_INF;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, rec[s * stride]);
  float l = 0.f, a0 = 0.f, a1 = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* r = rec + s * stride;
    const float w = exp2f(r[0] - m);
    l = fmaf(r[1], w, l);
    const float2 a = *reinterpret_cast<const float2*>(r + 2 + d);
    a0 = fmaf(a.x, w, a0);
    a1 = fmaf(a.y, w, a1);
  }
  const float inv = m == NEG_INF ? 0.f : 1.f / fmaxf(l, 1e-20f);
  *reinterpret_cast<__nv_bfloat162*>(out + row * hd_v + d) =
      __floats2bfloat162_rn(a0 * inv, a1 * inv);
}

// Launch combine_kernel over the n_rows rows of out.
inline int combine(const float* part, bf16* out, long long n_rows, int hd_v,
                   int splits, cudaStream_t stream) {
  const long long n = n_rows * (hd_v / 2);
  const int threads = 256;
  combine_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                   stream>>>(part, out, n_rows, hd_v, splits);
  return (int)cudaGetLastError();
}

// Call f(std::integral_constant<int, HD>, std::integral_constant<int,
// HD_V>) for an instantiated pair of head widths (32, 64 or 128 each,
// 256 with 256, or 192 with 128); cudaErrorInvalidValue for any other.
template <int HD, typename F>
inline int with_hd_v(int hd_v, F&& f) {
  using HDc = std::integral_constant<int, HD>;
  switch (hd_v) {
    case 32: return f(HDc{}, std::integral_constant<int, 32>{});
    case 64: return f(HDc{}, std::integral_constant<int, 64>{});
    case 128: return f(HDc{}, std::integral_constant<int, 128>{});
  }
  return (int)cudaErrorInvalidValue;
}
template <typename F>
inline int with_widths(int hd, int hd_v, F&& f) {
  switch (hd) {
    case 32: return with_hd_v<32>(hd_v, f);
    case 64: return with_hd_v<64>(hd_v, f);
    case 128: return with_hd_v<128>(hd_v, f);
    case 192:
      if (hd_v == 128)
        return f(std::integral_constant<int, 192>{},
                 std::integral_constant<int, 128>{});
      break;
    case 256:
      if (hd_v == 256)
        return f(std::integral_constant<int, 256>{},
                 std::integral_constant<int, 256>{});
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace prefill_tc
