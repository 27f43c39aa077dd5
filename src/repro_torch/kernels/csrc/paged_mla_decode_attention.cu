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
// caller absorbed W_uk into q_lat and up-projects o_lat through W_uv.
//
// All heads share one latent "KV head": it acts as an MQA head with key
// width lora + rope (576 at full width) and value width lora (512), and
// the values ARE the key tile's first lora columns, so each page is loaded
// once, as one f32 tile of [ckv | kr] rows, and serves both the scores and
// PV.  The f32 accumulators of 128 heads x 512 are 256 KB, all the
// registers of an SM and more than a block's 227 KB of shared memory, so
// the heads are split into groups of hg across the grid.
//
// Two launches, as paged_decode_attention.cu.  decode_kernel, grid
// (slots, head groups, splits): the block of (slot, group, split) holds hg
// query rows and walks the live block-table slots [split * spp,
// (split + 1) * spp) one page at a time, with an online softmax in f32;
// it writes its partial state (m, l, unnormalised acc) to a workspace.  A
// split with no live page writes only m = NEG_INF and exits.
// combine_kernel, grid (slots, head groups), rescales the live splits'
// partials by exp(m_split - max m) and normalises.  The TPU kernel walked
// a slot's pages in one sequential grid dimension with all heads in VMEM.
//
// Inside a block, per page: scores with one (row, token) per thread from
// float4 shared-memory loads (rows padded so a quarter-warp's float4s hit
// distinct banks); the probabilities stored token-major, so PV reads one
// float4 of p for an item of 4 rows and one float4 of ckv for its 4
// dims; the PV accumulators stay in registers across the page loop (2
// items, 32 floats, a thread at hg 16, lora 512).
//
// Pages past lens and pages slid out of the window are never read: their
// table slots may point at freed or scratch pages.  Numerics follow the
// TPU kernel: f32 math whatever the storage types, NEG_INF = -1e30, and
// division by max(l, 1e-20).  A slot with lens = 0 (an empty decode slot)
// has no live page and writes zeros.
//
// What bounds it on an H100: per live token it reads (lora + rope) pool
// values (each head group re-reads the page, mostly from L2) and does
// 2 * h * (2 * lora + rope) FLOPs, so at full width the bytes and the
// tensor-core FLOPs give bounds of the same order (a few microseconds).
// This version does f32 FMAs from shared memory on the CUDA cores; wgmma,
// TMA and one page load for all head groups are later work.
#include "paged_attention.cuh"

namespace {

using paged_attn::LOAD_BATCH;
using paged_attn::NEG_INF;

constexpr int THREADS = 256;
constexpr int RG = 4;          // query rows of one PV item
constexpr int DG = 4;          // latent dims of one PV item (a float4)
constexpr int MAX_ITEMS = 2;   // PV items per thread: hg * lora <= 8192

// Row stride (floats) of the [q_lat | q_rope] and [ckv | kr] rows in
// shared memory: w rounded so that stride / 4 is odd, which puts the
// float4s of 8 consecutive rows (one quarter-warp phase) on distinct
// banks.
__host__ __device__ inline int row_stride(int w) {
  return w + ((w / 4) % 2 == 0 ? 4 : 8);
}

// Bytes of dynamic shared memory one decode block needs (the wrapper
// mirrors this in paged_mla_decode_attention.py).
inline size_t smem_bytes(int hg, int lora, int rope, int page) {
  const size_t wp = row_stride(lora + rope);
  return sizeof(float) * (hg * wp          // [q_lat | q_rope] rows
                          + page * wp      // [ckv | kr] tile
                          + page * hg      // p, token-major
                          + 3 * hg);       // m, l, corr
}

// Copy the page's n_tok rows of `width` values (contiguous in the pool:
// one page of one pool) to dst rows of stride dst_stride at column
// dst_col, converting to f32, 16 bytes per load, LOAD_BATCH loads in
// flight per thread.  width * sizeof(T) is a multiple of 16 and the page
// start is 16-byte aligned (the wrapper checks both); dst_stride and
// dst_col are multiples of 4.
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          int width, float* dst,
                                          int dst_stride, int dst_col,
                                          int n_tok) {
  constexpr int V = 16 / sizeof(T);
  const int per_tok = width / V;
  const int n_vec = n_tok * per_tok;
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  for (int base = threadIdx.x; base < n_vec;
       base += LOAD_BATCH * blockDim.x) {
    uint4 r[LOAD_BATCH];
#pragma unroll
    for (int j = 0; j < LOAD_BATCH; ++j) {
      const int i = base + j * blockDim.x;
      if (i < n_vec) r[j] = s4[i];
    }
#pragma unroll
    for (int j = 0; j < LOAD_BATCH; ++j) {
      const int i = base + j * blockDim.x;
      if (i < n_vec) {
        const int t = i / per_tok, c = i - t * per_tok;
        float f[V];
        paged_attn::unpack(r[j], f, src);
        float4* d = reinterpret_cast<float4*>(dst + t * dst_stride +
                                              dst_col + c * V);
#pragma unroll
        for (int e = 0; e < V / 4; ++e)
          d[e] = make_float4(f[4 * e], f[4 * e + 1], f[4 * e + 2],
                             f[4 * e + 3]);
      }
    }
  }
}

template <typename TQ, typename TP>
__global__ void __launch_bounds__(THREADS, 2)
    decode_kernel(const TQ* __restrict__ q_lat, const TQ* __restrict__ q_rope,
                  const TP* __restrict__ ckv_pool,
                  const TP* __restrict__ kr_pool,
                  const int* __restrict__ block_table,
                  const int* __restrict__ lens, float* __restrict__ part,
                  int h, int hg, int lora, int rope, int page, int n_slots,
                  int slots_per_split, int window, float scale) {
  const int bi = blockIdx.x, grp = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x;
  const int len = lens[bi];
  float* my = part + (((long long)bi * gridDim.y + grp) * gridDim.z + split)
                         * hg * (lora + 2);

  // live slots: the TPU kernel's predicate, p * page < len and, with a
  // window, (p + 1) * page > len - window
  int p_hi = min(n_slots, (len + page - 1) / page);
  int p_lo = 0;
  if (window) {
    const int x = len - window;
    p_lo = x > 0 ? x / page : 0;
  }
  p_lo = max(p_lo, split * slots_per_split);
  p_hi = min(p_hi, (split + 1) * slots_per_split);
  if (p_lo >= p_hi) {
    // no live page in this split: m = NEG_INF tells the combine to skip
    // it (l and acc stay unwritten)
    for (int i = tid; i < hg; i += blockDim.x) my[i] = NEG_INF;
    return;
  }

  const int w = lora + rope, wp = row_stride(w), w4 = w / 4;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* kv_s = q_s + hg * wp;
  float* p_s = kv_s + page * wp;     // p_s[t * hg + r]
  float* m_s = p_s + page * hg;
  float* l_s = m_s + hg;
  float* c_s = l_s + hg;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  // row r is head grp * hg + r of slot bi
  for (int i = tid; i < hg * w; i += blockDim.x) {
    const int r = i / w, d = i - r * w;
    const long long row = (long long)bi * h + grp * hg + r;
    q_s[r * wp + d] = d < lora
                          ? paged_attn::load_f(q_lat, row * lora + d)
                          : paged_attn::load_f(q_rope, row * rope + d - lora);
  }
  for (int i = tid; i < hg; i += blockDim.x) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.f;
  }
  // PV items: RG rows x DG latent dims each, accumulated in registers
  // across the page loop
  const int n_dq = lora / DG;
  const int n_items = (hg / RG) * n_dq;
  float acc[MAX_ITEMS][RG][DG];
#pragma unroll
  for (int it = 0; it < MAX_ITEMS; ++it)
#pragma unroll
    for (int j = 0; j < RG; ++j)
#pragma unroll
      for (int k = 0; k < DG; ++k) acc[it][j][k] = 0.f;

  for (int p = p_lo; p < p_hi; ++p) {
    const long long pg = block_table[(long long)bi * n_slots + p];
    __syncthreads();   // the previous page's PV is done with kv_s / p_s
    load_rows(ckv_pool + pg * page * lora, lora, kv_s, wp, 0, page);
    load_rows(kr_pool + pg * page * rope, rope, kv_s, wp, lora, page);
    __syncthreads();

    // scores: one (row, token) per thread, float4 loads; a quarter-warp's
    // lanes read 8 neighbouring tile rows (conflict-free, see row_stride)
    // and share one q row (broadcast)
    for (int i = tid; i < hg * page; i += blockDim.x) {
      const int r = i / page, t = i - r * page;
      const float4* qr = reinterpret_cast<const float4*>(q_s + r * wp);
      const float4* kt = reinterpret_cast<const float4*>(kv_s + t * wp);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int d = 0; d < w4; ++d) {
        const float4 x = qr[d], y = kt[d];
        a0 = fmaf(x.x, y.x, a0);
        a1 = fmaf(x.y, y.y, a1);
        a2 = fmaf(x.z, y.z, a2);
        a3 = fmaf(x.w, y.w, a3);
      }
      const int tok = p * page + t;
      bool ok = tok < len;
      if (window) ok = ok && tok > len - 1 - window;
      p_s[t * hg + r] = ok ? ((a0 + a1) + (a2 + a3)) * scale : NEG_INF;
    }
    __syncthreads();

    // online softmax: one warp per row
    for (int r = warp; r < hg; r += nwarps) {
      float mx = NEG_INF;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, p_s[t * hg + r]);
      mx = paged_attn::warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float e = expf(p_s[t * hg + r] - m_new);
        p_s[t * hg + r] = e;
        sum += e;
      }
      sum = paged_attn::warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // PV on the latent columns of the same tile: per token one float4 of
    // p (the item's RG rows) and one float4 of ckv (its DG dims); a
    // warp's lanes take neighbouring dims of the same rows
#pragma unroll
    for (int it = 0; it < MAX_ITEMS; ++it) {
      const int item = tid + it * THREADS;
      if (item < n_items) {
        const int r0 = (item / n_dq) * RG, d0 = (item % n_dq) * DG;
#pragma unroll
        for (int j = 0; j < RG; ++j) {
          const float c = c_s[r0 + j];
#pragma unroll
          for (int k = 0; k < DG; ++k) acc[it][j][k] *= c;
        }
        for (int t = 0; t < page; ++t) {
          const float4 pv = *reinterpret_cast<const float4*>(p_s + t * hg + r0);
          const float4 vv =
              *reinterpret_cast<const float4*>(kv_s + t * wp + d0);
          const float pr[RG] = {pv.x, pv.y, pv.z, pv.w};
          const float vd[DG] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int j = 0; j < RG; ++j)
#pragma unroll
            for (int k = 0; k < DG; ++k)
              acc[it][j][k] = fmaf(pr[j], vd[k], acc[it][j][k]);
        }
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < hg; i += blockDim.x) {
    my[i] = m_s[i];
    my[hg + i] = l_s[i];
  }
#pragma unroll
  for (int it = 0; it < MAX_ITEMS; ++it) {
    const int item = tid + it * THREADS;
    if (item < n_items) {
      const int r0 = (item / n_dq) * RG, d0 = (item % n_dq) * DG;
#pragma unroll
      for (int j = 0; j < RG; ++j)
        *reinterpret_cast<float4*>(my + 2 * hg + (r0 + j) * lora + d0) =
            make_float4(acc[it][j][0], acc[it][j][1], acc[it][j][2],
                        acc[it][j][3]);
    }
  }
}

template <typename TQ>
__global__ void __launch_bounds__(THREADS)
    combine_kernel(const float* __restrict__ part, TQ* __restrict__ out,
                   int h, int hg, int lora, int splits) {
  const int bi = blockIdx.x, grp = blockIdx.y;
  const int stride = hg * (lora + 2);
  const float* base =
      part + ((long long)bi * gridDim.y + grp) * splits * stride;
  for (int i = threadIdx.x; i < hg * lora; i += blockDim.x) {
    const int r = i / lora;
    float m = NEG_INF;
    for (int s = 0; s < splits; ++s) m = fmaxf(m, base[s * stride + r]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float* ps = base + s * stride;
      if (ps[r] == NEG_INF) continue;   // a split without live pages
      const float wgt = expf(ps[r] - m);
      l = fmaf(ps[hg + r], wgt, l);
      a = fmaf(ps[2 * hg + i], wgt, a);
    }
    const float o = m == NEG_INF ? 0.f : a / fmaxf(l, 1e-20f);
    paged_attn::store_f(out, ((long long)bi * h + grp * hg) * lora + i, o);
  }
}

template <typename TQ, typename TP>
int launch(const void* q_lat, const void* q_rope, const void* ckv_pool,
           const void* kr_pool, const void* block_table, const void* lens,
           void* part, void* out, int b, int h, int hg, int lora, int rope,
           int page, int n_slots, int slots_per_split, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(hg, lora, rope, page);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<TQ, TP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int splits = (n_slots + slots_per_split - 1) / slots_per_split;
  decode_kernel<TQ, TP><<<dim3(b, h / hg, splits), THREADS, smem, stream>>>(
      static_cast<const TQ*>(q_lat), static_cast<const TQ*>(q_rope),
      static_cast<const TP*>(ckv_pool), static_cast<const TP*>(kr_pool),
      static_cast<const int*>(block_table), static_cast<const int*>(lens),
      static_cast<float*>(part), h, hg, lora, rope, page, n_slots,
      slots_per_split, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<TQ><<<dim3(b, h / hg), THREADS, 0, stream>>>(
      static_cast<const float*>(part), static_cast<TQ*>(out), h, hg, lora,
      splits);
  return (int)cudaGetLastError();
}

template <typename TQ>
int launch_q(int pool_dtype, const void* q_lat, const void* q_rope,
             const void* ckv_pool, const void* kr_pool,
             const void* block_table, const void* lens, void* part, void* out,
             int b, int h, int hg, int lora, int rope, int page, int n_slots,
             int slots_per_split, int window, float scale,
             cudaStream_t stream) {
  if (pool_dtype == 0)
    return launch<TQ, float>(q_lat, q_rope, ckv_pool, kr_pool, block_table,
                             lens, part, out, b, h, hg, lora, rope, page,
                             n_slots, slots_per_split, window, scale, stream);
  if (pool_dtype == 1)
    return launch<TQ, __nv_bfloat16>(q_lat, q_rope, ckv_pool, kr_pool,
                                     block_table, lens, part, out, b, h, hg,
                                     lora, rope, page, n_slots,
                                     slots_per_split, window, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q_dtype (q_lat, q_rope and out) and pool_dtype (ckv_pool and kr_pool):
// 0 = float32, 1 = bfloat16.  h is a multiple of hg.  part is a float32
// workspace of b * (h / hg) * splits * hg * (lora + 2) values, splits =
// ceil(n_slots / slots_per_split).  Returns the cudaError_t of the launches
// (0 on success).
extern "C" int paged_mla_decode_attention_launch(
    const void* q_lat, const void* q_rope, const void* ckv_pool,
    const void* kr_pool, const void* block_table, const void* lens,
    void* part, void* out, int b, int h, int hg, int lora, int rope,
    int page, int n_slots, int slots_per_split, int window, float scale,
    int q_dtype, int pool_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return launch_q<float>(pool_dtype, q_lat, q_rope, ckv_pool, kr_pool,
                           block_table, lens, part, out, b, h, hg, lora, rope,
                           page, n_slots, slots_per_split, window, scale, s);
  if (q_dtype == 1)
    return launch_q<__nv_bfloat16>(pool_dtype, q_lat, q_rope, ckv_pool,
                                   kr_pool, block_table, lens, part, out, b,
                                   h, hg, lora, rope, page, n_slots,
                                   slots_per_split, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
