// The CUDA-core device body `attend` of the two prefill-attention
// kernels for f32 inputs: the paged one (paged_prefill_attention.cu) and
// the dense chunked-prefill one (chunked_prefill_attention.cu, which
// views a request's cache as one-token pages under the identity table).
// Their bf16 inputs take the tensor-core body of prefill_attention_tc.cuh.
// It no longer serves decode: the two decode kernels
// (paged_decode_attention.cu, paged_cross_decode_attention.cu) run
// decode_attention.cuh in both dtypes.  Also the small device helpers
// those bodies share (loads, cp.async, exp2, warp reductions, the
// shared-memory opt-in).
//
// One thread block owns R = n_q * rep query rows that all read the same
// KV head g: n_q consecutive query positions of one segment times the
// rep query heads of that KV head.  It walks the
// live block-table slots of its segment in order, a tile of
// `tile_pages` pages at a time, and keeps an online softmax in f32:
//
//   page ids   the tile's block-table entries -> shared memory
//   K/V tile   device memory -> shared memory, 16-byte loads issued in
//              batches so several are in flight per thread, converted
//              to f32 once
//   scores     s[row][t] = (q_row . k_t) * scale, masked to NEG_INF;
//              each thread computes an RT x TT block from registers
//   softmax    one warp per row: m_new, p = exp(s - m_new), l, corr
//   PV         acc[row][d] = acc * corr + sum_t p[row][t] * v[t][d];
//              each thread an RT x DT block
//
// Shared-memory rows are padded by one float where a warp reads down a
// column.  hd_v is a multiple of DT (the wrapper checks).
//
// Live slots are the contiguous range [p_lo, p_hi) the TPU kernels
// compute with their `live` predicate: pages at or past kv_len, pages
// wholly acausal for every row of the block, and pages wholly out of the
// sliding window are never read (their table slots may point at freed
// or scratch pages).
//
// Numerics follow the TPU kernels: f32 math whatever the storage type,
// finite NEG_INF = -1e30 so a row fully masked inside one tile takes
// p = exp(0) there and the next tile's corr = exp(-1e30 - m) zeroes that
// garbage (with -inf it would be NaN), and division by max(l, 1e-20).
// A row that never meets a key it may attend (kv_len = 0, or a pad query
// of a windowed segment) writes 0: its running max is still NEG_INF.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged_attn {

constexpr float NEG_INF = -1e30f;
constexpr int LOAD_BATCH = 4;   // 16-byte loads in flight per thread
constexpr int TT = 4;           // keys per thread in the score loop
constexpr int DT = 4;           // value dims per thread in the PV loop

__device__ __forceinline__ float load_f(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p,
                                        long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, long long i, float x) {
  p[i] = x;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, long long i,
                                        float x) {
  p[i] = __float2bfloat16(x);
}

// 16 bytes of T -> f32
__device__ __forceinline__ void unpack(const uint4& r, float* f,
                                       const float*) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float* f,
                                       const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 x = __bfloat1622float2(h[k]);
    f[2 * k] = x.x;
    f[2 * k + 1] = x.y;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid false, 16 zero bytes (src is not
// read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 2^x in one MUFU.EX2 (exp2f adds a scaling for denormal results; here
// those are weights below 2^-126, flushed to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Raise `kernel`'s dynamic shared-memory limit to the most one block of
// the current device may use beside the kernel's static shared memory,
// once per device (bit d of *done) rather than on every launch.
template <typename K>
inline cudaError_t allow_max_smem(K* kernel, unsigned* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (*done & bit) return cudaSuccess;
  int most = 0;
  err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        most - (int)attr.sharedSizeBytes);
  if (err == cudaSuccess) *done |= bit;
  return err;
}

// Bytes of dynamic shared memory one block needs.
inline size_t smem_bytes(int rows, int hd, int hd_v, int tile_pages,
                         int page) {
  const int tile_tok = tile_pages * page;
  return sizeof(float) * (rows * (hd + 1)           // q rows, padded
                          + tile_tok * (hd + 1)     // K tile, padded
                          + tile_tok * hd_v         // V tile
                          + rows * (tile_tok + 1)   // scores, then p
                          + rows * hd_v             // accumulators
                          + 3 * rows)               // m, l, corr
         + sizeof(int) * tile_pages;                // the tile's page ids
}

// Copy n_tok tokens of KV head g (width values each) from the pool into
// dst (row stride dst_stride floats), converting to f32.  The tokens are
// those of the tile's pages pg_s; width is a multiple of 16 / sizeof(T)
// and the pool rows are 16-byte aligned (the wrapper checks both).
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ pool,
                                          const int* pg_s, float* dst,
                                          int dst_stride, int n_tok,
                                          int page, int kvh, int g,
                                          int width) {
  constexpr int V = 16 / sizeof(T);
  const int per_tok = width / V;
  const int n_vec = n_tok * per_tok;
  for (int base = threadIdx.x; base < n_vec;
       base += LOAD_BATCH * blockDim.x) {
    uint4 r[LOAD_BATCH];
#pragma unroll
    for (int j = 0; j < LOAD_BATCH; ++j) {
      const int i = base + j * blockDim.x;
      if (i < n_vec) {
        const int t = i / per_tok, c = i - t * per_tok;
        const long long tok = (long long)pg_s[t / page] * page + t % page;
        r[j] = *reinterpret_cast<const uint4*>(
            pool + (tok * kvh + g) * width + c * V);
      }
    }
#pragma unroll
    for (int j = 0; j < LOAD_BATCH; ++j) {
      const int i = base + j * blockDim.x;
      if (i < n_vec) {
        const int t = i / per_tok, c = i - t * per_tok;
        float f[V];
        unpack(r[j], f, pool);
        float* d = dst + t * dst_stride + c * V;
#pragma unroll
        for (int e = 0; e < V; ++e) d[e] = f[e];
      }
    }
  }
}

// q_base / out_base point at (segment, first query of the block, head 0);
// consecutive query positions are h * hd (h * hd_v) elements apart.
// q_pos0 is the absolute position of the block's first query; n_q of its
// query positions exist (the ragged edge of a segment is not computed
// and not written).  bt is the segment's block-table row, or nullptr for
// the identity table (slot j holds page j).  RT is the rows per thread of
// the score and PV blocks.  The block writes its normalised output.
template <int RT, typename T>
__device__ void attend(const T* __restrict__ q_base,
                       const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ bt, T* __restrict__ out_base,
                       int n_q, int q_pos0, int kv_len, bool causal,
                       int window, int h, int kvh, int g, int hd, int hd_v,
                       int page, int n_slots, int tile_pages, float scale) {
  const int rep = h / kvh;
  const int rows = n_q * rep;
  const int tile_tok = tile_pages * page;
  const int hdp = hd + 1;
  extern __shared__ float smem[];
  const int sst = tile_tok + 1;
  const int n_rg = (rows + RT - 1) / RT;
  const int n_tt = (tile_tok + TT - 1) / TT;
  const int n_dg = hd_v / DT;
  float* q_s = smem;
  float* k_s = q_s + rows * hdp;
  float* v_s = k_s + tile_tok * hdp;
  float* s_s = v_s + tile_tok * hd_v;
  float* acc_s = s_s + rows * sst;
  float* m_s = acc_s + rows * hd_v;
  float* l_s = m_s + rows;
  float* c_s = l_s + rows;
  int* pg_s = reinterpret_cast<int*>(c_s + rows);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  // row = qi * rep + r  ->  query position q_pos0 + qi, head g * rep + r
  for (int i = tid; i < rows * hd; i += blockDim.x) {
    const int row = i / hd, d = i % hd;
    const int qi = row / rep, r = row % rep;
    q_s[row * hdp + d] =
        load_f(q_base, ((long long)qi * h + g * rep + r) * hd + d);
  }
  for (int i = tid; i < rows * hd_v; i += blockDim.x) acc_s[i] = 0.f;
  for (int i = tid; i < rows; i += blockDim.x) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.f;
  }

  const int q_min = q_pos0;
  const int q_max = q_pos0 + n_q - 1;
  int p_hi = min(n_slots, (kv_len + page - 1) / page);
  if (causal && q_max >= 0) p_hi = min(p_hi, q_max / page + 1);
  int p_lo = 0;
  if (window) {
    const int x = q_min - window + 1;
    p_lo = x > 0 ? x / page : 0;
  }
  __syncthreads();

  for (int p0 = p_lo; p0 < p_hi; p0 += tile_pages) {
    const int np = min(tile_pages, p_hi - p0);
    const int n_tok = np * page;
    if (tid < np) pg_s[tid] = bt != nullptr ? bt[p0 + tid] : p0 + tid;
    __syncthreads();
    load_tile(k_pool, pg_s, k_s, hdp, n_tok, page, kvh, g, hd);
    load_tile(v_pool, pg_s, v_s, hd_v, n_tok, page, kvh, g, hd_v);
    __syncthreads();

    // scores: each thread owns RT rows x TT keys (keys strided by n_tt so
    // a warp's lanes read neighbouring K rows: no bank conflicts)
    for (int mt = tid; mt < n_rg * n_tt; mt += blockDim.x) {
      const int rg = mt / n_tt, tg = mt % n_tt;
      const float* qr[RT];
      const float* kt[TT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
        qr[i] = q_s + min(rg * RT + i, rows - 1) * hdp;
#pragma unroll
      for (int j = 0; j < TT; ++j)
        kt[j] = k_s + min(tg + j * n_tt, tile_tok - 1) * hdp;
      float acc[RT][TT] = {};
      for (int d = 0; d < hd; ++d) {
        float qv[RT], kv[TT];
#pragma unroll
        for (int i = 0; i < RT; ++i) qv[i] = qr[i][d];
#pragma unroll
        for (int j = 0; j < TT; ++j) kv[j] = kt[j][d];
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < TT; ++j)
            acc[i][j] = fmaf(qv[i], kv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int row = rg * RT + i;
        if (row >= rows) continue;
        const int q_pos = q_pos0 + row / rep;
#pragma unroll
        for (int j = 0; j < TT; ++j) {
          const int t = tg + j * n_tt;
          if (t >= tile_tok) continue;
          const int k_pos = p0 * page + t;
          bool ok = t < n_tok && k_pos < kv_len;
          if (causal) ok = ok && q_pos >= k_pos;
          if (window) ok = ok && k_pos > q_pos - window;
          s_s[row * sst + t] = ok ? acc[i][j] * scale : NEG_INF;
        }
      }
    }
    __syncthreads();

    for (int row = warp; row < rows; row += nwarps) {
      float* sr = s_s + row * sst;
      float mx = NEG_INF;
      for (int t = lane; t < n_tok; t += 32) mx = fmaxf(mx, sr[t]);
      mx = warp_max(mx);
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < n_tok; t += 32) {
        const float p = expf(sr[t] - m_new);
        sr[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[row] = corr;
        l_s[row] = l_s[row] * corr + sum;
        m_s[row] = m_new;
      }
    }
    __syncthreads();

    // PV: each thread owns RT rows x DT value dims (dims strided by n_dg)
    for (int mt = tid; mt < n_rg * n_dg; mt += blockDim.x) {
      const int rg = mt / n_dg, dg = mt % n_dg;
      const float* pr[RT];
      float a[RT][DT];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int row = min(rg * RT + i, rows - 1);
        pr[i] = s_s + row * sst;
#pragma unroll
        for (int j = 0; j < DT; ++j)
          a[i][j] = acc_s[row * hd_v + dg + j * n_dg] * c_s[row];
      }
      for (int t = 0; t < n_tok; ++t) {
        float pv[RT], vv[DT];
#pragma unroll
        for (int i = 0; i < RT; ++i) pv[i] = pr[i][t];
#pragma unroll
        for (int j = 0; j < DT; ++j) vv[j] = v_s[t * hd_v + dg + j * n_dg];
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < DT; ++j)
            a[i][j] = fmaf(pv[i], vv[j], a[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int row = rg * RT + i;
        if (row >= rows) continue;
#pragma unroll
        for (int j = 0; j < DT; ++j)
          acc_s[row * hd_v + dg + j * n_dg] = a[i][j];
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < rows * hd_v; i += blockDim.x) {
    const int row = i / hd_v, d = i % hd_v;
    const int qi = row / rep, r = row % rep;
    const float o =
        m_s[row] == NEG_INF ? 0.f : acc_s[i] / fmaxf(l_s[row], 1e-20f);
    store_f(out_base, ((long long)qi * h + g * rep + r) * hd_v + d, o);
  }
}

}  // namespace paged_attn
