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
// Design: a simple one that is right; speed is later work.  Two launches
// on the caller's stream, no atomics, so the result is deterministic:
//   (a) dq_kernel, one block per (request, query head, tile of T = 32
//       query positions): loop 1 over the live key tiles recomputes each
//       row's max m and sum l with the forward's masks; D_i = dO_i . O_i;
//       m, 1/l (0 for a row with no live key) and D go to `stats` for
//       (b).  Loop 2 walks the tiles again: P, dP = dO v^T, dS and dQ +=
//       dS K.
//   (b) dkdv_kernel, one block per (request, KV head, tile of T keys):
//       loops over the rep query heads and over the query tiles that can
//       see its keys (causal, window), and accumulates dV += P^T dO and
//       dK += dS^T Q.
// Both bodies run on the CUDA cores with f32 sums for f32 and bf16
// inputs alike: every tile is converted to f32 in shared memory (rows
// padded by 4 floats, so float4 reads of a row are conflict free), a
// T x T score tile is 2 x 2 a thread, and each T-deep product into a
// (T, width) accumulator in shared memory is 4 rows x `width / 32`
// columns a thread.
//
// What bounds it on an H100: five products a tile (Q K^T, dO V^T,
// P^T dO, dS^T Q, dS K), each 2 * hd FLOPs per live (query head, key)
// pair, against one read of q, k, v, out, dout and one write of dq, dk,
// dv: at the training shapes (sequences of 128-4,096, heads of 64-256)
// that is hundreds of FLOPs a byte, so operations bound it.  This body
// does eight products a tile (the recompute of S in (a)'s loop 1 and of
// S and dP in both passes) on the CUDA cores' 67 TFLOP/s, not the
// tensor cores' 989: a tensor-core body is the later work.
//
// Head widths (hd, hd_v): (32, 32), (64, 64), (128, 128), (256, 256),
// (192, 128) (MLA decompressed) and (80, 64) (the DeepSeek-V2 smoke
// config's MLA); these are the only list of them: for any other pair
// the launch returns NO_WIDTHS (-1) before launching anything, and the
// wrapper raises ValueError.
#include "paged_attention.cuh"

namespace {

constexpr int NO_WIDTHS = -1;  // (hd, hd_v) not instantiated
constexpr int THREADS = 256;
constexpr int T = 32;        // query positions and keys a tile
constexpr int LDS = T + 1;   // row stride of a score tile

using paged_attn::load_f;
using paged_attn::NEG_INF;
using paged_attn::store_f;
using paged_attn::warp_max;
using paged_attn::warp_sum;

// f32 row stride of a tile of `width` values a row
__host__ __device__ constexpr int ld(int width) { return width + 4; }

// rows [0, T) of a tile, row i at src + i * stride (elements); rows at or
// past n_rows are zero
template <typename E, int W>
__device__ __forceinline__ void load_tile(float* dst, const E* src,
                                          long long stride, int n_rows) {
  for (int idx = threadIdx.x; idx < T * W; idx += THREADS) {
    const int i = idx / W, d = idx - i * W;
    dst[i * ld(W) + d] = i < n_rows ? load_f(src, i * stride + d) : 0.f;
  }
}

// s[a][c] = X[r + 16a] . Y[c0 + 16c] over W values, r = tid / 16,
// c0 = tid % 16: a thread's 2 x 2 entries of a T x T product
template <int W>
__device__ __forceinline__ void dots(const float* X, const float* Y,
                                     float (&s)[2][2]) {
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int e = 0; e < 2; ++e) s[a][e] = 0.f;
#pragma unroll 4
  for (int d = 0; d < W; d += 4) {
    float4 x[2], y[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      x[a] = *reinterpret_cast<const float4*>(X + (r + 16 * a) * ld(W) + d);
      y[a] = *reinterpret_cast<const float4*>(Y + (c + 16 * a) * ld(W) + d);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        s[a][e] += x[a].x * y[e].x + x[a].y * y[e].y + x[a].z * y[e].z +
                   x[a].w * y[e].w;
  }
}

// C[i][d] += sum_k A(k, i) * B[k][d] for i < T, d < W, where A(k, i) =
// M[k][i] (TRANS) or M[i][k], M a T x T score tile, B a (T, W) tile and C
// a (T, W) accumulator of row stride W.  Warp w holds rows w + 8a, lane l
// the columns l + 32c.
template <int W, bool TRANS>
__device__ __forceinline__ void accumulate(float* C, const float* M,
                                           const float* B) {
  constexpr int NC = (W + 31) / 32;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.f;
#pragma unroll 4
  for (int k = 0; k < T; ++k) {
    float av[4], bv[NC];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      av[a] = TRANS ? M[k * LDS + w + 8 * a] : M[(w + 8 * a) * LDS + k];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      bv[c] = d < W ? B[k * ld(W) + d] : 0.f;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[a][c] += av[a] * bv[c];
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < W) C[(w + 8 * a) * W + d] += acc[a][c];
    }
}

__device__ __forceinline__ bool live(int qpos, int kpos, int kv_len,
                                     int window, bool causal) {
  return kpos < kv_len && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// out[i * stride + d] = scale * acc[i][d] for i < n_rows
template <typename E, int W>
__device__ __forceinline__ void store_rows(E* out, long long stride,
                                           const float* acc, int n_rows,
                                           float scale) {
  for (int idx = threadIdx.x; idx < T * W; idx += THREADS) {
    const int i = idx / W, d = idx - i * W;
    if (i < n_rows) store_f(out, i * stride + d, scale * acc[i * W + d]);
  }
}

template <int HD, int HD_V>
struct Smem {
  // dq_kernel: Q, dO, K, V tiles, dQ, one score tile, m, 1/l, D
  static constexpr int dq_floats() {
    return T * ld(HD) * 2 + T * ld(HD_V) * 2 + T * HD + T * LDS + 3 * T;
  }
  // dkdv_kernel: K, V, Q, dO tiles, dK, dV, P and dS tiles, m, 1/l, D
  static constexpr int dkdv_floats() {
    return T * ld(HD) * 2 + T * ld(HD_V) * 2 + T * HD + T * HD_V +
           2 * T * LDS + 3 * T;
  }
};

// stats: m, then 1/l, then D, each (b, h, sq) f32
template <typename E, int HD, int HD_V>
__global__ void __launch_bounds__(THREADS)
    dq_kernel(const E* __restrict__ q, const E* __restrict__ k,
              const E* __restrict__ v, const E* __restrict__ out,
              const E* __restrict__ dout, const int* __restrict__ kv_len,
              E* __restrict__ dq, float* __restrict__ stats, int q_offset,
              int sq, int skv, int h, int kvh, int window, int causal_i,
              float scale) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + T * ld(HD);
  float* Ks = dOs + T * ld(HD_V);
  float* Vs = Ks + T * ld(HD);
  float* dQ = Vs + T * ld(HD_V);
  float* S = dQ + T * HD;
  float* m_s = S + T * LDS;
  float* il_s = m_s + T;
  float* D_s = il_s + T;

  const bool causal = causal_i != 0;
  const int bi = blockIdx.x, hh = blockIdx.y, q0 = blockIdx.z * T;
  const int g = hh / (h / kvh), n_q = min(T, sq - q0);
  const int len = min(kv_len[bi], skv);
  const long long qrow = ((long long)bi * sq + q0) * h + hh;
  const long long krow = (long long)bi * skv * kvh + g;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_tile<E, HD>(Qs, q + qrow * HD, (long long)h * HD, n_q);
  load_tile<E, HD_V>(dOs, dout + qrow * HD_V, (long long)h * HD_V, n_q);
  for (int idx = threadIdx.x; idx < T * HD; idx += THREADS) dQ[idx] = 0.f;
  // D_i = dO_i . O_i, one warp a row
  for (int i = w; i < T; i += THREADS / 32) {
    float x = 0.f;
    if (i < n_q)
      for (int d = lane; d < HD_V; d += 32)
        x += load_f(dout, (qrow + (long long)i * h) * HD_V + d) *
             load_f(out, (qrow + (long long)i * h) * HD_V + d);
    x = warp_sum(x);
    if (lane == 0) D_s[i] = x;
  }
  // the live keys of the tile's rows
  const int p_lo = q_offset + q0, p_hi = q_offset + q0 + n_q - 1;
  const int k_lo = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int k_hi = causal ? min(len, p_hi + 1) : len;

  // loop 1: each row's max and sum over its live keys (warp w owns rows
  // w + 8a; every lane keeps the row's values)
  float m_r[4], l_r[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) m_r[a] = NEG_INF, l_r[a] = 0.f;
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
  for (int k0 = k_lo; k0 < k_hi; k0 += T) {
    __syncthreads();
    load_tile<E, HD>(Ks, k + (krow + (long long)k0 * kvh) * HD,
                     (long long)kvh * HD, min(T, k_hi - k0));
    __syncthreads();
    float s[2][2];
    dots<HD>(Qs, Ks, s);
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = r + 16 * a, j = c + 16 * e;
        S[i * LDS + j] = i < n_q && live(p_lo + i, k0 + j, k_hi, window,
                                         causal)
                             ? s[a][e] * scale
                             : NEG_INF;
      }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float x = S[(w + 8 * a) * LDS + lane];
      const float m_new = fmaxf(m_r[a], warp_max(x));
      const float p = x == NEG_INF ? 0.f : expf(x - m_new);
      l_r[a] = l_r[a] * expf(m_r[a] - m_new) + warp_sum(p);
      m_r[a] = m_new;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = w + 8 * a;
      m_s[i] = m_r[a];
      il_s[i] = l_r[a] > 0.f ? 1.f / l_r[a] : 0.f;
      if (i < n_q) {
        const long long at = ((long long)bi * h + hh) * sq + q0 + i;
        const long long plane = (long long)gridDim.x * h * sq;
        stats[at] = m_s[i];
        stats[plane + at] = il_s[i];
        stats[2 * plane + at] = D_s[i];
      }
    }
  }
  // loop 2: P, dP, dS and dQ += dS K
  for (int k0 = k_lo; k0 < k_hi; k0 += T) {
    __syncthreads();
    const long long at = (krow + (long long)k0 * kvh);
    load_tile<E, HD>(Ks, k + at * HD, (long long)kvh * HD,
                     min(T, k_hi - k0));
    load_tile<E, HD_V>(Vs, v + at * HD_V, (long long)kvh * HD_V,
                       min(T, k_hi - k0));
    __syncthreads();
    float s[2][2], dp[2][2];
    dots<HD>(Qs, Ks, s);
    dots<HD_V>(dOs, Vs, dp);
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = r + 16 * a, j = c + 16 * e;
        const float p =
            i < n_q && live(p_lo + i, k0 + j, k_hi, window, causal)
                ? expf(s[a][e] * scale - m_s[i]) * il_s[i]
                : 0.f;
        S[i * LDS + j] = p * (dp[a][e] - D_s[i]);
      }
    __syncthreads();
    accumulate<HD, false>(dQ, S, Ks);
  }
  __syncthreads();
  store_rows<E, HD>(dq + qrow * HD, (long long)h * HD, dQ, n_q, scale);
}

template <typename E, int HD, int HD_V>
__global__ void __launch_bounds__(THREADS)
    dkdv_kernel(const E* __restrict__ q, const E* __restrict__ k,
                const E* __restrict__ v, const E* __restrict__ dout,
                const int* __restrict__ kv_len,
                const float* __restrict__ stats, E* __restrict__ dk,
                E* __restrict__ dv, int q_offset, int sq, int skv, int h,
                int kvh, int window, int causal_i, float scale) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + T * ld(HD);
  float* Qs = Vs + T * ld(HD_V);
  float* dOs = Qs + T * ld(HD);
  float* dK = dOs + T * ld(HD_V);
  float* dV = dK + T * HD;
  float* P = dV + T * HD_V;
  float* dS = P + T * LDS;
  float* m_s = dS + T * LDS;
  float* il_s = m_s + T;
  float* D_s = il_s + T;

  const bool causal = causal_i != 0;
  const int bi = blockIdx.x, g = blockIdx.y, k0 = blockIdx.z * T;
  const int rep = h / kvh, n_k = min(T, skv - k0);
  const int len = min(kv_len[bi], skv);
  const int k_end = min(k0 + T, len);       // live keys [k0, k_end)
  const long long krow = ((long long)bi * skv + k0) * kvh + g;
  const long long plane = (long long)gridDim.x * h * sq;

  for (int idx = threadIdx.x; idx < T * HD; idx += THREADS) dK[idx] = 0.f;
  for (int idx = threadIdx.x; idx < T * HD_V; idx += THREADS) dV[idx] = 0.f;
  if (k_end > k0) {
    load_tile<E, HD>(Ks, k + krow * HD, (long long)kvh * HD, k_end - k0);
    load_tile<E, HD_V>(Vs, v + krow * HD_V, (long long)kvh * HD_V,
                       k_end - k0);
    // the query positions that can see a key of the tile
    const int i_lo = causal ? max(0, k0 - q_offset) : 0;
    const int i_hi =
        window > 0 ? min(sq, k_end - 1 + window - q_offset) : sq;
    const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
    for (int hh = g * rep; hh < (g + 1) * rep; ++hh)
      for (int q0 = i_lo; q0 < i_hi; q0 += T) {
        const int n_q = min(T, i_hi - q0);
        const long long qrow = ((long long)bi * sq + q0) * h + hh;
        __syncthreads();
        load_tile<E, HD>(Qs, q + qrow * HD, (long long)h * HD, n_q);
        load_tile<E, HD_V>(dOs, dout + qrow * HD_V, (long long)h * HD_V,
                           n_q);
        if (threadIdx.x < T) {
          const int i = threadIdx.x;
          const long long at = ((long long)bi * h + hh) * sq + q0 + i;
          m_s[i] = i < n_q ? stats[at] : NEG_INF;
          il_s[i] = i < n_q ? stats[plane + at] : 0.f;
          D_s[i] = i < n_q ? stats[2 * plane + at] : 0.f;
        }
        __syncthreads();
        float s[2][2], dp[2][2];
        dots<HD>(Qs, Ks, s);
        dots<HD_V>(dOs, Vs, dp);
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = r + 16 * a, j = c + 16 * e;
            const float p =
                i < n_q && live(q_offset + q0 + i, k0 + j, k_end, window,
                                causal)
                    ? expf(s[a][e] * scale - m_s[i]) * il_s[i]
                    : 0.f;
            P[i * LDS + j] = p;
            dS[i * LDS + j] = p * (dp[a][e] - D_s[i]);
          }
        __syncthreads();
        accumulate<HD_V, true>(dV, P, dOs);
        accumulate<HD, true>(dK, dS, Qs);
      }
  }
  __syncthreads();
  store_rows<E, HD>(dk + krow * HD, (long long)kvh * HD, dK, n_k, scale);
  store_rows<E, HD_V>(dv + krow * HD_V, (long long)kvh * HD_V, dV, n_k,
                      1.f);
}

template <typename E, int HD, int HD_V>
int launch(const long long* args, float scale, cudaStream_t stream) {
  const E* q = reinterpret_cast<const E*>(args[0]);
  const E* k = reinterpret_cast<const E*>(args[1]);
  const E* v = reinterpret_cast<const E*>(args[2]);
  const E* out = reinterpret_cast<const E*>(args[3]);
  const E* dout = reinterpret_cast<const E*>(args[4]);
  const int* kv_len = reinterpret_cast<const int*>(args[5]);
  E* dq = reinterpret_cast<E*>(args[6]);
  E* dk = reinterpret_cast<E*>(args[7]);
  E* dv = reinterpret_cast<E*>(args[8]);
  float* stats = reinterpret_cast<float*>(args[9]);
  const int b = (int)args[10], q_offset = (int)args[11], sq = (int)args[12],
            skv = (int)args[13], h = (int)args[14], kvh = (int)args[15],
            window = (int)args[18], causal = (int)args[19];
  static unsigned set_dq = 0, set_dkdv = 0;
  cudaError_t err =
      paged_attn::allow_max_smem(dq_kernel<E, HD, HD_V>, &set_dq);
  if (err == cudaSuccess)
    err = paged_attn::allow_max_smem(dkdv_kernel<E, HD, HD_V>, &set_dkdv);
  if (err != cudaSuccess) return (int)err;
  const size_t dq_smem = sizeof(float) * Smem<HD, HD_V>::dq_floats();
  dq_kernel<E, HD, HD_V><<<dim3(b, h, (sq + T - 1) / T), THREADS, dq_smem,
                           stream>>>(q, k, v, out, dout, kv_len, dq, stats,
                                     q_offset, sq, skv, h, kvh, window,
                                     causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t dkdv_smem = sizeof(float) * Smem<HD, HD_V>::dkdv_floats();
  dkdv_kernel<E, HD, HD_V><<<dim3(b, kvh, (skv + T - 1) / T), THREADS,
                             dkdv_smem, stream>>>(
      q, k, v, dout, kv_len, stats, dk, dv, q_offset, sq, skv, h, kvh,
      window, causal, scale);
  return (int)cudaGetLastError();
}

template <typename E>
int with_widths(const long long* args, float scale, cudaStream_t stream) {
  const int hd = (int)args[16], hd_v = (int)args[17];
  if (hd == 32 && hd_v == 32) return launch<E, 32, 32>(args, scale, stream);
  if (hd == 64 && hd_v == 64) return launch<E, 64, 64>(args, scale, stream);
  if (hd == 128 && hd_v == 128)
    return launch<E, 128, 128>(args, scale, stream);
  if (hd == 256 && hd_v == 256)
    return launch<E, 256, 256>(args, scale, stream);
  if (hd == 192 && hd_v == 128)
    return launch<E, 192, 128>(args, scale, stream);
  if (hd == 80 && hd_v == 64) return launch<E, 80, 64>(args, scale, stream);
  return NO_WIDTHS;
}

}  // namespace

// One backward, its two launches on `stream`, the arguments packed as
// 64-bit integers, in order: q, k, v, out, dout, kv_len, dq, dk, dv,
// stats (3 * b * h * sq floats of scratch), b, q_offset, sq, skv, h, kvh,
// hd, hd_v, window, causal, dtype (0 = float32, 1 = bfloat16).  Every
// tensor is contiguous; q, k, v, out, dout and the gradients share the
// dtype.  Returns the cudaError_t of the launches (0 on success), or
// NO_WIDTHS for head widths without an instantiation.
extern "C" int chunked_prefill_attention_bwd_launch(const long long* args,
                                                    float scale,
                                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (args[20] == 0) return with_widths<float>(args, scale, s);
  if (args[20] == 1) return with_widths<__nv_bfloat16>(args, scale, s);
  return (int)cudaErrorInvalidValue;
}
