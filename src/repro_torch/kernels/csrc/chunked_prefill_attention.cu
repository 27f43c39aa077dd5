// Dense chunked-prefill attention (per-request KV caches) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/chunked_prefill_attention.py
// (chunked_prefill_attention -> pl.pallas_call): a chunk of sq queries of
// each of b requests, all starting at one shared absolute position
// q_offset, attends its request's dense cache (skv, kvh, hd) with the
// chunk already written at [q_offset, q_offset + sq): keys k_pos <
// kv_len[i], causal, with an optional sliding window.  hd_v (the V
// cache's last dim) may differ from hd.
//
// Grid: (requests, KV heads, q tiles of block_q positions), as the paged
// prefill kernel.  The block of (request i, KV head g, q tile) holds the
// block_q * rep query rows of the rep heads that read KV head g, and runs
// the shared prefill body over request i's cache viewed as a pool of
// one-token pages with the identity block table: the body's live range
// [p_lo, p_hi) is then exact to the token (keys past kv_len, keys
// acausal for every row of the tile, keys wholly out of the window are
// never read), and its tiles of 64 tokens need no multiple of the cache
// length: the Pallas kernel's sq % block_q == 0 and skv % block_kv == 0
// do not apply.  The TPU grid's sequential kv-block dimension becomes
// the loop over live tiles inside the block; no state crosses blocks.  A
// row with no key it may attend (kv_len = 0, or a pad query more than
// `window` past kv_len) writes 0; the Pallas kernel writes 0 only when
// no kv block is live, and a tiling-dependent mean otherwise.
//
// What bounds it on an H100: at the shapes phase 2d of chip_smoke.py
// gives it (8 requests, sq 512 at q_offset 512, skv 2048, qwen2's 14/2
// heads of 64 or Llama-3.2-Vision's 32/8 of 128) it does about 4 * hd
// FLOPs per (query head, live key) against one read of each live key
// per q tile, so it is bound by operations, not bytes.  bf16 inputs
// therefore run the tensor-core body of the paged kernel
// (prefill_attention_tc.cuh: bf16 wgmma with f32 sums, a cp.async K/V
// ring, the softmax in registers, 128-row blocks where the grid still
// fills the card, split keys where it does not); f32 inputs keep the
// CUDA-core body
// (paged_attention.cuh), since TF32 tensor cores keep about three
// decimal digits.
#include "prefill_attention_tc.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    chunked_prefill_kernel(const float* __restrict__ q,
                           const float* __restrict__ k_cache,
                           const float* __restrict__ v_cache,
                           const int* __restrict__ kv_len,
                           float* __restrict__ out, int q_offset, int sq,
                           int skv, int h, int kvh, int hd, int hd_v,
                           int block_q, int tile_tok, int window, int causal,
                           float scale) {
  const int bi = blockIdx.x, g = blockIdx.y, qt = blockIdx.z;
  const int q0 = qt * block_q;
  const int n_q = min(block_q, sq - q0);
  const long long row0 = (long long)bi * sq + q0;
  // request bi's cache: skv one-token pages, identity table (bt null)
  paged_attn::attend<4, float>(q + row0 * h * hd,
                               k_cache + (long long)bi * skv * kvh * hd,
                               v_cache + (long long)bi * skv * kvh * hd_v,
                               nullptr, out + row0 * h * hd_v, n_q,
                               q_offset + q0, kv_len[bi], causal != 0, window,
                               h, kvh, g, hd, hd_v, 1, skv, tile_tok, scale);
}

template <int HD, int HD_V>
__global__ void __launch_bounds__(prefill_tc::THREADS_MAX)
    chunked_prefill_tc_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k_cache,
                              const __nv_bfloat16* __restrict__ v_cache,
                              const int* __restrict__ kv_len,
                              __nv_bfloat16* __restrict__ out,
                              float* __restrict__ part, int b, int q_offset,
                              int sq, int skv, int h, int kvh, int block_q,
                              int splits, int window, int causal,
                              float scale) {
  // z runs over (q tile, split), the last q tiles first
  const int z = gridDim.z - 1 - blockIdx.z;
  const int bi = blockIdx.x, g = blockIdx.y, qt = z / splits;
  const int split = z - qt * splits;
  const int q0 = qt * block_q;
  const int n_q = min(block_q, sq - q0);
  const long long row0 = (long long)bi * sq + q0;
  float* p = part == nullptr
                 ? nullptr
                 : part + ((long long)split * b * sq + row0) * h * (HD_V + 2);
  prefill_tc::attend<HD, HD_V>(
      q + row0 * h * HD, k_cache + (long long)bi * skv * kvh * HD,
      v_cache + (long long)bi * skv * kvh * HD_V, nullptr,
      out + row0 * h * HD_V, p, n_q, q_offset + q0, kv_len[bi], causal != 0,
      window, h, kvh, g, 1, skv, split, splits, scale);
}

int launch_f32(const void* q, const void* k_cache, const void* v_cache,
               const void* kv_len, void* out, int b, int q_offset, int sq,
               int skv, int h, int kvh, int hd, int hd_v, int block_q,
               int tile_tok, int window, int causal, float scale,
               cudaStream_t stream) {
  static unsigned smem_set = 0;
  cudaError_t err =
      paged_attn::allow_max_smem(chunked_prefill_kernel, &smem_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = paged_attn::smem_bytes(block_q * (h / kvh), hd, hd_v,
                                            tile_tok, 1);
  const dim3 grid(b, kvh, (sq + block_q - 1) / block_q);
  chunked_prefill_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_cache),
      static_cast<const float*>(v_cache), static_cast<const int*>(kv_len),
      static_cast<float*>(out), q_offset, sq, skv, h, kvh, hd, hd_v, block_q,
      tile_tok, window, causal, scale);
  return (int)cudaGetLastError();
}

template <int HD, int HD_V>
int launch_tc(const void* q, const void* k_cache, const void* v_cache,
              const void* kv_len, void* out, void* part, int b,
              int q_offset, int sq, int skv, int h, int kvh, int block_q,
              int splits, int window, int causal, float scale,
              cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  static unsigned smem_set = 0;
  cudaError_t err = paged_attn::allow_max_smem(
      chunked_prefill_tc_kernel<HD, HD_V>, &smem_set);
  if (err != cudaSuccess) return (int)err;
  // consumer warpgroups of 64 rows, then the copy warp
  const int warps = 4 * ((block_q * (h / kvh) + 63) / 64);
  if (warps > prefill_tc::MAX_WARPS) return (int)cudaErrorInvalidValue;
  const size_t smem = prefill_tc::Layout<HD, HD_V>::smem_bytes(warps);
  const dim3 grid(b, kvh, (sq + block_q - 1) / block_q * splits);
  float* p = splits > 1 ? static_cast<float*>(part) : nullptr;
  chunked_prefill_tc_kernel<HD, HD_V><<<grid, 32 * (warps + 1), smem,
                                      stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_cache),
      static_cast<const bf16*>(v_cache), static_cast<const int*>(kv_len),
      static_cast<bf16*>(out), p, b, q_offset, sq, skv, h, kvh, block_q,
      splits, window, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || p == nullptr) return (int)err;
  return prefill_tc::combine(p, static_cast<bf16*>(out),
                             (long long)b * sq * h, HD_V, splits, stream);
}

}  // namespace

// One launch, its arguments packed as 64-bit integers (one ctypes
// argument in place of 20, several microseconds less a call), in order:
// q, k_cache, v_cache, kv_len, out, part (0: none), b, q_offset, sq, skv,
// h, kvh, hd, hd_v, block_q, tile_tok, splits, window, causal, dtype.
// dtype: 0 = float32 (the CUDA-core body, tile_tok keys a tile), 1 =
// bfloat16 (the tensor-core body, hd and hd_v each 32, 64 or 128;
// tile_tok unused; with splits > 1 each block walks one of `splits`
// shares of its keys and part, splits * b * sq * h * (hd_v + 2) floats,
// takes the partial states a second launch combines).  q, caches and
// out share the dtype.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int chunked_prefill_attention_launch(const long long* args,
                                                float scale, void* stream) {
  const void* q = reinterpret_cast<const void*>(args[0]);
  const void* k_cache = reinterpret_cast<const void*>(args[1]);
  const void* v_cache = reinterpret_cast<const void*>(args[2]);
  const void* kv_len = reinterpret_cast<const void*>(args[3]);
  void* out = reinterpret_cast<void*>(args[4]);
  void* part = reinterpret_cast<void*>(args[5]);
  const int b = (int)args[6], q_offset = (int)args[7], sq = (int)args[8],
            skv = (int)args[9], h = (int)args[10], kvh = (int)args[11],
            hd = (int)args[12], hd_v = (int)args[13], block_q = (int)args[14],
            tile_tok = (int)args[15], splits = (int)args[16],
            window = (int)args[17], causal = (int)args[18],
            dtype = (int)args[19];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(q, k_cache, v_cache, kv_len, out, b, q_offset, sq, skv,
                      h, kvh, hd, hd_v, block_q, tile_tok, window, causal,
                      scale, s);
  if (dtype == 1)
    return prefill_tc::with_widths(hd, hd_v, [&](auto hd_c, auto hd_v_c) {
      return launch_tc<decltype(hd_c)::value, decltype(hd_v_c)::value>(
          q, k_cache, v_cache, kv_len, out, part, b, q_offset, sq, skv, h,
          kvh, block_q, splits, window, causal, scale, s);
    });
  return (int)cudaErrorInvalidValue;
}
