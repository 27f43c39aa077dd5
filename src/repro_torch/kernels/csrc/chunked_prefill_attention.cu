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
// the shared body of paged_attention.cuh over request i's cache viewed as
// a pool of one-token pages with the identity block table: the body's
// live range [p_lo, p_hi) is then exact to the token (keys past kv_len,
// keys acausal for every row of the tile, keys wholly out of the window
// are never read), and its tiles of 64 tokens need no multiple of the
// cache length: the Pallas kernel's sq % block_q == 0 and skv % block_kv
// == 0 do not apply.  The TPU grid's sequential kv-block dimension
// becomes the loop over live tiles inside the block; no state crosses
// blocks.  A row with no key it may attend (kv_len = 0, or a pad query
// more than `window` past kv_len) writes 0; the Pallas kernel writes 0
// only when no kv block is live, and a tiling-dependent mean otherwise.
//
// What bounds it on an H100: at the shapes phase 2d of chip_smoke.py
// gives it (8 requests, sq 512 at q_offset 512, skv 2048, qwen2's 14/2
// heads of 64) it does about 4 * hd FLOPs per (query head, live key)
// against one read of each live key per q tile, so it is bound by
// operations, not bytes.  This first version does them as f32 FMAs from
// shared memory on the CUDA cores, like the paged kernels; wgmma tiles
// and TMA loads are the redesign's work.
#include "paged_attention.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    chunked_prefill_kernel(const T* __restrict__ q,
                           const T* __restrict__ k_cache,
                           const T* __restrict__ v_cache,
                           const int* __restrict__ kv_len, T* __restrict__ out,
                           int q_offset, int sq, int skv, int h, int kvh,
                           int hd, int hd_v, int block_q, int tile_tok,
                           int window, int causal, float scale) {
  const int bi = blockIdx.x, g = blockIdx.y, qt = blockIdx.z;
  const int q0 = qt * block_q;
  const int n_q = min(block_q, sq - q0);
  const long long row0 = (long long)bi * sq + q0;
  // request bi's cache: skv one-token pages, identity table (bt null)
  paged_attn::attend<4, T>(q + row0 * h * hd,
                           k_cache + (long long)bi * skv * kvh * hd,
                           v_cache + (long long)bi * skv * kvh * hd_v,
                           nullptr, out + row0 * h * hd_v, nullptr, n_q,
                           q_offset + q0, kv_len[bi], causal != 0, window, h,
                           kvh, g, hd, hd_v, 1, skv, 0, skv, tile_tok, scale);
}

template <typename T>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* kv_len, void* out, int b, int q_offset, int sq,
           int skv, int h, int kvh, int hd, int hd_v, int block_q,
           int tile_tok, int window, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = paged_attn::smem_bytes(block_q * (h / kvh), hd, hd_v,
                                            tile_tok, 1);
  cudaError_t err = cudaFuncSetAttribute(
      chunked_prefill_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b, kvh, (sq + block_q - 1) / block_q);
  chunked_prefill_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), static_cast<const int*>(kv_len),
      static_cast<T*>(out), q_offset, sq, skv, h, kvh, hd, hd_v, block_q,
      tile_tok, window, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, caches and out share it).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int chunked_prefill_attention_launch(
    const void* q, const void* k_cache, const void* v_cache,
    const void* kv_len, void* out, int b, int q_offset, int sq, int skv,
    int h, int kvh, int hd, int hd_v, int block_q, int tile_tok, int window,
    int causal, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_cache, v_cache, kv_len, out, b, q_offset, sq,
                         skv, h, kvh, hd, hd_v, block_q, tile_tok, window,
                         causal, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_cache, v_cache, kv_len, out, b,
                                 q_offset, sq, skv, h, kvh, hd, hd_v, block_q,
                                 tile_tok, window, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
