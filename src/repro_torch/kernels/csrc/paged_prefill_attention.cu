// Chunked-prefill attention over the shared KV page pool, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/paged_prefill_attention.py
// (paged_prefill_attention -> pl.pallas_call): the packed segments of one
// fixed-size prefill chunk attend (written prefix ++ this chunk) through
// per-segment block tables, causal, with an optional sliding window.
//
// Grid: (segments, KV heads, q tiles of block_q positions).  The block
// of (segment, KV head g, q tile) holds the block_q * rep query rows of
// the rep heads that read KV head g, so every K/V page it reads serves
// all of them (the TPU grid instead ran one query head per step).  The
// TPU kernel's sequential page grid dimension becomes the loop over live
// slots inside the block (paged_attention.cuh); no state crosses blocks.
// Any sq is accepted: the last q tile masks the ragged edge.
//
// What bounds it on an H100: at the served shapes (chunk 512, rep 7,
// hd 64, bf16) the work is about 2 * 2 * hd FLOPs per (query head, key)
// against one read of each live page per (segment, q tile), so it is
// bound by operations, not bytes.  This first version does them as f32
// FMAs from shared memory on the CUDA cores (67 TFLOP/s peak, far less
// in this loop), not on the tensor cores; wgmma tiles are the next step.
#include "paged_attention.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                   const T* __restrict__ v_pool,
                   const int* __restrict__ block_table,
                   const int* __restrict__ kv_len,
                   const int* __restrict__ q_offset, T* __restrict__ out,
                   int sq, int h, int kvh, int hd, int hd_v, int page,
                   int n_slots, int block_q, int tile_pages, int window,
                   int causal, float scale) {
  const int seg = blockIdx.x, g = blockIdx.y, qt = blockIdx.z;
  const int q0 = qt * block_q;
  const int n_q = min(block_q, sq - q0);
  const long long row0 = (long long)seg * sq + q0;
  paged_attn::attend<4, T>(q + row0 * h * hd, k_pool, v_pool,
                        block_table + (long long)seg * n_slots,
                        out + row0 * h * hd_v, nullptr, n_q,
                        q_offset[seg] + q0, kv_len[seg], causal != 0,
                        window, h, kvh, g, hd, hd_v, page, n_slots, 0,
                        n_slots, tile_pages, scale);
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* block_table, const void* kv_len,
           const void* q_offset, void* out, int segs, int sq, int h,
           int kvh, int hd, int hd_v, int page, int n_slots, int block_q,
           int tile_pages, int window, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = paged_attn::smem_bytes(block_q * (h / kvh), hd, hd_v,
                                            tile_pages, page);
  cudaError_t err = cudaFuncSetAttribute(
      prefill_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(segs, kvh, (sq + block_q - 1) / block_q);
  prefill_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(block_table),
      static_cast<const int*>(kv_len), static_cast<const int*>(q_offset),
      static_cast<T*>(out), sq, h, kvh, hd, hd_v, page, n_slots, block_q,
      tile_pages, window, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int paged_prefill_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_table, const void* kv_len, const void* q_offset,
    void* out, int segs, int sq, int h, int kvh, int hd, int hd_v, int page,
    int n_slots, int block_q, int tile_pages, int window, int causal,
    float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, block_table, kv_len, q_offset,
                         out, segs, sq, h, kvh, hd, hd_v, page, n_slots,
                         block_q, tile_pages, window, causal, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, block_table, kv_len,
                                 q_offset, out, segs, sq, h, kvh, hd, hd_v,
                                 page, n_slots, block_q, tile_pages, window,
                                 causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
