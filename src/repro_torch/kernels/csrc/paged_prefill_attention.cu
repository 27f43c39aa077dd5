// Chunked-prefill attention over the shared KV page pool, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/paged_prefill_attention.py
// (paged_prefill_attention -> pl.pallas_call): the packed segments of one
// fixed-size prefill chunk attend (written prefix ++ this chunk) through
// per-segment block tables, causal, with an optional sliding window, or
// non-causally (the cross-attention read of a chunk).
//
// Grid: (segments, KV heads, q tiles of block_q positions).  The block
// of (segment, KV head g, q tile) holds the block_q * rep query rows of
// the rep heads that read KV head g, so every K/V page it reads serves
// all of them (the TPU grid instead ran one query head per step).  The
// TPU kernel's sequential page grid dimension becomes the loop over live
// slots inside the block; no state crosses blocks.  Any sq is accepted:
// the last q tile masks the ragged edge.
//
// What bounds it on an H100: at the served shapes (chunks of 512
// queries; qwen2's 14/2 heads of 64, Llama-3.2-Vision's 32/8 of 128 and
// its non-causal read of 1600 encoder keys) it does about 4 * hd FLOPs
// per (query head, key) against one read of each live page per
// (segment, q tile), so it is bound by operations, not bytes.  bf16
// inputs therefore run the tensor-core body (prefill_attention_tc.cuh):
// QK^T and PV as bf16 wgmma with f32 sums, K/V tiles streamed through a
// cp.async ring gathered through the block table, the softmax in
// registers, blocks of 128 query rows where the grid still fills the
// card, and each block's keys split in shares where it does not (the
// wrapper's launch plan picks both).  f32 inputs keep
// the CUDA-core body (paged_attention.cuh): tensor cores would take them
// as TF32, about three decimal digits, where the f32 served runs are
// held token-identical to the CPU.
#include "prefill_attention_tc.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    prefill_kernel(const float* __restrict__ q,
                   const float* __restrict__ k_pool,
                   const float* __restrict__ v_pool,
                   const int* __restrict__ block_table,
                   const int* __restrict__ kv_len,
                   const int* __restrict__ q_offset, float* __restrict__ out,
                   int sq, int h, int kvh, int hd, int hd_v, int page,
                   int n_slots, int block_q, int tile_pages, int window,
                   int causal, float scale) {
  const int seg = blockIdx.x, g = blockIdx.y, qt = blockIdx.z;
  const int q0 = qt * block_q;
  const int n_q = min(block_q, sq - q0);
  const long long row0 = (long long)seg * sq + q0;
  paged_attn::attend<4, float>(q + row0 * h * hd, k_pool, v_pool,
                               block_table + (long long)seg * n_slots,
                               out + row0 * h * hd_v, n_q,
                               q_offset[seg] + q0, kv_len[seg], causal != 0,
                               window, h, kvh, g, hd, hd_v, page, n_slots,
                               tile_pages, scale);
}

template <int HD, int HD_V>
__global__ void __launch_bounds__(prefill_tc::max_threads<HD, HD_V>())
    prefill_tc_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k_pool,
                      const __nv_bfloat16* __restrict__ v_pool,
                      const int* __restrict__ block_table,
                      const int* __restrict__ kv_len,
                      const int* __restrict__ q_offset,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ part, int segs, int sq, int h,
                      int kvh, int page, int n_slots, int block_q,
                      int splits, int window, int causal, float scale) {
  // z runs over (q tile, split), the last q tiles (the longest causal
  // walks) first
  const int z = gridDim.z - 1 - blockIdx.z;
  const int seg = blockIdx.x, g = blockIdx.y, qt = z / splits;
  const int split = z - qt * splits;
  const int q0 = qt * block_q;
  const int n_q = min(block_q, sq - q0);
  const long long row0 = (long long)seg * sq + q0;
  float* p = part == nullptr
                 ? nullptr
                 : part + ((long long)split * segs * sq + row0) * h *
                              (HD_V + 2);
  prefill_tc::attend<HD, HD_V>(
      q + row0 * h * HD, k_pool, v_pool,
      block_table + (long long)seg * n_slots, out + row0 * h * HD_V, p, n_q,
      q_offset[seg] + q0, kv_len[seg], causal != 0, window, h, kvh, g, page,
      n_slots, split, splits, scale);
}

int launch_f32(const void* q, const void* k_pool, const void* v_pool,
               const void* block_table, const void* kv_len,
               const void* q_offset, void* out, int segs, int sq, int h,
               int kvh, int hd, int hd_v, int page, int n_slots, int block_q,
               int tile_pages, int window, int causal, float scale,
               cudaStream_t stream) {
  static unsigned smem_set = 0;
  cudaError_t err = paged_attn::allow_max_smem(prefill_kernel, &smem_set);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = paged_attn::smem_bytes(block_q * (h / kvh), hd, hd_v,
                                            tile_pages, page);
  const dim3 grid(segs, kvh, (sq + block_q - 1) / block_q);
  prefill_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), static_cast<const int*>(block_table),
      static_cast<const int*>(kv_len), static_cast<const int*>(q_offset),
      static_cast<float*>(out), sq, h, kvh, hd, hd_v, page, n_slots, block_q,
      tile_pages, window, causal, scale);
  return (int)cudaGetLastError();
}

template <int HD, int HD_V>
int launch_tc(const void* q, const void* k_pool, const void* v_pool,
              const void* block_table, const void* kv_len,
              const void* q_offset, void* out, void* part, int segs,
              int sq, int h, int kvh, int page, int n_slots, int block_q,
              int splits, int window, int causal, float scale,
              cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  static unsigned smem_set = 0;
  cudaError_t err = paged_attn::allow_max_smem(prefill_tc_kernel<HD, HD_V>,
                                               &smem_set);
  if (err != cudaSuccess) return (int)err;
  // consumer warpgroups of 64 rows, then the copy warp
  const int warps = 4 * ((block_q * (h / kvh) + 63) / 64);
  if (32 * (warps + 1) > prefill_tc::max_threads<HD, HD_V>())
    return (int)cudaErrorInvalidValue;
  const size_t smem = prefill_tc::Layout<HD, HD_V>::smem_bytes(warps);
  const dim3 grid(segs, kvh, (sq + block_q - 1) / block_q * splits);
  float* p = splits > 1 ? static_cast<float*>(part) : nullptr;
  prefill_tc_kernel<HD, HD_V><<<grid, 32 * (warps + 1), smem,
                                      stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),
      static_cast<const bf16*>(v_pool), static_cast<const int*>(block_table),
      static_cast<const int*>(kv_len), static_cast<const int*>(q_offset),
      static_cast<bf16*>(out), p, segs, sq, h, kvh, page, n_slots, block_q,
      splits, window, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || p == nullptr) return (int)err;
  return prefill_tc::combine(p, static_cast<bf16*>(out),
                             (long long)segs * sq * h, HD_V, splits, stream);
}

}  // namespace

// One launch, its arguments packed as 64-bit integers (one ctypes
// argument in place of 22, several microseconds less a call), in order:
// q, k_pool, v_pool, block_table, kv_len, q_offset, out, part (0: none),
// segs, sq, h, kvh, hd, hd_v, page, n_slots, block_q, tile_pages, splits,
// window, causal, dtype.  dtype: 0 = float32 (the CUDA-core body;
// tile_pages pages a K/V tile), 1 = bfloat16 (the tensor-core body, hd
// and hd_v each 32, 64 or 128, both 256, or 192 with 128; tile_pages
// unused; with
// splits > 1 each block walks one of `splits` shares of its keys and
// part, splits * segs * sq * h * (hd_v + 2) floats, takes the partial
// states a second launch combines).  q, pools and out share the dtype.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int paged_prefill_attention_launch(const long long* args,
                                              float scale, void* stream) {
  const void* q = reinterpret_cast<const void*>(args[0]);
  const void* k_pool = reinterpret_cast<const void*>(args[1]);
  const void* v_pool = reinterpret_cast<const void*>(args[2]);
  const void* block_table = reinterpret_cast<const void*>(args[3]);
  const void* kv_len = reinterpret_cast<const void*>(args[4]);
  const void* q_offset = reinterpret_cast<const void*>(args[5]);
  void* out = reinterpret_cast<void*>(args[6]);
  void* part = reinterpret_cast<void*>(args[7]);
  const int segs = (int)args[8], sq = (int)args[9], h = (int)args[10],
            kvh = (int)args[11], hd = (int)args[12], hd_v = (int)args[13],
            page = (int)args[14], n_slots = (int)args[15],
            block_q = (int)args[16], tile_pages = (int)args[17],
            splits = (int)args[18], window = (int)args[19],
            causal = (int)args[20], dtype = (int)args[21];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(q, k_pool, v_pool, block_table, kv_len, q_offset, out,
                      segs, sq, h, kvh, hd, hd_v, page, n_slots, block_q,
                      tile_pages, window, causal, scale, s);
  if (dtype == 1)
    return prefill_tc::with_widths(hd, hd_v, [&](auto hd_c, auto hd_v_c) {
      return launch_tc<decltype(hd_c)::value, decltype(hd_v_c)::value>(
          q, k_pool, v_pool, block_table, kv_len, q_offset, out, part, segs,
          sq, h, kvh, page, n_slots, block_q, splits, window, causal, scale,
          s);
    });
  return (int)cudaErrorInvalidValue;
}
