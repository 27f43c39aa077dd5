// Paged cross-attention decode (one query token per slot against the
// slot's read-only encoder pages) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/paged_cross_decode_attention.py
// (paged_cross_decode_attention -> pl.pallas_call): each slot's decode
// query attends every encoder token of its request through the slot's
// CROSS block table, non-causal, masked only by tok < enc_len: no
// window, no causal mask, no scatter (the encoder K/V was installed once
// at admission and never changes).
//
// Two launches, as paged_decode_attention.cu.  cross_decode_kernel, grid
// (slots, KV heads, splits): the block of (slot, KV head g, split) holds
// the rep query rows of the heads that read KV head g, so each cross page
// is read from device memory once for all of them, and walks the table
// slots [split * slots_per_split, (split + 1) * slots_per_split) with the
// shared body of paged_attention.cuh; it writes its partial softmax state
// to a workspace.  combine_splits (paged_attention.cuh) rescales the
// splits' partials and normalises.  The TPU kernel walked a slot's pages
// in one sequential grid dimension; the wrapper instead picks the splits
// so that slots x KV heads x splits fill the card's SMs at least twice
// over (Llama-3.2-Vision: 8 x 8 x 5 blocks of 20 table slots).
//
// Pages at or past enc_len are never read: the table's pad slots point at
// the scratch page.  A split with no live page leaves m = NEG_INF and
// weighs 0 in the combine; a slot with enc_len = 0 (an empty decode slot,
// every iteration) writes zeros, as the TPU kernel does when it skips
// every page.
//
// What bounds it on an H100: per (KV head, encoder token) it reads
// 2 * hd values of K/V and does 4 * hd * rep FLOPs, so at every served
// shape it is bound by the bytes of the cross pages (52.4 MB a launch for
// Llama-3.2-Vision's 8 slots x 1600 tokens, 16 us at 3.35 TB/s).  The
// splits put enough blocks in flight to keep many 16-byte page loads
// outstanding; TMA and tensor cores are later work.
#include "paged_attention.cuh"

namespace {

constexpr int THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    cross_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                        const T* __restrict__ v_pool,
                        const int* __restrict__ block_table,
                        const int* __restrict__ enc_lens,
                        float* __restrict__ part, int h, int kvh, int hd,
                        int hd_v, int page, int n_slots,
                        int slots_per_split, int tile_pages, float scale) {
  const int bi = blockIdx.x, g = blockIdx.y, split = blockIdx.z;
  const int rep = h / kvh;
  const int len = enc_lens[bi];
  float* my_part = part + ((long long)(bi * kvh + g) * gridDim.z + split)
                              * rep * (hd_v + 2);
  // non-causal, no window: the one query attends every key < enc_len,
  // so its position does not enter the masks
  paged_attn::attend<1, T>(q + (long long)bi * h * hd, k_pool, v_pool,
                           block_table + (long long)bi * n_slots, nullptr,
                           my_part, 1, 0, len, false, 0, h, kvh, g, hd,
                           hd_v, page, n_slots, split * slots_per_split,
                           (split + 1) * slots_per_split, tile_pages,
                           scale);
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* block_table, const void* enc_lens, void* part,
           void* out, int b, int h, int kvh, int hd, int hd_v, int page,
           int n_slots, int slots_per_split, int tile_pages, float scale,
           cudaStream_t stream) {
  const size_t smem =
      paged_attn::smem_bytes(h / kvh, hd, hd_v, tile_pages, page);
  cudaError_t err = cudaFuncSetAttribute(
      cross_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int splits = (n_slots + slots_per_split - 1) / slots_per_split;
  cross_decode_kernel<T><<<dim3(b, kvh, splits), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(block_table),
      static_cast<const int*>(enc_lens), static_cast<float*>(part), h, kvh,
      hd, hd_v, page, n_slots, slots_per_split, tile_pages, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_attn::combine_splits<T><<<dim3(b, kvh), THREADS, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out), h, kvh, hd_v,
      splits);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it).  part is
// a float32 workspace of b * kvh * splits * (h / kvh) * (hd_v + 2)
// values, splits = ceil(n_slots / slots_per_split).
// Returns the cudaError_t of the launches (0 on success).
extern "C" int paged_cross_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_table, const void* enc_lens, void* part, void* out,
    int b, int h, int kvh, int hd, int hd_v, int page, int n_slots,
    int slots_per_split, int tile_pages, float scale, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, block_table, enc_lens, part,
                         out, b, h, kvh, hd, hd_v, page, n_slots,
                         slots_per_split, tile_pages, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, block_table, enc_lens,
                                 part, out, b, h, kvh, hd, hd_v, page,
                                 n_slots, slots_per_split, tile_pages,
                                 scale, s);
  return (int)cudaErrorInvalidValue;
}
