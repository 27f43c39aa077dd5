// Paged decode attention (one query token per slot) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/paged_decode_attention.py
// (paged_decode_attention -> pl.pallas_call): each slot's token attends
// the slot's live pages through its block-table row, masked by
// tok < lens and, with a window, tok > lens - 1 - window.
//
// Two launches.  decode_kernel, grid (slots, KV heads, splits): the block
// of (slot, KV head g, split) holds the rep query rows of the heads that
// read KV head g, so each live page is read from device memory once for
// all of them (paged_attention.cuh), and covers only the block-table
// slots [split * slots_per_split, (split + 1) * slots_per_split).  It
// writes its partial softmax state (m, l, unnormalised acc) to a
// workspace.  combine_splits (paged_attention.cuh), grid (slots, KV
// heads), rescales the splits' partials by exp(m_split - max m) and
// normalises.  The TPU kernel instead walked all of a slot's pages in one
// sequential grid dimension; on the card that left one block per (slot,
// KV head), 16 at the served shapes, for 132 SMs.
//
// Pages past lens and pages slid out of the window are never read: their
// table slots may point at freed or scratch pages.  A split with no live
// page leaves m = NEG_INF and weighs 0 in the combine; a slot with
// lens = 0 (an empty decode slot, every iteration) writes zeros.
//
// What bounds it on an H100: decode does about 4 * hd FLOPs per
// (query head, key) against 2 * hd * bytes of K/V per (KV head, key), so
// it is bound by the bytes of the live pages (3.35 TB/s).  The splits
// put enough blocks in flight to have many page loads outstanding.
#include "paged_attention.cuh"

namespace {

constexpr int THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                  const T* __restrict__ v_pool,
                  const int* __restrict__ block_table,
                  const int* __restrict__ lens, float* __restrict__ part,
                  int h, int kvh, int hd, int hd_v, int page, int n_slots,
                  int slots_per_split, int tile_pages, int window,
                  float scale) {
  const int bi = blockIdx.x, g = blockIdx.y, split = blockIdx.z;
  const int rep = h / kvh;
  const int len = lens[bi];
  float* my_part = part + ((long long)(bi * kvh + g) * gridDim.z + split)
                              * rep * (hd_v + 2);
  // the slot's one query sits at position len - 1 and attends every
  // key < len: causality adds nothing beyond the length mask
  paged_attn::attend<1, T>(q + (long long)bi * h * hd, k_pool, v_pool,
                        block_table + (long long)bi * n_slots, nullptr,
                        my_part, 1, len - 1, len, false, window, h, kvh, g,
                        hd, hd_v, page, n_slots, split * slots_per_split,
                        (split + 1) * slots_per_split, tile_pages, scale);
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* block_table, const void* lens, void* part, void* out,
           int b, int h, int kvh, int hd, int hd_v, int page, int n_slots,
           int slots_per_split, int tile_pages, int window, float scale,
           cudaStream_t stream) {
  const size_t smem =
      paged_attn::smem_bytes(h / kvh, hd, hd_v, tile_pages, page);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int splits = (n_slots + slots_per_split - 1) / slots_per_split;
  decode_kernel<T><<<dim3(b, kvh, splits), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(block_table),
      static_cast<const int*>(lens), static_cast<float*>(part), h, kvh, hd,
      hd_v, page, n_slots, slots_per_split, tile_pages, window, scale);
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
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_table, const void* lens, void* part, void* out, int b,
    int h, int kvh, int hd, int hd_v, int page, int n_slots,
    int slots_per_split, int tile_pages, int window, float scale, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, block_table, lens, part, out, b,
                         h, kvh, hd, hd_v, page, n_slots, slots_per_split,
                         tile_pages, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, block_table, lens, part,
                                 out, b, h, kvh, hd, hd_v, page, n_slots,
                                 slots_per_split, tile_pages, window, scale,
                                 s);
  return (int)cudaErrorInvalidValue;
}
