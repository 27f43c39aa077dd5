// Paged decode attention (one query token per slot) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/paged_decode_attention.py
// (paged_decode_attention -> pl.pallas_call): each slot's token attends
// the slot's live pages through its block-table row, masked by
// tok < lens and, with a window, tok > lens - 1 - window.  The TPU kernel
// walked a slot's pages in one sequential grid dimension, one query head
// a step.
//
// It runs the decode body of decode_attention.cuh, which is bound by the
// bytes of the live pages on an H100 and says what it does about that:
// one block per (slot, KV head, split of the slot's live pages), the rep
// query heads of a KV head sharing each page it reads, the pages
// streamed through per-warp cp.async rings, and the splits combined by
// the last block of a (slot, KV head) in the same launch.  Pages past
// lens and pages slid out of the window are never read: their table
// slots may point at freed or scratch pages.  A slot with lens = 0 (an
// empty decode slot, every iteration) writes zeros.
#include "decode_attention.cuh"

// One launch, its arguments packed as in decode_attn::launch (window:
// the sliding window in tokens, 0 = none).  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int paged_decode_attention_launch(const long long* args,
                                             float scale, void* stream) {
  return decode_attn::launch(args, scale, stream);
}
