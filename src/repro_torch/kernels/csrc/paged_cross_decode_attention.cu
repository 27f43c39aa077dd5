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
// It runs the decode body of decode_attention.cuh with no window (the
// query's position does not enter the mask), so every cross table of a
// batch splits evenly: Llama-3.2-Vision's 8 slots x 8 KV heads take 5
// shares of 20 pages each.  On an H100 it is bound by the bytes of the
// cross pages (52.4 MB a launch for Llama-3.2-Vision's 8 slots x 1600
// tokens, 16 us at 3.35 TB/s); the body's header says what it does about
// that.  Pages at or past enc_len are never read: the table's pad slots
// point at the scratch page.  A slot with enc_len = 0 (an empty decode
// slot, every iteration) writes zeros, as the TPU kernel does when it
// skips every page.
#include "decode_attention.cuh"

// One launch, its arguments packed as in decode_attn::launch (lens: the
// encoder tokens a slot; window 0).  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int paged_cross_decode_attention_launch(const long long* args,
                                                   float scale,
                                                   void* stream) {
  return decode_attn::launch(args, scale, stream);
}
