"""Fixed-size chunk partition/pad/merge (paper §3.3.3, Fig. 7).

Scheduled requests' prompt tokens are sliced and merged, in scheduling
order, into chunks of exactly ``ChunkSize`` tokens; the final chunk is
zero-padded.  Each chunk records its member segments so the engine can
write each request's KV to the right cache region and track per-request
prefill progress ("last prefilled token position", §3.3.3).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

DEFAULT_CHUNK_SIZE = 512  # accelerator-saturate threshold for OPT-13B (§2.1)


@dataclasses.dataclass(frozen=True)
class Segment:
    """A slice of one request inside a chunk."""
    rid: str
    req_start: int        # first prompt-token index of this slice
    chunk_start: int      # position inside the chunk
    length: int


@dataclasses.dataclass(frozen=True)
class Chunk:
    index: int
    segments: Tuple[Segment, ...]
    pad: int              # trailing zero-pad tokens

    @property
    def tokens(self) -> int:
        return sum(s.length for s in self.segments)


def partition(scheduled: Sequence[Tuple[str, int]],
              chunk_size: int = DEFAULT_CHUNK_SIZE,
              starts: Optional[Dict[str, int]] = None) -> List[Chunk]:
    """scheduled: ordered (rid, prompt_len) pairs -> list of Chunks.

    ``starts`` maps rid -> first prompt-token index to prefill (default
    0): the prefix cache skips a request's cached leading pages, so its
    segments begin at ``starts[rid]`` and only the uncached suffix is
    chunked (``req_start`` stays an absolute prompt position — the KV
    write/attention arithmetic is unchanged).

    Invariants (property-tested):
      * token conservation: sum of segment lengths == sum of
        (prompt_len - start)
      * order preservation: segments appear in scheduling order, and a
        request's slices are contiguous and in order
      * every chunk except possibly the last is exactly chunk_size full
      * pad < chunk_size and only on the last chunk
    """
    chunks: List[Chunk] = []
    segs: List[Segment] = []
    fill = 0
    ci = 0
    for rid, plen in scheduled:
        done = min(starts.get(rid, 0), plen) if starts else 0
        while done < plen:
            take = min(plen - done, chunk_size - fill)
            segs.append(Segment(rid=rid, req_start=done, chunk_start=fill,
                                length=take))
            done += take
            fill += take
            if fill == chunk_size:
                chunks.append(Chunk(index=ci, segments=tuple(segs), pad=0))
                segs, fill, ci = [], 0, ci + 1
    if segs:
        chunks.append(Chunk(index=ci, segments=tuple(segs),
                            pad=chunk_size - fill))
    return chunks


def drop_rid(chunks: Sequence[Chunk], rid: str) -> List[Chunk]:
    """Remove one request's segments from queued chunks (user cancel);
    chunks left empty disappear.  A partially-emptied chunk keeps its
    layout — each segment records its own chunk_start — so the engines
    can still execute it as-is."""
    kept: List[Chunk] = []
    for c in chunks:
        segs = tuple(s for s in c.segments if s.rid != rid)
        if segs:
            kept.append(dataclasses.replace(c, segments=segs))
    return kept


def chunks_for(prompt_len: int, chunk_size: int = DEFAULT_CHUNK_SIZE) -> int:
    return -(-prompt_len // chunk_size)


def padded_len(prompt_len: int, chunk_size: int = DEFAULT_CHUNK_SIZE) -> int:
    return chunks_for(prompt_len, chunk_size) * chunk_size
