"""Unified KV-transfer network stack (paper §3.3.4, Fig. 9, §4).

Physical-link taxonomy and the emulation methodology follow the paper:
the real deployment would pick Direct (NVLink/ICI ~300 GB/s one-sided),
Direct-NIC (RoCE 200 Gb/s), or Indirect (socket bounce via host DRAM);
since this container has no fabric, transfers are *emulated*: payload
bytes are computed from the model config, and latency = setup + bytes/bw
(+ an extra host-bounce term for Indirect) — exactly the paper's mock
mechanism (§4).

On the TPU dry-run path the same handoff lowers as a collective-permute
across the mesh ``pod`` axis (core/disagg.py) — the ICI analogue of a
one-sided put.

Granularity: request-level (paper's implementation) or chunk-level
(paper's future work — free here because chunked prefill yields
page-aligned chunks; overlaps transfer with remaining chunks).  The
paged engines account payloads at PAGE granularity (``kv_page_bytes``):
what actually moves is the request's live pool pages, which is also the
unit a per-chunk streamed transfer would put on the wire.
"""
from __future__ import annotations

import dataclasses
import enum

from repro_torch.kvcache.paged import window_dead_pages
from repro_torch.models.config import ModelConfig


class LinkType(enum.Enum):
    DIRECT = "direct"            # NVLink/HCCS/ICI class
    DIRECT_NIC = "direct_nic"    # GPU/NPU-direct RDMA NIC
    INDIRECT = "indirect"        # bounce via host DRAM + sockets


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    link: LinkType
    bandwidth_Bps: float          # payload bandwidth, bytes/s
    setup_s: float                # per-transfer fixed cost
    one_sided: bool               # receiver CPU not involved
    host_bounce_Bps: float = 0.0  # extra copy bw for INDIRECT


# The paper's two emulated setups (§5.1) + the socket fallback (§4)
TS_NVLINK = LinkSpec(LinkType.DIRECT, 300e9, 10e-6, True)
TS_ROCE = LinkSpec(LinkType.DIRECT_NIC, 25e9, 30e-6, True)      # 200 Gbps
TS_SOCKET = LinkSpec(LinkType.INDIRECT, 12.5e9, 100e-6, False,  # 100 Gbps
                     host_bounce_Bps=40e9)
# TPU target: inter-pod DCI / intra-pod ICI per-link
TS_ICI = LinkSpec(LinkType.DIRECT, 50e9, 5e-6, True)


def kv_page_bytes(cfg: ModelConfig, n_tokens: int, page_size: int,
                  dtype_bytes: int = 2, enc_len: int = 0,
                  cached_tokens: int = 0, cross_cached: bool = False) -> int:
    """Prefilled-KV payload at PAGE granularity: the paged engines ship
    whole LIVE pages, so the wire bytes are the page contents, not the
    raw token count — this is the unit the paper's per-chunk streamed
    transfer accounts in.  Sliding-window configs only ship the
    in-window page suffix (pages that slid wholly out are freed, never
    transferred); MLA configs' per-token width is the compressed latent
    (via ``kv_bytes_per_token``), so latent pages are ~14x narrower.

    ``enc_len > 0`` (VLM / enc-dec archs) adds the ONE-SHOT cross-KV
    payload: the read-only encoder pages every cross layer attends,
    shipped once with the prefilled self KV and amortized over the whole
    decode (the paper's prefill→decode shipping model).

    ``cached_tokens`` (page-aligned) and ``cross_cached`` subtract what
    the prefix cache already deduped: pages the decode side aliases from
    its own cache never go on the wire (content-addressed KV — both
    sides key pages by the same chain hash, so a prefill-side hit is a
    decode-side hit for any previously decoded sharer)."""
    n = max(1, n_tokens)
    pages = -(-n // page_size)
    # same dead-page arithmetic the allocator frees by; at least one
    # live page always ships (the allocator clamps identically)
    pages = max(1, pages - window_dead_pages(n, cfg.sliding_window,
                                             page_size))
    pages = max(1, pages - cached_tokens // page_size)
    total = kv_bytes(cfg, pages * page_size, dtype_bytes)
    if enc_len and not cross_cached:
        cross_pages = -(-enc_len // page_size)
        total += (cross_pages * page_size
                  * cfg.cross_kv_bytes_per_token(dtype_bytes))
    return total


def kv_bytes(cfg: ModelConfig, n_tokens: int, dtype_bytes: int = 2,
             enc_len: int = 0, cached_tokens: int = 0) -> int:
    """Prefilled-KV payload for n_tokens. MLA ships the compressed latent;
    recurrent blocks ship O(1) state (counted once, not per token);
    ``enc_len`` encoder tokens add the one-shot cross-KV payload;
    ``cached_tokens`` are deduped by the prefix cache and stay off the
    wire (token-granular analogue of ``kv_page_bytes``)."""
    n_tokens = max(0, n_tokens - cached_tokens)
    per_tok = cfg.kv_bytes_per_token(dtype_bytes)
    state_bytes = 0
    for kind in cfg.layer_kinds:
        if kind == "rglru":
            lru = cfg.lru_width or cfg.d_model
            state_bytes += (lru * 4                    # h (f32)
                            + (cfg.rglru_conv_width - 1) * lru * dtype_bytes)
        elif kind == "slstm":
            state_bytes += 4 * cfg.d_model * 4
        elif kind == "mlstm":
            ud = 2 * cfg.d_model
            dh = ud // cfg.n_heads
            state_bytes += (cfg.n_heads * dh * dh + cfg.n_heads * dh
                            + cfg.n_heads) * 4 + 3 * ud * dtype_bytes
    cross = enc_len * cfg.cross_kv_bytes_per_token(dtype_bytes)
    return per_tok * n_tokens + state_bytes + cross


class NetworkStack:
    """send/receive/read/write abstraction (§3.3.4). In emulation mode it
    returns the wait the receiver must apply (the paper's mock: metadata
    moves, payload latency is simulated)."""

    def __init__(self, spec: LinkSpec = TS_NVLINK,
                 granularity: str = "request"):
        assert granularity in ("request", "chunk")
        self.spec = spec
        self.granularity = granularity
        self.bytes_sent = 0
        self.bytes_saved = 0   # wire bytes the prefix cache deduped
        self.transfers = 0
        self.retransmits = 0

    def note_retransmit(self) -> None:
        """Account one KV retransmission (the cluster's fault-tolerance
        retry path, docs/fault_tolerance.md).  Kept separate from
        ``transfers`` so goodput accounting can tell first attempts
        from recovery traffic."""
        self.retransmits += 1

    def transfer_time(self, payload_bytes: int) -> float:
        t = self.spec.setup_s + payload_bytes / self.spec.bandwidth_Bps
        if self.spec.link == LinkType.INDIRECT:
            # extra host-DRAM bounce copy on both ends (2-sided)
            t += 2 * payload_bytes / self.spec.host_bounce_Bps
        return t

    def send_kv(self, cfg: ModelConfig, n_tokens: int,
                n_chunks: int = 1, page_size: int = 0,
                enc_len: int = 0, cached_tokens: int = 0,
                cross_cached: bool = False) -> float:
        """Returns emulated completion delay (s) for a prefilled KV.

        ``page_size > 0`` models the paged engines' transfer: payload =
        live pages (page-aligned), which is what a one-sided page put
        actually moves.  ``enc_len > 0`` adds the one-shot cross-KV
        pages (VLM / enc-dec).  ``cached_tokens``/``cross_cached`` keep
        prefix-cache-deduped pages off the wire (and count the savings
        in ``bytes_saved``).  chunk-level granularity pays setup per
        chunk but overlaps with prefill of later chunks: only the LAST
        chunk's latency lands on the critical path."""
        if page_size:
            total = kv_page_bytes(cfg, n_tokens, page_size, enc_len=enc_len,
                                  cached_tokens=cached_tokens,
                                  cross_cached=cross_cached)
            if cached_tokens or cross_cached:
                self.bytes_saved += kv_page_bytes(
                    cfg, n_tokens, page_size, enc_len=enc_len) - total
        else:
            total = kv_bytes(cfg, n_tokens, enc_len=enc_len,
                             cached_tokens=cached_tokens)
            if cached_tokens:
                self.bytes_saved += kv_bytes(cfg, n_tokens,
                                             enc_len=enc_len) - total
        self.bytes_sent += total
        if self.granularity == "chunk" and n_chunks > 1:
            self.transfers += n_chunks
            return self.transfer_time(total // n_chunks)
        self.transfers += 1
        return self.transfer_time(total)
