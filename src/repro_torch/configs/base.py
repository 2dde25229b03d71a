"""Configs copied from the JAX package's ``repro/configs/base.py`` so the
port imports nothing of it: the paper's own pipeline (``EnvelopeConfig``)
and the decoder-only LM (``TransformerConfig``, served by
``repro_torch.launch.serve --mode lm``). The recsys and GNN configs are
not ported yet (``ROADMAP.md``)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class EnvelopeConfig:
    """The paper's own 'architecture': the Lucene-style indexing pipeline."""

    name: str = "lucene_envelope"
    family: str = "index"
    docs_per_shard: int = 4096
    doc_len: int = 1024  # tokens per document buffer
    vocab_bits: int = 22  # hashed term space = 4M terms
    postings_block: int = 128  # lane-blocked PFor block size
    flush_budget_mb: int = 256
    merge_fanout: int = 10  # tiered-merge fanout (Lucene default)
    # background merge workers (ConcurrentMergeScheduler); 0 = merges run
    # synchronously inside add_flush (the coupled write path)
    merge_threads: int = 0
    # cap background-merge IO at this MB/s (Lucene's ioThrottle shape) so
    # cascades on the target medium never starve flushes; 0 = uncapped
    merge_io_mbps: float = 0.0
    # NRT refresh daemon period in seconds: > 0 starts a thread in
    # DistributedIndexer that swaps ``indexer.searcher`` atomically every
    # period (stopped by close()); 0 = manual refresh() only
    refresh_every: float = 0.0
    store_positions: bool = True
    store_doc_vectors: bool = True
    # --- durable storage (repro.storage) ---
    # media profiles (storage.MEDIA_PROFILES keys) for the source collection
    # and target index when the run goes through ThrottledDirectory pairs;
    # envelope.PROFILE_TO_MEDIA maps them onto the paper's Table-1 media
    source_media: str = "nas"
    target_media: str = "ssd"
    # segment codec for the on-disk format (storage.codec.CODECS):
    # "pfor" (delta + lane-blocked bit-planes, the compressed default),
    # "raw" (int64 streams, the incompressible baseline the envelope
    # benchmarks compare against), "adaptive" (per-32-value-sub-block
    # adaptive bit widths), "pef" (partitioned Elias-Fano over doc-id
    # gap lists — the sparse-postings frontier), or "auto" (every stream
    # encoded with whichever of pfor/adaptive/pef comes out smallest;
    # the chosen codec id is the stream's leading byte as always, so
    # decode needs no knob)
    codec: str = "pfor"
    # WAL rotation: > 0 caps every wal_N record file at this many MB —
    # an oversized acked batch splits row-wise across consecutive files
    # (replayed atomically; storage/wal.py). 0 = one record per op.
    wal_rotate_mb: float = 0.0
    # WAL recycling: keep up to this many truncated record files parked
    # at future sequence slots (renamed, not deleted) for appends to
    # overwrite — spares the create/delete metadata churn. 0 = delete.
    wal_recycle: int = 0
    # hot-term postings cache (storage.CachingDirectory) over the target
    # media stack: > 0 pins up to this many MB of frame-verified
    # dict/postings blocks in RAM, LFU-evicted, so nas/disk profiles stop
    # re-paying media latency for head terms. 0 = no cache layer.
    postings_cache_mb: float = 0.0
    # WAL group commit (storage.wal.sync_upto): concurrent ingest acks
    # coalesce into one batched fsync instead of paying one barrier each;
    # durability per ack is unchanged. Off by default — serial ingest
    # gains nothing and the strict one-barrier-per-ack failure accounting
    # is simpler to reason about.
    wal_group: bool = False
    # run recursive graph bisection (BP) over each merge output and fold
    # the resulting doc-id permutation into the merged segment's block
    # layout: scores and results are bit-identical, but blocks become
    # impact-homogeneous so block-max pruning skips more of them
    reorder_on_merge: bool = False
    # the same BP reassignment over each fresh FLUSH segment: NRT-visible
    # segments get impact-homogeneous blocks before any merge touches
    # them, at flush-latency cost (the bisection runs inline in _flush)
    reorder_on_flush: bool = False
    # "raw": 3x int32 per entry over the wire; "packed2": (local_doc|pos,
    # term) = 2 words, doc rebased from the source-device row after the
    # all_to_all (EXPERIMENTS.md §Perf — the paper's compression insight
    # applied to the shuffle stage)
    shuffle_payload: str = "raw"


@dataclass(frozen=True)
class TransformerConfig:
    """Decoder-only LM backbone (dense or MoE), GQA + RoPE.

    Feature flags cover the assigned archs: qk_norm (qwen3), logit softcaps +
    local/global alternation (gemma2), MoE top-k routing (moonshot, llama4),
    early-fusion stub (llama4). The port serves and trains all of them
    on one device; the fields match the JAX package's.
    """

    name: str
    family: str = "lm"
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01
    moe_impl: str = "pjit"
    # --- attention flavour ---
    qk_norm: bool = False
    attn_softcap: float = 0.0  # 0 disables
    final_softcap: float = 0.0
    sliding_window: int = 0  # 0 = full attention
    layer_pattern: str = "global"  # "global" | "local_global" (gemma2)
    rope_theta: float = 10_000.0
    rotary_pct: float = 1.0
    sandwich_norm: bool = False  # gemma2 post-norms
    tie_embeddings: bool = True
    # --- early-fusion multimodal stub (llama4) ---
    fused_patches: int = 0
    patch_dim: int = 0
    # --- numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    # --- training: the train attention's tiles and per-layer remat
    # (scan_layers only for field parity: the port's layers are a loop) ---
    attn_block_q: int = 512
    attn_block_kv: int = 1024
    remat: bool = True
    scan_layers: bool = True

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count."""
        d, l = self.d_model, self.n_layers
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.moe:
            ff = 3 * d * self.d_ff_expert * (self.n_experts
                                             + self.n_shared_experts)
            ff += d * self.n_experts  # router
        else:
            ff = 3 * d * self.d_ff
        norms = 2 * d * (2 if self.sandwich_norm else 1)
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return l * (attn + ff + norms) + emb + d

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared)."""
        if not self.moe:
            return self.param_count()
        d, l = self.d_model, self.n_layers
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        ff = 3 * d * self.d_ff_expert * (self.top_k + self.n_shared_experts)
        ff += d * self.n_experts
        norms = 2 * d * (2 if self.sandwich_norm else 1)
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return l * (attn + ff + norms) + emb + d
