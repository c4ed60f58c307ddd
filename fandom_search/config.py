"""Typed configuration for the whole pipeline.

The reference hard-codes its knobs in source (shingle width 6, distance /
verification thresholds; SURVEY.md section 6 "Config / flag system").  Here every
knob is a frozen dataclass so configs hash, compare, and thread cleanly
through jitted functions as static arguments.  Defaults reproduce the
reference behavior.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ShingleConfig:
    """How text becomes fixed-width dense vectors on device.

    The reference maps each word of a 6-word shingle to a numeric hash so
    the shingle is a 6-dim point in metric space (SURVEY.md section 3,
    "Shingler + hash vectorizer"; BASELINE.json:5 "n-gram shingles ...
    hashed into dense vectors").  The accelerator upgrade: each
    (position, word) pair is expanded into a pseudo-random +-1 vector of
    ``dim`` lanes (multiply-shift sign bits of the 32-bit word hash,
    bit-reproducible on host and device), and the shingle embedding is
    their sum.  Then

        dot(e_q, e_s) / dim  ~=  #positions where the two shingles agree

    with noise O(n/sqrt(dim)), so candidate search is a single int8
    matrix product on the tensor cores instead of a BallTree walk.
    """

    n: int = 6              # words per shingle (reference: 6)
    dim: int = 128          # embedding lanes per shingle
    seed: int = 0x5EED      # salt for all hashing; shared host/device

    def __post_init__(self) -> None:
        # the top-k kernel loads [rows, dim] int8 blocks whose size
        # must be a power of two, and int8 tensor-core products want a
        # contraction depth that is a multiple of 32: multiples of 128
        # meet both for every supported block shape
        if self.dim < 1 or self.dim % 128 != 0:
            raise ValueError(
                f"dim ({self.dim}) must be a positive multiple of 128 "
                f"(the top-k kernel's block constraint)"
            )
        if self.n < 1:
            raise ValueError("shingle width must be >= 1")


@dataclass(frozen=True)
class SearchConfig:
    """Candidate generation + verification + chaining knobs.

    ``candidate_threshold`` is in units of *matching words out of n*
    (the reference's distance radius, re-expressed in the embedding's
    similarity scale).  ``verify_threshold`` mirrors the reference's
    Levenshtein-ratio cutoff (SURVEY.md section 3 "Verifier").
    """

    k: int = 10                      # top-k neighbors per query shingle
    candidate_threshold: float = 3.5  # min est. matching words (of n)
    verify_threshold: float = 0.35    # min normalized alignment score
    window_tokens: int = 64          # fan-side context window for verify
    # line-side verification segment width: long script lines are NOT
    # truncated — verification reads a segment this wide centered on
    # the matched shingle's position (search/common.py line_segment)
    max_line_tokens: int = 64
    chain_gap: int = 12              # max token gap when chaining hits
    # query shingles per device call (upper bound — the engine buckets
    # small batches to pow2 sizes, so short corpora never upload the
    # full cap).  Large cap = few uploads and dispatches per corpus.
    batch_queries: int = 1 << 20
    script_pad_multiple: int = 2048  # script shingles padded to multiple
    # device->host candidate budget per batch: candidates are threshold-
    # compacted ON DEVICE (static-size scatter selection) so only hits
    # cross the PCIe/host boundary, not the full [NQ, k] top-k tables.
    # The dedup sort and slot scans cost proportionally to this STATIC
    # size, so it starts small; overflow triggers the pow2-sticky
    # budget retry (one recompile per growth, settled during warmup).
    max_candidates_per_batch: int = 1 << 14
    # batches submitted to the device ahead of result consumption;
    # 1 = double-buffering.  Deeper queues on the GPU: not measured.
    lookahead_batches: int = 1
    # u16 vocab-id compression of the fused-path stream upload: the
    # host encodes tokens against a <=65,535-entry frequency-seeded
    # table (search/vocab_stream.py) and the device reconstructs the
    # exact u32 hashes with one gather + one patch scatter.  Lossless;
    # out-of-table tokens ride a (pos, hash) patch list sized
    # t_pad >> stream_patch_shift, and a batch whose misses overflow
    # that budget falls back to the raw u32 upload.  Off by default;
    # its effect on the GPU host link: not measured.
    stream_compress: bool = False
    stream_patch_shift: int = 6
    # Smith-Waterman scoring (word-level local alignment)
    sw_match: float = 2.0
    sw_mismatch: float = -1.0
    sw_gap: float = -1.0

    def __post_init__(self) -> None:
        # The fused batch path rides candidate counts and positions
        # through f32 (exact integers only below 2^24): the raw
        # candidate count is bounded by batch_queries * k.
        if self.batch_queries * self.k >= 1 << 24:
            raise ValueError(
                f"batch_queries*k ({self.batch_queries}*{self.k}) must stay "
                f"below 2^24 for exact f32 counts in the fused batch path"
            )
        if self.batch_queries < self.window_tokens:
            raise ValueError(
                f"batch_queries ({self.batch_queries}) must be >= "
                f"window_tokens ({self.window_tokens}): split-work chunks "
                f"must be able to contain a full verification window"
            )


@dataclass(frozen=True)
class BucketedConfig:
    """Bucketed inverted-index prefilter (ops/bucketed.py) — the
    SUB-LINEAR candidate path for large script indexes (SURVEY.md §8.7).

    ``cap`` entries are scanned per probed bucket (per-query work is
    P*cap regardless of index size); ``load_factor`` scales the bucket
    count (pow2 >= load_factor * NS) so average occupancy stays below
    1/load_factor and cap overflows are rare.  Defaults: load 1/4 ->
    P(bucket > 8) ~ Poisson(0.25) tail ~ 1e-10 per bucket on hash-
    uniform pairs, while P*cap = 48 keeps the rerank gather narrow
    (the gather is the stage's cost).
    """

    cap: int = 8
    load_factor: int = 4
    seed: int = 0xB0C5
    # "triangles": groups of 3 positions, all within-group pairs (n=6:
    #   6 probes) — deterministic recall for >= ceil(n/3)+1 exact
    #   matches (>= 3 for n=6); the cheapest covering for that bound.
    # "all": every C(n,2) pair (n=6: 15 probes) — recall guaranteed
    #   down to 2 exact matches, ~2.5x the probe/gather cost.  Use for
    #   recall-critical very large indexes where 2-match+noise
    #   candidates start entering the exact top-k (measured: recall
    #   0.985 -> ~1.0 at a 4M-shingle index).
    pairs: str = "triangles"
    # Hybrid exact fallback: queries probing any over-cap bucket lose
    # the pigeonhole guarantee, so they are routed through the exact
    # fused kernel instead (ops/bucketed.py "hybrid").  Restores full
    # recall on skewed (Zipf stopword-heavy) vocabularies, where the
    # pure bucketed path measured thresholded recall 0.06; on clean
    # corpora zero queries are at risk and the path is byte-identical.
    # False = round-2 pure behavior incl. the >5%-overflow refusal.
    hybrid: bool = True

    def __post_init__(self) -> None:
        if self.cap < 1:
            raise ValueError("cap must be >= 1")
        if self.load_factor < 1:
            raise ValueError("load_factor must be >= 1")
        if self.pairs not in ("triangles", "all"):
            raise ValueError("pairs must be 'triangles' or 'all'")


@dataclass(frozen=True)
class MeshConfig:
    """Multi-device layout (SURVEY.md section 3 parallelism table).

    axis ``works``: fanwork (query) shingles are sharded — pure data
    parallelism over the corpus.  axis ``script``: source-script shingles
    are sharded — each device sees a slice of the index and per-shard
    top-k results are merged with an all_gather + re-top-k collective
    (BASELINE.json:10).
    """

    works: int = 1
    script: int = 1

    @property
    def num_devices(self) -> int:
        return self.works * self.script


@dataclass(frozen=True)
class PipelineConfig:
    shingle: ShingleConfig = dataclasses.field(default_factory=ShingleConfig)
    search: SearchConfig = dataclasses.field(default_factory=SearchConfig)
    bucketed: BucketedConfig = dataclasses.field(
        default_factory=BucketedConfig
    )
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
