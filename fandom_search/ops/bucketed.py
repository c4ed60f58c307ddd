"""Bucketed (inverted-index) prefilter — the SUB-LINEAR candidate path.

The exact kernel (ops/distance_topk.py) touches every (query,
script-shingle) pair.  This module goes sub-linear the way SURVEY.md
§8.7 / BASELINE.json:5 demand: bucket the index, probe a constant number of buckets per query, and
exact-rerank only the gathered survivors — per-query cost O(P * cap)
regardless of script size, vs O(NS) for every scan.

Scheme — triangle-group position-pair buckets with a pigeonhole
guarantee:

  * A shingle is n word hashes (w_0..w_{n-1}).  Positions are split
    into groups of 3 and ONE table is built per within-group pair
    (n=6: groups {0,1,2} and {3,4,5} -> 6 tables), each keyed by the
    EXACT word-hash pair (mixed to a bucket id with fmix32).
  * A candidate avoiding every probed pair can match at most one
    position per group, i.e. at most g = ceil(n/3) positions; so any
    candidate with >= g+1 matching positions (n=6: >= 3 matches)
    shares at least one *intact* pair with the query — DETERMINISTIC
    recall, not the probabilistic recall of locality-sensitive
    hashing.  The g+1 bound is what makes the engine's candidate_threshold (3.5 matching
    words) safe: a 3-exact-match candidate can clear 3.5 on positive
    embedding noise (sd ~ n/sqrt(dim) ~ 0.53), so the >=4 guarantee
    of plain disjoint pairs would lose real candidates; >=3 coverage
    leaves only >= +2.8-sigma-noise 2-match candidates uncovered,
    which the bench's measured thresholded recall accounts for.
    Six pairs is MINIMAL for >=3-coverage on n=6: "every 3-subset of
    positions contains a probed pair" means the complement pair-graph
    is triangle-free, and Turan's bound caps a triangle-free graph on
    6 vertices at 9 of the 15 edges — leaving >= 6 probed.
  * Query: compute the P bucket ids (a few elementwise fmix32's),
    gather each bucket's entry list (capped at ``cap``), sort + dedup
    the union per row, then exact-rerank the survivors with the int8
    embedding dot (``rerank_exact``) so the scores the engine sees
    are IDENTICAL in semantics to the brute-force kernel's.

Failure mode and its accounting: a pathologically common word pair
(a "the cat"-bucket in Zipf text) can overflow ``cap``, losing the
guarantee for candidates whose only intact pair is that bucket.
``build()`` reports the overflow fraction so the caller can see the
exposure; the bench measures thresholded recall on a Zipf corpus too.

Skew economics (measured, DESIGN.md §4.4): the hybrid's reroute
fraction is NOT a tunable implementation detail — at 0.99 thresholded
recall it is pinned by the corpus's hot-pair mass, because the exact
kernel's above-threshold top-k contains 2-position-match entries
(6.7% of entries on zipf-1.3%50k) that ride exactly the over-cap
stopword pairs.  Rerouting only on hot word-TRIPLES (the most
selective key family with a >=3 guarantee) was measured to collapse
safe-query recall to 0.48-0.70 on that corpus; no identity-keyed
scheme can do better without covering the hot pairs themselves.  On
English-like skew (top word ~2.6% of tokens, zipf-1.01 over 2^19
vocab — the realistic fanfic regime) the same machinery reroutes
~7% of queries under ``pairs="all"`` with a deterministic >=2-match
guarantee: that is the configuration where sub-linearity survives
real text, and the bench's ``bucketed_english_*`` config attests it.

Reference parity note: this replaces the reference's BallTree *query*
(SURVEY.md §4.2 HOT LOOP 1) in the large-index regime, the same role
ops/distance_topk.py fills at moderate index sizes.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fandom_search.config import BucketedConfig, ShingleConfig
from fandom_search.data.hashing import fmix32
from fandom_search.ops.distance_topk import (
    NEG_INF, merge_topk, pad_rows, topk_dot,
)

_I32_MAX = np.int32(2**31 - 1)


def _derive_salts(seed: int, p: int) -> np.ndarray:
    """One uint32 salt per probe table."""
    return fmix32(
        (np.uint64(seed) + np.arange(1, p + 1, dtype=np.uint64)
         * np.uint64(0x9E3779B9)).astype(np.uint32)
    )


def _pairs_for(n: int, mode: str = "triangles") -> Tuple[Tuple[int, int], ...]:
    """Probe position pairs (see module doc and BucketedConfig.pairs).

    "triangles": within-group pairs for groups of 3 positions —
    guarantees a candidate matching >= ceil(n/3)+1 positions shares an
    intact probed pair (minimal covering for that bound; Turan).  A
    trailing 1-position group degenerates to a (p, p) single-word
    probe.  "all": every C(n,2) pair — guarantees >= 2 matches (every
    2-subset must itself be probed, so no cheaper covering exists).
    """
    if n < 2:
        return ((0, 0),)
    if mode == "all":
        return tuple(
            (i, j) for i in range(n) for j in range(i + 1, n)
        )
    pairs = []
    for g0 in range(0, n, 3):
        grp = list(range(g0, min(g0 + 3, n)))
        if len(grp) == 1:
            pairs.append((grp[0], grp[0]))
        else:
            pairs.extend(
                (grp[i], grp[j])
                for i in range(len(grp))
                for j in range(i + 1, len(grp))
            )
    return tuple(pairs)


def _bucket_ids(w_a, w_b, salt, num_buckets: int):
    """Mix an exact word-hash pair into a bucket id (works in NumPy and
    jnp; inputs uint32)."""
    k = fmix32(fmix32(w_a + salt) ^ w_b)
    return (k & np.uint32(num_buckets - 1)).astype(np.int32)


def _build_tables_native(w, pairs, salts, num_buckets, cap,
                         entries, offsets):
    """Counting-sort table build in C++ (native/fastingest.cpp
    fs_bucketed_table), one GIL-free thread per probe table —
    bit-identical to the NumPy stable-argsort path (tested).
    Returns the overflow entry count, or None when the native library
    is unavailable (NumPy fallback)."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    from fandom_search.data.fast_tokenizer import get_lib

    lib = get_lib()
    if lib is None:
        return None
    ns = w.shape[0]
    cols = {}
    for (a, bb) in pairs:
        for c in (a, bb):
            if c not in cols:
                cols[c] = np.ascontiguousarray(w[:, c])
    keys_scratch = np.empty((len(pairs), ns), dtype=np.uint32)

    def one(i):
        a, bb = pairs[i]
        u32p = ctypes.POINTER(ctypes.c_uint32)
        return lib.fs_bucketed_table(
            cols[a].ctypes.data_as(u32p),
            cols[bb].ctypes.data_as(u32p),
            ctypes.c_int64(ns),
            ctypes.c_uint32(int(salts[i])),
            ctypes.c_uint32(num_buckets - 1),
            ctypes.c_int32(cap),
            keys_scratch[i].ctypes.data_as(u32p),
            entries[i].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            offsets[i].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )

    with ThreadPoolExecutor(max_workers=min(8, len(pairs))) as ex:
        return sum(ex.map(one, range(len(pairs))))


@dataclass
class BucketedIndex:
    """Device-resident inverted index over the script's shingles."""

    entries: jax.Array      # int32 [P, NS] shingle ids sorted by bucket
    offsets: jax.Array      # int32 [P, B+1] CSR bucket offsets
    num_buckets: int
    salts: Tuple[int, ...]  # one per probe table
    ns_valid: int
    overflow_frac: float    # fraction of entries in buckets larger than cap

    @classmethod
    def build(
        cls,
        shingle_windows: np.ndarray,  # uint32 [NS, n] (ScriptIndex field)
        cfg: BucketedConfig,
        shingle_cfg: ShingleConfig,
    ) -> "BucketedIndex":
        w = np.asarray(shingle_windows, dtype=np.uint32)
        ns, n = w.shape if w.ndim == 2 else (0, shingle_cfg.n)
        pairs = _pairs_for(shingle_cfg.n, cfg.pairs)
        p = len(pairs)
        b = 1024
        while b < cfg.load_factor * max(ns, 1):
            b *= 2
        salts = _derive_salts(cfg.seed, p)
        entries = np.zeros((p, max(ns, 1)), dtype=np.int32)
        offsets = np.zeros((p, b + 1), dtype=np.int32)  # counts < 2^31
        over = _build_tables_native(
            w, pairs, salts, b, cfg.cap, entries, offsets
        ) if ns else 0
        if over is None:
            over = 0
            for i, (a, bb) in enumerate(pairs):
                keys = _bucket_ids(
                    w[:, a], w[:, bb], salts[i], b
                ) if ns else np.zeros((0,), np.int32)
                order = np.argsort(keys, kind="stable")  # ties: asc id
                entries[i, :ns] = order
                counts = np.bincount(keys, minlength=b)
                offsets[i, 1:] = np.cumsum(counts)
                over += int(counts[counts > cfg.cap].sum())
        return cls(
            entries=jnp.asarray(entries),
            offsets=jnp.asarray(offsets),
            num_buckets=b,
            salts=tuple(int(s) for s in salts),
            ns_valid=ns,
            overflow_frac=over / max(1, ns * p),
        )


@functools.partial(
    jax.jit,
    static_argnames=("n", "cap", "num_buckets", "salts", "pairs_mode"),
)
def probe_candidates(
    stream: jax.Array,     # uint32 [T] query token hashes
    entries: jax.Array,    # int32 [P, NS]
    offsets: jax.Array,    # int32 [P, B+1]
    *,
    n: int,
    cap: int,
    num_buckets: int,
    salts: Tuple[int, ...],
    pairs_mode: str = "triangles",
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Bucket-probe every query shingle; returns (cand_idx, ok, at_risk):
    cand_idx/ok of shape [M, P*cap] with candidates SORTED ascending per
    row and duplicates masked out — ready for rerank_exact (ties then
    resolve to the lowest script index, the exact kernel's rule) — and
    at_risk [M] bool: True when ANY probed bucket overflows ``cap``, i.e.
    the pigeonhole guarantee may be lost for that query (the hybrid path
    reroutes such queries through the exact kernel)."""
    t = stream.shape[0]
    m = max(0, t - n + 1)
    pairs = _pairs_for(n, pairs_mode)
    cands = []
    oks = []
    at_risk = jnp.zeros((m,), dtype=bool)
    iota = jnp.arange(cap, dtype=jnp.int32)[None, :]
    for i, (a, b) in enumerate(pairs):
        w_a = jax.lax.dynamic_slice_in_dim(stream, a, m)
        w_b = jax.lax.dynamic_slice_in_dim(stream, b, m)
        bk = _bucket_ids(w_a, w_b, jnp.uint32(salts[i]), num_buckets)
        start = offsets[i, bk]                       # [M]
        full = offsets[i, bk + 1] - start
        at_risk = jnp.logical_or(at_risk, full > cap)
        ln = jnp.minimum(full, cap)
        pos = start[:, None] + iota                  # [M, cap]
        idx = entries[i, jnp.clip(pos, 0, entries.shape[1] - 1)]
        cands.append(idx)
        oks.append(iota < ln[:, None])
    cand = jnp.concatenate(cands, axis=1)            # [M, P*cap]
    ok = jnp.concatenate(oks, axis=1)
    # sort per row (invalid to the end), mask duplicate neighbors
    s = jnp.where(ok, cand, _I32_MAX)
    s = jax.lax.sort(s, dimension=1)
    ok = s < _I32_MAX
    dup = jnp.concatenate(
        [jnp.zeros((s.shape[0], 1), bool), s[:, 1:] == s[:, :-1]], axis=1
    )
    return (
        jnp.where(ok, s, 0),
        jnp.logical_and(ok, jnp.logical_not(dup)),
        at_risk,
    )


def _probe_geometry(
    stream: jax.Array,     # uint32 [T] query token hashes
    offsets: jax.Array,    # int32 [P, B+1]
    *,
    n: int,
    cap: int,
    num_buckets: int,
    salts: Tuple[int, ...],
    pairs_mode: str,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Bucket (start, clipped length) per (query, probe) — the probe
    WITHOUT the entry gather.  Returns (start [M,P], ln [M,P],
    at_risk [M]).  This is all the segment-scatter flat path needs:
    it never materializes the [M, P*cap] candidate matrix (~97%
    padding at healthy load factors), whose gather + row-sort + dedup
    dominate probe_candidates' device time.

    Same m = max(0, ...) convention as probe_candidates (round-3
    advisor low): a degenerate stream shorter than the shingle width
    yields zero query rows in BOTH impls, and the flat entry points
    reject it outright (_flat_impl precondition) so the impls can
    never diverge on it."""
    t = stream.shape[0]
    m = max(0, t - n + 1)
    pairs = _pairs_for(n, pairs_mode)
    starts, lens = [], []
    at_risk = jnp.zeros((m,), dtype=bool)
    # one 2-wide-slice gather per probe fetches offsets[bk] and
    # offsets[bk+1] together — an [M] gather's cost is row latency
    # more than width, so one gather per probe instead of two
    dn = jax.lax.GatherDimensionNumbers(
        offset_dims=(1,), collapsed_slice_dims=(), start_index_map=(0,)
    )
    for i, (a, b) in enumerate(pairs):
        w_a = jax.lax.dynamic_slice_in_dim(stream, a, m)
        w_b = jax.lax.dynamic_slice_in_dim(stream, b, m)
        bk = _bucket_ids(w_a, w_b, jnp.uint32(salts[i]), num_buckets)
        o2 = jax.lax.gather(
            offsets[i], bk[:, None], dn, slice_sizes=(2,),
            mode=jax.lax.GatherScatterMode.PROMISE_IN_BOUNDS,
        )                                            # [M, 2]
        start = o2[:, 0]
        full = o2[:, 1] - start
        at_risk = jnp.logical_or(at_risk, full > cap)
        starts.append(start)
        lens.append(jnp.minimum(full, cap))
    return jnp.stack(starts, axis=1), jnp.stack(lens, axis=1), at_risk


def rerank_exact(
    q_emb: jax.Array,     # int8 [NQ, D]
    s_emb: jax.Array,     # int8 [NS_pad, D]
    cand_idx: jax.Array,  # int32 [NQ, R] from the bucket probe
    cand_ok: jax.Array,   # bool [NQ, R] — probe validity
    k: int,
    dim: int,
    chunk: int | None = None,
) -> Tuple[jax.Array, jax.Array]:
    """Exact dot/dim top-k over each row's gathered candidates.  The
    int8 values are exact in bf16 and the f32 sums stay integers far
    below 2^24, so the scores equal the full kernel's."""
    nq, r = cand_idx.shape
    if chunk is None:
        # One gather+einsum when the gathered block fits comfortably
        # (serialized lax.map chunks of 1024 rows are 128 sequential
        # steps per 131k-query batch);
        # otherwise the largest pow2 chunk under ~1 GB.
        chunk = 1024
        # bound the POST-doubling size, so the cap holds for the chunk
        # actually used (doubling after the check could land at 2 GB)
        while chunk < nq and 2 * chunk * r * dim < (1 << 30):
            chunk *= 2

    def one(args):
        qe, ci, ok = args                       # [c, D], [c, R], [c, R]
        se = jnp.take(s_emb, ci, axis=0)        # [c, R, D] int8
        scores = jnp.einsum(
            "crd,cd->cr",
            se.astype(jnp.bfloat16),
            qe.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        ) / dim
        scores = jnp.where(ok, scores, NEG_INF)
        # R is small: an exact two-key sort (lowest index on ties, the
        # exact kernel's rule) costs little
        return merge_topk(scores, ci, k)

    if nq <= chunk:
        return one((q_emb, cand_idx, cand_ok))
    pad = (-nq) % chunk
    if pad:
        q_emb = jnp.pad(q_emb, ((0, pad), (0, 0)))
        cand_idx = jnp.pad(cand_idx, ((0, pad), (0, 0)))
        cand_ok = jnp.pad(cand_ok, ((0, pad), (0, 0)))
    c = (nq + pad) // chunk
    vals, idx = jax.lax.map(
        one,
        (
            q_emb.reshape(c, chunk, -1),
            cand_idx.reshape(c, chunk, r),
            cand_ok.reshape(c, chunk, r),
        ),
    )
    return vals.reshape(-1, k)[:nq], idx.reshape(-1, k)[:nq]


def bucketed_topk(
    q_emb: jax.Array,          # int8 [M, D] query embeddings
    stream: jax.Array,         # uint32 [T] query token hashes
    bidx: BucketedIndex,
    s_emb_padded: jax.Array,   # int8 [NS_pad, D]
    k: int,
    dim: int,
    cfg: BucketedConfig,
    shingle_cfg: ShingleConfig,
) -> Tuple[jax.Array, jax.Array]:
    """Sub-linear top-k: bucket probe -> exact int8 rerank.

    Scores are dot/dim — identical semantics to topk_dot_pallas — for
    the candidates found in buckets; rows whose true top-k lie outside
    every probed bucket return lower-scored (or padding) entries, which
    is exactly the thresholded-recall contract documented above.
    """
    m = q_emb.shape[0]
    cand, ok, _ = probe_candidates(
        stream, bidx.entries, bidx.offsets,
        n=shingle_cfg.n, cap=cfg.cap, num_buckets=bidx.num_buckets,
        salts=bidx.salts, pairs_mode=cfg.pairs,
    )
    qp, _ = pad_rows(q_emb, 256)
    pad = qp.shape[0] - m
    if pad:
        cand = jnp.pad(cand, ((0, pad), (0, 0)))
        ok = jnp.pad(ok, ((0, pad), (0, 0)))
    vals, idx = rerank_exact(qp, s_emb_padded, cand, ok, k, dim)
    return vals[:m], idx[:m]


@functools.partial(
    jax.jit,
    static_argnames=(
        "n", "cap", "num_buckets", "salts", "k", "dim", "threshold",
        "max_out", "pairs_mode", "impl",
    ),
)
def bucketed_candidates_flat(
    stream: jax.Array,        # uint32 [T] query token hashes
    q_emb: jax.Array,         # int8 [M_pad, D] (M_pad >= M rows used)
    entries: jax.Array,
    offsets: jax.Array,
    s_emb_padded: jax.Array,  # int8 [NS_pad, D]
    *,
    n: int,
    cap: int,
    num_buckets: int,
    salts: Tuple[int, ...],
    k: int,
    dim: int,
    threshold: float,
    max_out: int,
    pairs_mode: str = "triangles",
    impl: str = "seg",
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Sub-linear candidate generation emitting engine-ready triples.

    The [M, P*cap] probe table is ~97% padding on a healthy load
    factor (~1.5 true candidates per query), and gathering embeddings
    for padded slots dominated the first bucketed implementation's
    wall-clock.  The padded matrix is gone: the default impl="seg" (see
    _flat_impl) builds the true-pair stream by segment-scatter over
    bucket geometry,
    gathers and dot-scores only those, applies the threshold, ranks
    per query with a 3-key sort + segment-rank cummax (exact top-k,
    lowest-index ties — the exact kernel's rule), and compacts to the
    engine's (qpos, sidx, score, count) contract.  Per-query cost is
    O(bucket load), independent of script size.

    Budget/retry: the flat pair budget is shape-derived —
    pow2(2*M + 8*max_out), where M*P/load_factor is the expected noise
    pair count (P/load = 1.5 pairs/query at defaults, so 2*M has ~33%
    slack) and the max_out term covers quote-dense corpora growing
    with the engine's sticky budget.  Every flat array (compaction,
    gathers, the ranking sort) is sized by this budget, so an
    oversized budget spends its time gathering padding.  Overflowing
    either budget surfaces in the returned count (> max_out), which makes the
    engine's pow2 retry (search/engine.py) grow both together —
    nothing is silently dropped.
    """
    out, _ = _flat_impl(
        stream, q_emb, entries, offsets, s_emb_padded,
        n=n, cap=cap, num_buckets=num_buckets, salts=salts, k=k, dim=dim,
        threshold=threshold, max_out=max_out, pairs_mode=pairs_mode,
        drop_risk=False, impl=impl,
    )
    return out


def _seg_stream(ln_flat, start_flat, pair_budget):
    """Recover each flat slot's segment id and entry position from the
    clipped per-(query, probe) bucket lengths.

    Returns (seg [E], epos [E], valid [E], pair_count scalar) where
    slot e of the [pair_budget]-wide stream belongs to flat segment
    seg[e] and reads entry column epos[e].

    One marker per segment START is scattered into the budget and
    cumsum-recovered (empty segments included: their markers pile onto
    the next start, so the inclusive cumsum skips them).  The marker
    buffer carries ONE spare slot sliced off before the scan: a
    segment starting exactly AT the budget boundary — pair mass equal
    to the budget with trailing empty segments — must park its marker
    in the spare, not clip onto the budget's last REAL slot, or that
    still-valid slot resolves to the wrong segment and emits a bogus
    candidate while dropping the true last pair (round-3 advisor
    finding; pinned by test_seg_stream_exact_fill).  Starts beyond the
    budget also land in the spare, which only matters in the
    overflow-retry regime where the returned count triggers a budget
    regrow anyway."""
    csum = jnp.cumsum(ln_flat)
    pair_count = csum[-1]                        # pre-dedup mass
    out_start = csum - ln_flat                   # exclusive scan
    adds = jnp.zeros((pair_budget + 1,), jnp.int32).at[
        jnp.minimum(out_start, pair_budget)
    ].add(1, mode="drop")[:pair_budget]
    e_iota = jnp.arange(pair_budget, dtype=jnp.int32)
    seg = jnp.cumsum(adds) - 1                   # [E] segment id
    valid = e_iota < pair_count
    seg = jnp.clip(seg, 0, ln_flat.shape[0] - 1)
    # epos = start[seg] + (e - out_start[seg]); gathering the
    # precomputed delta = start - out_start costs ONE [E] row-
    # latency-bound gather instead of two
    delta = start_flat - out_start
    epos = e_iota + delta[seg]
    return seg, epos, valid, pair_count


def rank_in_segments(keep, first):
    """For a sorted stream split into segments (``first`` marks each
    segment's first slot): how many kept slots precede each slot within
    its segment.  An exclusive cumsum counts kept slots; a cummax
    carries each segment's start index forward."""
    keep_i = keep.astype(jnp.int32)
    c_exc = jnp.cumsum(keep_i) - keep_i
    iota = jnp.arange(keep.shape[0], dtype=jnp.int32)
    seg_start = jax.lax.cummax(jnp.where(first, iota, 0))
    return c_exc - jnp.take(c_exc, seg_start)


def _flat_impl(
    stream, q_emb, entries, offsets, s_emb_padded, *,
    n, cap, num_buckets, salts, k, dim, threshold, max_out, pairs_mode,
    drop_risk, impl="seg",
):
    """Shared flat-path body; returns ((qpos, sidx, sc, count), at_risk).

    ``drop_risk`` masks every pair from an at-risk query (one probing
    an over-cap bucket) out of the flat stream — the hybrid caller
    covers those queries with the exact kernel instead.

    ``impl`` selects the candidate-stream construction:

    * "seg" (default) — segment-scatter: probe only the bucket
      (start, length) geometry, exclusive-scan the clipped lengths,
      scatter one marker per segment start into the [E] pair budget
      and cumsum to recover each slot's (query, probe) segment, then
      gather entries directly at their in-bucket offsets.  Nothing
      [M, P*cap]-shaped ever exists; per-slot work is O(E).
      Duplicate candidates (one shingle reachable through several
      probed buckets) stay in the stream and are masked AFTER the
      ranking sort, where (row, sid) duplicates are adjacent.
    * "gather" — the round-2 shape, kept as the in-process A/B
      control and parity oracle: probe_candidates materializes the
      padded [M, P*cap] matrix (entry gather + row sort + neighbor
      dedup), then nonzero_compact lifts the true pairs out.  Its
      device time goes to materializing and scanning ~97% padding.

    Both impls emit identical (qpos, sidx, sc) and identical counts in
    the non-overflow regime; the overflow trigger differs only in
    counting pre-dedup (seg) vs post-dedup (gather) pair mass against
    the same budget, conservative in the same direction (retry)."""
    from fandom_search.search.engine import nonzero_compact

    if stream.shape[0] < n:
        # Precondition (static shape): at least one query shingle must
        # exist.  Without this, the seg impl's geometry scans would run
        # over zero segments while the gather impl emits an empty
        # matrix — reject loudly instead of letting the impls diverge.
        raise ValueError(
            f"query stream of {stream.shape[0]} tokens is shorter than "
            f"the shingle width n={n}; no query shingles exist"
        )
    m_queries = stream.shape[0] - n + 1
    p = len(_pairs_for(n, pairs_mode))
    slack = max(2, -(-p // 3))  # ~2x expected noise pairs (P/load)
    # quarter-pow2 ladder (<=25% overshoot, <=4 shapes/octave): every
    # [E]-sized op below — stream recovery, gathers, the 3-key ranking
    # sort — scales with E, so a pow2 round-up of e.g. 786k -> 2^20
    # was paying 33% on every stage for budget that is never touched
    pair_budget = _next_qpow2(slack * m_queries + 8 * max_out, 1024)

    if impl == "gather":
        cand, ok, at_risk = probe_candidates(
            stream, entries, offsets,
            n=n, cap=cap, num_buckets=num_buckets, salts=salts,
            pairs_mode=pairs_mode,
        )
        if drop_risk:
            ok = jnp.logical_and(ok, jnp.logical_not(at_risk)[:, None])
        m, width = cand.shape
        flat_ok = ok.ravel()
        pair_count = jnp.sum(flat_ok.astype(jnp.int32))
        pos = nonzero_compact(flat_ok, pair_budget)  # [E], -1 padded
        safe = jnp.maximum(pos, 0)
        valid = pos >= 0
        row = (safe // width).astype(jnp.int32)
        sid = cand.ravel()[safe]
    else:
        start, ln, at_risk = _probe_geometry(
            stream, offsets,
            n=n, cap=cap, num_buckets=num_buckets, salts=salts,
            pairs_mode=pairs_mode,
        )
        if drop_risk:
            ln = jnp.where(at_risk[:, None], 0, ln)
        ln_flat = ln.reshape(-1)                     # [M*P]
        start_flat = start.reshape(-1)
        seg, epos, valid, pair_count = _seg_stream(
            ln_flat, start_flat, pair_budget
        )
        row = (seg // p).astype(jnp.int32)
        probe_i = seg % p
        ecols = entries.shape[1]
        sid = entries.reshape(-1)[
            probe_i * ecols + jnp.clip(epos, 0, ecols - 1)
        ]
        sid = jnp.where(valid, sid, 0)

    qe = jnp.take(q_emb, jnp.minimum(row, q_emb.shape[0] - 1), axis=0)
    se = jnp.take(s_emb_padded, sid, axis=0)
    score = jnp.einsum(
        "ed,ed->e",
        qe.astype(jnp.bfloat16),
        se.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    ) / dim
    keep = jnp.logical_and(valid, score >= threshold)

    # exact per-query top-k among kept pairs: sort by (row asc,
    # score desc, sid asc) then rank within the row segment
    big = jnp.int32(1 << 30)
    score_i = jnp.where(keep, jnp.round(score * dim).astype(jnp.int32), 0)
    key_row = jnp.where(keep, row, big)
    key_neg = -score_i
    # no f32 score payload: sort cost scales with operand count
    # (engine dedup-sort discipline), and the score reconstructs
    # EXACTLY from the -score_i key — int8-dot scores are integral and
    # exact in f32, and dim is a power of two, so score_i/dim == score
    row_s, neg_s, sid_s = jax.lax.sort(
        (key_row, key_neg, sid), num_keys=3, is_stable=True
    )
    score_s = (-neg_s).astype(jnp.float32) / dim
    first = jnp.concatenate(
        [jnp.ones((1,), bool), row_s[1:] != row_s[:-1]]
    )
    # (row, sid) duplicates sort adjacent (equal row => equal score
    # for equal sid, and sid is the third key); the seg impl leaves
    # them in the stream, so mask them here and rank over survivors.
    # The gather impl pre-dedups and this mask is all-False there.
    dup = jnp.concatenate(
        [
            jnp.zeros((1,), bool),
            jnp.logical_and(
                row_s[1:] == row_s[:-1], sid_s[1:] == sid_s[:-1]
            ),
        ]
    )
    keep2 = jnp.logical_and(row_s < big, jnp.logical_not(dup))
    rank = rank_in_segments(keep2, first)
    topk_keep = jnp.logical_and(keep2, rank < k)
    final_count = jnp.sum(topk_keep.astype(jnp.int32))

    out_pos = nonzero_compact(topk_keep, max_out)
    out_safe = jnp.maximum(out_pos, 0)
    out_valid = out_pos >= 0
    qpos = jnp.where(out_valid, row_s[out_safe], -1)
    sidx = jnp.where(out_valid, sid_s[out_safe], 0)
    sc = score_s[out_safe]
    count = jnp.maximum(
        final_count,
        jnp.where(
            pair_count > pair_budget,
            jnp.int32(max_out) + pair_count - pair_budget,
            0,
        ),
    )
    return (qpos, sidx, sc, count), at_risk


@functools.partial(
    jax.jit,
    static_argnames=(
        "n", "cap", "num_buckets", "salts", "k", "dim", "threshold",
        "max_out", "risk_budget", "pairs_mode", "impl",
    ),
)
def bucketed_hybrid_parts(
    stream, q_emb, entries, offsets, s_emb_padded, *,
    n, cap, num_buckets, salts, k, dim, threshold, max_out,
    risk_budget, pairs_mode="triangles", impl="seg",
):
    """Hybrid stage 1: the flat bucketed path with at-risk queries
    (those probing any over-cap bucket, where the pigeonhole guarantee
    may be lost) dropped, plus the compacted at-risk row list for the
    exact-kernel fallback (stage 2, ``exact_on_risk_rows``).

    Returns (qpos, sidx, sc, count, risk_rows, risk_count): risk_rows
    int32 [risk_budget], -1 padded; risk_count may exceed risk_budget
    (the caller re-invokes with a bigger pow2 budget — same sticky-
    budget contract as the engine's candidate retry)."""
    from fandom_search.search.engine import nonzero_compact

    (qpos, sidx, sc, count), at_risk = _flat_impl(
        stream, q_emb, entries, offsets, s_emb_padded,
        n=n, cap=cap, num_buckets=num_buckets, salts=salts, k=k, dim=dim,
        threshold=threshold, max_out=max_out, pairs_mode=pairs_mode,
        drop_risk=True, impl=impl,
    )
    risk_rows = nonzero_compact(at_risk, risk_budget)
    risk_count = jnp.sum(at_risk.astype(jnp.int32))
    return qpos, sidx, sc, count, risk_rows, risk_count


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "dim", "threshold", "max_out", "interpret", "max_abs_score",
        "kernels",
    ),
)
def exact_on_risk_rows(
    q_emb, risk_rows, s_emb_padded, ns_valid, *,
    k, dim, threshold, max_out, kernels, interpret=False,
    max_abs_score=4608,
):
    """Hybrid stage 2: exact fused top-k for ONLY the at-risk queries.

    Gathers the at-risk rows into a compact [risk_budget, D] matrix,
    runs the same fused distance+top-k kernel the engine's exact path
    uses (scores identical in semantics — dot/dim, min_keep at the
    candidate threshold), and emits engine-ready (qpos, sidx, score)
    triples mapped back to original query positions, compacted to
    ``max_out`` with an exact count (the engine's pow2 retry handles
    overflow).  Cost is O(R * NS) for R at-risk queries — the hybrid
    stays sub-linear overall whenever the at-risk fraction is small,
    and degrades to the exact kernel (never worse than ~probe overhead)
    on fully skewed corpora."""
    from fandom_search.search.engine import nonzero_compact

    valid_row = risk_rows >= 0
    safe = jnp.clip(risk_rows, 0, q_emb.shape[0] - 1)
    qr = jnp.take(q_emb, safe, axis=0)               # [RB, D]
    # zero the padding rows (their keep-mask is already False via
    # valid_row; zeroing just keeps garbage out of the product)
    qr = jnp.where(valid_row[:, None], qr, jnp.int8(0))
    vals, idx = topk_dot(
        qr, s_emb_padded, ns_valid, k=k, dim=dim, kernels=kernels,
        interpret=interpret, min_keep=threshold,
        max_abs_score=max_abs_score,
    )
    keep = jnp.logical_and(vals >= threshold, valid_row[:, None])
    pos = nonzero_compact(keep.ravel(), max_out)     # [max_out]
    psafe = jnp.maximum(pos, 0)
    pvalid = pos >= 0
    row = psafe // k
    qpos = jnp.where(pvalid, risk_rows[row], -1)
    sidx = jnp.where(pvalid, idx.ravel()[psafe], 0)
    sc = vals.ravel()[psafe]
    return qpos, sidx, sc, jnp.sum(keep.astype(jnp.int32))


class HybridSubmission:
    """Stage 1 dispatched NOW, the data-dependent rest deferred.

    Constructing this submits the bucketed stage-1 jit (async
    dispatch, no host sync); ``resolve()`` pulls the at-risk count and
    runs the risk-budget retry / exact-fallback stage 2 / merge.
    Splitting submit from resolve lets the engine queue batch N+1's
    stage 1 BEFORE syncing batch N (advisor r2 low: the eager rc pull
    in drive_hybrid serialized the lookahead pipeline even for rc=0
    batches).

    Parametrized over two callables so the single-device path
    (``drive_hybrid``) and the mesh-sharded path
    (parallel/sharded_bucketed.py) share the ONE retry/merge contract:

    * ``submit_fn(max_out, risk_budget)`` -> 6-tuple
      (qpos, sidx, sc, count, risk_rows, risk_count) — the
      bucketed_hybrid_parts contract;
    * ``exact_fn(risk_rows, max_out)`` -> (qpos, sidx, sc, count) —
      the exact_on_risk_rows contract.
    """

    def __init__(
        self, submit_fn, exact_fn, *, max_out, risk_budget,
        grow_max_out=False,
    ):
        self._submit_fn = submit_fn
        self._exact_fn = exact_fn
        self.max_out = max_out
        self.risk_budget = risk_budget
        self.grow_max_out = grow_max_out
        self._parts = submit_fn(self.max_out, self.risk_budget)

    def resolve(self):
        """Returns ((qpos, sidx, sc, count), risk_count, max_out,
        risk_budget) — pass the grown budgets back in to stay sticky."""
        while True:
            parts = self._parts
            rc = int(np.asarray(parts[5]))
            if rc > self.risk_budget:
                self.risk_budget = _next_pow2_int(rc, self.risk_budget * 2)
                self._parts = self._submit_fn(
                    self.max_out, self.risk_budget
                )
                continue
            qp, si, sc, cnt = parts[:4]
            if rc:
                # Right-size stage 2 to the ACTUAL at-risk count: the
                # sticky risk_budget only grows, and the exact kernel's
                # cost is O(rows * NS) — one stopword-dense batch must
                # not make every later rc=1 batch pay a full
                # budget-sized pass.  Quarter-pow2 (not pow2) sizing:
                # on heavily skewed corpora rc approaches M and pow2
                # rounding can DOUBLE stage 2 (rc = 0.87*M pads to M,
                # erasing the hybrid's entire margin over the exact
                # kernel); quarter-pow2 caps the overshoot at 25% for
                # <= 4 compiled shapes per octave (DESIGN.md §4).
                rb2 = _next_qpow2(rc, 1024)
                qe, se, sce, ce = self._exact_fn(
                    parts[4][:rb2], self.max_out
                )
                qp, si, sc, cnt = merge_triples(
                    qp, si, sc, cnt, qe, se, sce, ce,
                    max_out=self.max_out,
                )
            if self.grow_max_out:
                c = int(np.asarray(cnt))
                if c > self.max_out:
                    self.max_out = _next_pow2_int(c, self.max_out * 2)
                    self._parts = self._submit_fn(
                        self.max_out, self.risk_budget
                    )
                    continue
            return (qp, si, sc, cnt), rc, self.max_out, self.risk_budget


def make_hybrid_submission(
    stream, q_emb, entries, offsets, s_emb_padded, ns_valid, *,
    n, cap, num_buckets, salts, k, dim, threshold, pairs_mode,
    max_out, risk_budget, kernels, interpret=False, max_abs_score=4608,
    grow_max_out=False,
):
    """Single-device HybridSubmission wired to bucketed_hybrid_parts +
    exact_on_risk_rows."""

    def submit(mo, rb):
        return bucketed_hybrid_parts(
            stream, q_emb, entries, offsets, s_emb_padded,
            n=n, cap=cap, num_buckets=num_buckets, salts=salts,
            k=k, dim=dim, threshold=threshold, max_out=mo,
            risk_budget=rb, pairs_mode=pairs_mode,
        )

    def exact(risk_rows, mo):
        return exact_on_risk_rows(
            q_emb, risk_rows, s_emb_padded, ns_valid,
            k=k, dim=dim, threshold=threshold, max_out=mo,
            kernels=kernels, interpret=interpret,
            max_abs_score=max_abs_score,
        )

    return HybridSubmission(
        submit, exact, max_out=max_out, risk_budget=risk_budget,
        grow_max_out=grow_max_out,
    )


def drive_hybrid(
    stream, q_emb, entries, offsets, s_emb_padded, ns_valid, *,
    n, cap, num_buckets, salts, k, dim, threshold, pairs_mode,
    max_out, risk_budget, kernels, interpret=False, max_abs_score=4608,
    grow_max_out=False,
):
    """Host driver for the hybrid path: stage 1 (bucketed, at-risk rows
    dropped) with pow2 risk-budget retry, stage 2 (exact kernel on the
    at-risk rows) when any exist, merged triples.

    This is the ONE implementation of the retry/merge contract — the
    engine attach (via HybridSubmission for pipelining), the bench,
    and the probe script all run it so the measurement harnesses
    cannot drift from what the engine runs.

    ``grow_max_out=False`` (engine mode): a combined count above
    ``max_out`` is returned as-is — the engine's sticky-budget retry
    re-invokes with a bigger budget before consuming anything.
    ``grow_max_out=True`` (bench/probe mode): this driver grows
    ``max_out`` itself so the returned triples are never truncated.

    Returns ((qpos, sidx, sc, count), risk_count, max_out, risk_budget)
    — pass the grown budgets back in to stay sticky."""
    return make_hybrid_submission(
        stream, q_emb, entries, offsets, s_emb_padded, ns_valid,
        n=n, cap=cap, num_buckets=num_buckets, salts=salts, k=k,
        dim=dim, threshold=threshold, pairs_mode=pairs_mode,
        max_out=max_out, risk_budget=risk_budget, kernels=kernels,
        interpret=interpret,
        max_abs_score=max_abs_score, grow_max_out=grow_max_out,
    ).resolve()


@functools.partial(jax.jit, static_argnames=("max_out",))
def merge_triples(qb, sb, scb, cb, qe, se, sce, ce, *, max_out):
    """Concatenate two compacted triple sets into one [max_out] set.

    The bucketed triples occupy [0, cb), the exact-fallback triples
    [cb, cb+ce); the combined count may exceed max_out, which the
    engine's retry contract handles before anything is consumed."""
    iota = jnp.arange(max_out, dtype=jnp.int32)
    j = jnp.clip(iota - cb, 0, qe.shape[0] - 1)
    from_e = iota >= cb
    q = jnp.where(from_e, qe[j], qb)
    s = jnp.where(from_e, se[j], sb)
    sc = jnp.where(from_e, sce[j], scb)
    return q, s, sc, cb + ce


def _attach_pure_flat(engine, cfg, bidx, s_emb_padded) -> None:
    """Wire the pure flat bucketed path as the engine's candidate
    stage (shared by hybrid=False and the zero-overflow fast path)."""
    from fandom_search.data.shingler import embed_shingles

    scfg = engine.cfg.shingle
    xcfg = engine.cfg.search

    @functools.partial(jax.jit, static_argnames=("max_out",))
    def candidates(stream, s_emb, ns_valid, mults, *, max_out):
        q_emb = embed_shingles(stream, scfg, mults=mults)
        return bucketed_candidates_flat(
            stream, q_emb, bidx.entries, bidx.offsets, s_emb,
            n=scfg.n, cap=cfg.cap, num_buckets=bidx.num_buckets,
            salts=bidx.salts, k=xcfg.k, dim=scfg.dim,
            threshold=xcfg.candidate_threshold, max_out=max_out,
            pairs_mode=cfg.pairs,
        )

    engine._use_fused = False
    engine._candidates_fn = (
        lambda stream, _s, _n, mults, max_out: candidates(
            stream, s_emb_padded, _n, mults, max_out=max_out
        )
    )


def validate_and_place_bucketed(
    engine, cfg: BucketedConfig, bidx: BucketedIndex | None
) -> BucketedIndex:
    """Shared attach-time validation + device placement (used by the
    single-device attach below and the mesh-sharded attach in
    parallel/sharded_bucketed.py): k vs probe width, table/index row
    agreement, the pure-mode skew refusal, and the hybrid skew
    warning.  Returns the device-resident BucketedIndex."""
    p_width = len(_pairs_for(engine.cfg.shingle.n, cfg.pairs)) * cfg.cap
    if engine.cfg.search.k > p_width:
        raise ValueError(
            f"k ({engine.cfg.search.k}) cannot exceed the bucketed probe "
            f"width (P*cap = {p_width})"
        )
    if bidx is None:
        bidx = BucketedIndex.build(
            engine.index.shingle_windows, cfg, engine.cfg.shingle
        )
    elif bidx.ns_valid != engine.index.num_shingles:
        raise ValueError(
            f"bucketed index covers {bidx.ns_valid} shingles; engine "
            f"index has {engine.index.num_shingles} — rebuild it"
        )
    else:  # persisted tables arrive as host arrays
        bidx = BucketedIndex(
            entries=jax.device_put(jnp.asarray(bidx.entries)),
            offsets=jax.device_put(jnp.asarray(bidx.offsets)),
            num_buckets=bidx.num_buckets,
            salts=tuple(bidx.salts),
            ns_valid=bidx.ns_valid,
            overflow_frac=bidx.overflow_frac,
        )
    if not cfg.hybrid and bidx.overflow_frac > 0.05:
        # Pure mode: a skewed (Zipf stopword-heavy) vocabulary
        # overflows hot pair-buckets and silently loses the recall
        # guarantee (measured: 70% overflow -> thresholded recall 0.06
        # on a Zipf-1.3 corpus).  Refuse
        # rather than degrade; the default hybrid mode instead reroutes
        # at-risk queries through the exact kernel.
        raise ValueError(
            f"bucketed index has {bidx.overflow_frac:.0%} of entries in "
            f"over-cap buckets (cap={cfg.cap}); this corpus's word-pair "
            f"distribution is too skewed for the pure bucketed "
            f"prefilter — enable the hybrid (BucketedConfig.hybrid), "
            f"use the exact kernel (drop --bucketed), or raise cap/"
            f"load_factor"
        )
    if bidx.overflow_frac > 0.05:
        import logging

        logging.getLogger(__name__).warning(
            "bucketed index has %.0f%% of entries in over-cap buckets "
            "(cap=%d): the word-pair distribution is skewed, so a large "
            "query fraction will reroute through the exact kernel "
            "(hybrid fallback) — expect near-exact-kernel wall-clock",
            100 * bidx.overflow_frac, cfg.cap,
        )
    return bidx


def attach_bucketed_prefilter(
    engine, cfg: BucketedConfig, bidx: BucketedIndex | None = None
) -> None:
    """Swap a SearchEngine's candidate stage for the bucketed pipeline
    (the engine's two-stage path then calls it per batch)."""
    from fandom_search.data.shingler import embed_shingles

    bidx = validate_and_place_bucketed(engine, cfg, bidx)
    engine.bucketed = bidx
    scfg = engine.cfg.shingle
    xcfg = engine.cfg.search
    s_emb_padded = engine._s_emb_padded
    ns_true = engine.index.num_shingles

    if not cfg.hybrid or bidx.overflow_frac == 0.0:
        # Pure stage-1 path, two ways in: hybrid explicitly disabled,
        # or NO bucket anywhere overflows cap so no query can ever be
        # at risk.  In the latter case skipping the risk machinery
        # matters: no per-batch device->host risk-count pull, which
        # would break the engine's submit/process pipelining for
        # nothing.  (Byte-identical triples either way; the hybrid
        # wrapper below degenerates to this when rc == 0.)
        _attach_pure_flat(engine, cfg, bidx, s_emb_padded)
        return

    interpret = bool(getattr(engine, "interpret", False))
    smax = scfg.n * scfg.n * scfg.dim
    embed_jit = jax.jit(
        lambda stream, mults: embed_shingles(stream, scfg, mults=mults)
    )

    # sticky risk budget, pow2-grown like the engine's candidate budget
    # (>= 1024 keeps the gathered row count tile-aligned for the kernel)
    engine._bucketed_risk_budget = max(
        1024, getattr(engine, "_bucketed_risk_budget", 0)
    )
    # Host-visible risk accounting, reset per search by
    # SearchEngine.search_works.  APPROXIMATE by design: both counters
    # accumulate per invocation over the padded stream positions, so an
    # engine budget retry re-counts its batch (numerator and
    # denominator together — the per-batch ratio is preserved, the
    # cross-batch weighting slightly favors retried batches).
    engine._bucketed_risk_queries = 0
    engine._bucketed_total_queries = 0

    class _DeferredHybrid:
        """Duck-typed deferred candidates (engine._process_batch calls
        ``resolve()`` at process time): stage 1 is already dispatched
        by construction, so the submit path stays sync-free and the
        lookahead pipeline survives nonzero overflow_frac corpora."""

        def __init__(self, stream, max_out):
            q_emb = embed_jit(stream, engine._mults)
            self._stream_len = int(stream.shape[0])
            self._sub = make_hybrid_submission(
                stream, q_emb, bidx.entries, bidx.offsets,
                s_emb_padded, engine._ns_valid,
                n=scfg.n, cap=cfg.cap, num_buckets=bidx.num_buckets,
                salts=bidx.salts, k=xcfg.k, dim=scfg.dim,
                threshold=xcfg.candidate_threshold,
                pairs_mode=cfg.pairs, max_out=max_out,
                risk_budget=engine._bucketed_risk_budget,
                kernels=engine.kernels, interpret=interpret,
                max_abs_score=smax,
                grow_max_out=False,  # the engine owns the max_out retry
            )

        def resolve(self):
            out, rc, _, engine._bucketed_risk_budget = (
                self._sub.resolve()
            )
            engine._bucketed_risk_queries += rc
            engine._bucketed_total_queries += max(
                0, self._stream_len - scfg.n + 1
            )
            return out

    engine._use_fused = False
    engine._candidates_fn = (
        lambda stream, _s, _n, mults, max_out:
            _DeferredHybrid(stream, max_out)
    )


def _next_pow2_int(n: int, floor: int) -> int:
    """engine._next_pow2, imported lazily (the engine imports run both
    ways at function scope, never at module scope)."""
    from fandom_search.search.engine import _next_pow2

    return _next_pow2(n, max(1, floor))


def _next_qpow2(n: int, floor: int) -> int:
    """Smallest quarter-pow2 (2^k * {1, 1.25, 1.5, 1.75}) >= max(n,
    floor).  Used to size the stage-2 at-risk gather: overshoot <= 25%
    (vs 100% for pow2) at <= 4 distinct compiled shapes per octave."""
    n = max(int(n), int(floor), 1)
    p = 1
    while p < n:
        p *= 2
    if p == n or p < 8:  # tiny sizes: pow2 only (p//4 would be 0/odd)
        return p
    base = p // 2
    for num in (5, 6, 7):  # 1.25, 1.5, 1.75 * base
        q = base * num // 4
        if q >= n:
            return q
    return p
