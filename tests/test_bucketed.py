"""Bucketed inverted-index prefilter (ops/bucketed.py).

The load-bearing property is the pigeonhole guarantee of the shipped
triangle-group covering: any candidate with >= ceil(n/3) + 1
exactly-matching positions (n=6: >= 3) MUST be found (absent
bucket-cap overflow), with scores identical to the exact kernel's —
matching ops/bucketed.py's module doc and the >=3 assertions below.  Raw recall on noise queries is explicitly NOT promised —
that is the documented thresholded-recall contract.
"""

import dataclasses

import numpy as np
import pytest

from fandom_search.config import BucketedConfig, PipelineConfig
from fandom_search.data.shingler import embed_shingles_np, shingle_hashes
from fandom_search.ops.bucketed import (
    BucketedIndex,
    attach_bucketed_prefilter,
    bucketed_topk,
)
from fandom_search.ops.distance_topk import pad_rows, topk_dot_jnp

CFG = PipelineConfig()
SCFG = CFG.shingle
K = CFG.search.k
DIM = SCFG.dim
BCFG = BucketedConfig()


def _world(rng, nq=512, ns=1500, plant_every=7):
    """Random streams with planted near-quotes: every ``plant_every``-th
    query shingle copies a script shingle with <= 2 positions mutated
    (>= 4 matches -> inside the guarantee)."""
    s_stream = rng.integers(0, 2**32, size=ns + SCFG.n - 1, dtype=np.uint32)
    q_stream = rng.integers(0, 2**32, size=nq + SCFG.n - 1, dtype=np.uint32)
    for qi in range(0, nq, plant_every):
        si = int(rng.integers(0, ns))
        q_stream[qi : qi + SCFG.n] = s_stream[si : si + SCFG.n]
        n_mut = int(rng.integers(0, 3))  # 0..2 mutations
        for p in rng.choice(SCFG.n, size=n_mut, replace=False):
            q_stream[qi + p] = rng.integers(0, 2**32, dtype=np.uint32)
    return q_stream, s_stream


def test_guaranteed_candidates_match_exact_kernel(rng):
    q_stream, s_stream = _world(rng)
    windows = shingle_hashes(s_stream, SCFG)
    q_emb = embed_shingles_np(q_stream, SCFG)
    s_emb = embed_shingles_np(s_stream, SCFG)
    bidx = BucketedIndex.build(windows, BCFG, SCFG)
    assert bidx.overflow_frac == 0.0  # uniform hashes: no hot buckets

    s_pad, _ = pad_rows(s_emb, 512)
    bvals, bidx_out = bucketed_topk(
        q_emb, q_stream, bidx, s_pad, K, DIM, BCFG, SCFG
    )
    evals, eidx = topk_dot_jnp(q_emb, s_emb, k=K, dim=DIM)
    bvals, bidx_out = np.asarray(bvals), np.asarray(bidx_out)
    evals, eidx = np.asarray(evals), np.asarray(eidx)

    thr = CFG.search.candidate_threshold
    q_windows = shingle_hashes(q_stream, SCFG)
    # every exact-kernel entry above the engine threshold whose TRUE
    # exact-match count is inside the pigeonhole guarantee (>= 3 for
    # n=6) must appear in the bucketed result with the same score and
    # index; sub-guarantee entries (2 matches riding +2.8-sigma noise)
    # are the documented residual
    checked = 0
    for i in range(evals.shape[0]):
        for j in range(K):
            if evals[i, j] >= thr:
                true_matches = int(
                    (q_windows[i] == windows[eidx[i, j]]).sum()
                )
                if true_matches < 3:
                    continue
                # exactly one LIVE occurrence (padding slots repeat ids
                # of masked duplicates but score NEG_INF)
                hits = np.where(
                    (bidx_out[i] == eidx[i, j]) & (bvals[i] > -1e30)
                )[0]
                assert hits.size == 1, (i, j, eidx[i, j], true_matches)
                assert bvals[i, hits[0]] == pytest.approx(evals[i, j])
                checked += 1
    assert checked > 50  # the plants actually exercised the guarantee


def test_no_duplicate_candidates(rng):
    q_stream, s_stream = _world(rng, nq=256, ns=800)
    windows = shingle_hashes(s_stream, SCFG)
    bidx = BucketedIndex.build(windows, BCFG, SCFG)
    from fandom_search.ops.bucketed import probe_candidates

    cand, ok, _ = probe_candidates(
        q_stream, bidx.entries, bidx.offsets,
        n=SCFG.n, cap=BCFG.cap, num_buckets=bidx.num_buckets,
        salts=bidx.salts,
    )
    cand, ok = np.asarray(cand), np.asarray(ok)
    for i in range(cand.shape[0]):
        v = cand[i][ok[i]]
        assert len(v) == len(np.unique(v))


def test_identical_shingle_found_via_every_pair(rng):
    """An exact copy shares ALL pair buckets; it must be reported once
    with a full score of n."""
    s_stream = rng.integers(0, 2**32, size=64 + SCFG.n - 1, dtype=np.uint32)
    q_stream = s_stream[: 32 + SCFG.n - 1].copy()
    windows = shingle_hashes(s_stream, SCFG)
    bidx = BucketedIndex.build(windows, BCFG, SCFG)
    q_emb = embed_shingles_np(q_stream, SCFG)
    s_emb = embed_shingles_np(s_stream, SCFG)
    s_pad, _ = pad_rows(s_emb, 512)
    vals, idx = bucketed_topk(
        q_emb, q_stream, bidx, s_pad, K, DIM, BCFG, SCFG
    )
    vals, idx = np.asarray(vals), np.asarray(idx)
    evals, eidx = (
        np.asarray(x) for x in topk_dot_jnp(q_emb, s_emb, k=K, dim=DIM)
    )
    for qi in range(vals.shape[0]):
        assert idx[qi, 0] == qi == eidx[qi, 0]
        # self-dot = n + cross-position noise; must equal the exact
        # kernel's value bit-for-bit
        assert vals[qi, 0] == evals[qi, 0]
        assert vals[qi, 0] > SCFG.n - 2


def test_cap_overflow_reported(rng):
    """A hot bucket (repeated identical pair) shows up in overflow_frac."""
    ns = 400
    s_stream = rng.integers(0, 2**32, size=ns + SCFG.n - 1, dtype=np.uint32)
    # force one bigram to repeat in ~half the shingles at positions 0,1
    s_stream[0:ns:2] = 12345
    s_stream[1:ns:2] = 67890
    windows = shingle_hashes(s_stream, SCFG)
    bidx = BucketedIndex.build(
        windows, dataclasses.replace(BCFG, cap=8), SCFG
    )
    assert bidx.overflow_frac > 0.1


def test_engine_with_bucketed_matches_exact_rows(rng):
    """End-to-end: engine rows with the bucketed prefilter equal the
    exact engine's rows (quotes are above-threshold, so the guarantee
    covers them)."""
    from fandom_search.data.script_parser import parse_script
    from fandom_search.search.engine import SearchEngine
    from fandom_search.search.index import build_script_index
    from fandom_search.utils.synthetic import (
        make_corpus_with_quotes, make_script, make_vocab,
    )

    cfg = dataclasses.replace(
        CFG, search=dataclasses.replace(CFG.search, batch_queries=4096)
    )
    vocab = make_vocab(rng, 800)
    lines = parse_script(make_script(rng, vocab, num_lines=20))
    index = build_script_index(lines, cfg.shingle, cfg.search)
    works, _ = make_corpus_with_quotes(
        rng, [ln.text for ln in lines], num_works=12, words_per_work=200,
        quotes_per_work=2, vocab=vocab,
    )
    exact = SearchEngine(index, cfg, interpret=True)
    want, _ = exact.search_works(works)

    eng = SearchEngine(index, cfg, interpret=True)
    attach_bucketed_prefilter(eng, BCFG)
    assert eng.bucketed.ns_valid == index.num_shingles
    got, stats = eng.search_works(works)
    key = lambda r: (r.work_id, r.fan_token_start, r.line_no)  # noqa: E731
    assert {key(r) for r in got} == {key(r) for r in want}
    assert stats.num_verified > 0

    # stale prebuilt index is rejected
    with pytest.raises(ValueError, match="rebuild"):
        other = SearchEngine(index, cfg, interpret=True)
        bad = dataclasses.replace(eng.bucketed, ns_valid=3)
        attach_bucketed_prefilter(other, BCFG, bidx=bad)


def test_flat_candidates_match_exact_kernel_triples(rng):
    """The flat path's triples must equal the exact kernel's
    above-threshold top-k triples for guaranteed (>=3-match) rows."""
    import jax.numpy as jnp

    from fandom_search.ops.bucketed import bucketed_candidates_flat

    q_stream, s_stream = _world(rng, nq=512, ns=1500)
    windows = shingle_hashes(s_stream, SCFG)
    q_emb = embed_shingles_np(q_stream, SCFG)
    s_emb = embed_shingles_np(s_stream, SCFG)
    bidx = BucketedIndex.build(windows, BCFG, SCFG)
    s_pad, _ = pad_rows(s_emb, 512)
    thr = CFG.search.candidate_threshold

    qpos, sidx, sc, count = bucketed_candidates_flat(
        jnp.asarray(q_stream), jnp.asarray(q_emb), bidx.entries,
        bidx.offsets, jnp.asarray(s_pad),
        n=SCFG.n, cap=BCFG.cap, num_buckets=bidx.num_buckets,
        salts=bidx.salts, k=K, dim=DIM, threshold=thr, max_out=4096,
    )
    qpos, sidx, sc = (np.asarray(x) for x in (qpos, sidx, sc))
    got = {
        (int(q), int(s), float(v))
        for q, s, v in zip(qpos, sidx, sc) if q >= 0
    }

    evals, eidx = (
        np.asarray(x) for x in topk_dot_jnp(q_emb, s_emb, k=K, dim=DIM)
    )
    q_windows = shingle_hashes(q_stream, SCFG)
    want_guaranteed = set()
    want_all = set()
    for i in range(evals.shape[0]):
        for j in range(K):
            if evals[i, j] >= thr:
                t = (i, int(eidx[i, j]), float(evals[i, j]))
                want_all.add(t)
                if (q_windows[i] == windows[eidx[i, j]]).sum() >= 3:
                    want_guaranteed.add(t)
    assert want_guaranteed <= got          # pigeonhole guarantee
    assert got <= want_all                 # never invents candidates
    assert len(want_guaranteed) > 50


def test_flat_candidates_budget_overflow_reported(rng):
    """Overflowing the pair budget must surface in the returned count
    (> max_out) so the engine's sticky retry grows the budget."""
    import jax.numpy as jnp

    from fandom_search.ops.bucketed import bucketed_candidates_flat

    # every shingle identical (alternating 2-token stream): each query
    # pulls cap entries from every probe -> ~cap unique pairs per
    # query, far above the pow2(2*M + 8*max_out) pair budget
    nq, ns = 1024, 800
    q_stream = np.empty(nq + SCFG.n - 1, np.uint32)
    s_stream = np.empty(ns + SCFG.n - 1, np.uint32)
    q_stream[0::2], q_stream[1::2] = 111, 222
    s_stream[0::2], s_stream[1::2] = 111, 222
    windows = shingle_hashes(s_stream, SCFG)
    q_emb = embed_shingles_np(q_stream, SCFG)
    s_pad, _ = pad_rows(embed_shingles_np(s_stream, SCFG), 512)
    bidx = BucketedIndex.build(windows, BCFG, SCFG)
    thr = CFG.search.candidate_threshold
    tiny = 4
    qpos, sidx, sc, count = bucketed_candidates_flat(
        jnp.asarray(q_stream), jnp.asarray(q_emb), bidx.entries,
        bidx.offsets, jnp.asarray(s_pad),
        n=SCFG.n, cap=BCFG.cap, num_buckets=bidx.num_buckets,
        salts=bidx.salts, k=K, dim=DIM, threshold=thr, max_out=tiny,
    )
    assert int(count) > tiny


def test_all_pairs_mode_guarantees_two_matches(rng):
    """pairs="all" must find every >=2-exact-match above-threshold
    candidate (triangles only guarantees >=3)."""
    import dataclasses as dc

    import jax.numpy as jnp

    from fandom_search.ops.bucketed import bucketed_candidates_flat

    bcfg = dc.replace(BCFG, pairs="all")
    q_stream, s_stream = _world(rng, nq=512, ns=1500)
    windows = shingle_hashes(s_stream, SCFG)
    q_emb = embed_shingles_np(q_stream, SCFG)
    s_emb = embed_shingles_np(s_stream, SCFG)
    bidx = BucketedIndex.build(windows, bcfg, SCFG)
    s_pad, _ = pad_rows(s_emb, 512)
    thr = CFG.search.candidate_threshold

    qpos, sidx, sc, count = bucketed_candidates_flat(
        jnp.asarray(q_stream), jnp.asarray(q_emb), bidx.entries,
        bidx.offsets, jnp.asarray(s_pad),
        n=SCFG.n, cap=bcfg.cap, num_buckets=bidx.num_buckets,
        salts=bidx.salts, k=K, dim=DIM, threshold=thr, max_out=8192,
        pairs_mode="all",
    )
    qpos, sidx = np.asarray(qpos), np.asarray(sidx)
    got = {(int(q), int(s)) for q, s in zip(qpos, sidx) if q >= 0}

    evals, eidx = (
        np.asarray(x) for x in topk_dot_jnp(q_emb, s_emb, k=K, dim=DIM)
    )
    q_windows = shingle_hashes(q_stream, SCFG)
    checked = 0
    for i in range(evals.shape[0]):
        for j in range(K):
            if evals[i, j] >= thr:
                tm = int((q_windows[i] == windows[eidx[i, j]]).sum())
                if tm >= 2:
                    assert (i, int(eidx[i, j])) in got, (i, j, tm)
                    checked += 1
    assert checked > 50


def _skewed_world(rng, num_lines=30, num_works=8, words_per_work=220):
    """A Zipf-like script: every line leads with the same stopword run
    (hot pair-buckets overflow cap), then unique words; works carry
    planted quotes of those lines."""
    from fandom_search.data.script_parser import parse_script
    from fandom_search.search.index import build_script_index
    from fandom_search.utils.synthetic import (
        make_corpus_with_quotes, make_vocab,
    )

    vocab = make_vocab(rng, 600)
    lines_txt = "\n".join(
        "ALICE: of the of the "
        + " ".join(rng.choice(vocab, size=6).tolist())
        for _ in range(num_lines)
    )
    lines = parse_script(lines_txt)
    index = build_script_index(lines, CFG.shingle, CFG.search)
    works, _ = make_corpus_with_quotes(
        rng, [ln.text for ln in lines], num_works=num_works,
        words_per_work=words_per_work, quotes_per_work=2, vocab=vocab,
    )
    return lines, index, works


def test_pure_mode_refuses_skewed_corpus(rng):
    """hybrid=False keeps the round-2 contract: a Zipf-skewed index
    (hot pair-buckets overflowing cap) is refused at attach time, not
    silently degraded."""
    from fandom_search.search.engine import SearchEngine

    _, index, _ = _skewed_world(rng)
    eng = SearchEngine(index, CFG, interpret=True)
    with pytest.raises(ValueError, match="too skewed"):
        attach_bucketed_prefilter(
            eng, dataclasses.replace(BCFG, hybrid=False)
        )


@pytest.mark.parametrize("seed", [42, 7, 1234])
def test_hybrid_rescues_skewed_corpus(seed):
    """Default hybrid mode on the same skewed corpus: at-risk queries
    reroute through the exact kernel, and engine rows equal the exact
    engine's rows (where the pure bucketed path measured thresholded
    recall 0.06).  Fuzzed across corpus seeds."""
    from fandom_search.search.engine import SearchEngine

    rng = np.random.default_rng(seed)
    _, index, works = _skewed_world(rng)
    cfg = dataclasses.replace(
        CFG, search=dataclasses.replace(CFG.search, batch_queries=4096)
    )
    exact = SearchEngine(index, cfg, interpret=True)
    want, wstats = exact.search_works(works)
    assert wstats.num_verified > 0  # the planted quotes are findable

    eng = SearchEngine(index, cfg, interpret=True)
    attach_bucketed_prefilter(eng, BCFG)  # no refusal in hybrid mode
    assert eng.bucketed.overflow_frac > 0.05
    got, stats = eng.search_works(works)
    key = lambda r: (r.work_id, r.fan_token_start, r.line_no)  # noqa: E731
    assert {key(r) for r in got} == {key(r) for r in want}
    # the stopword-heavy stream really did reroute queries
    assert eng._bucketed_risk_queries > 0
    assert eng._bucketed_total_queries >= eng._bucketed_risk_queries


def test_hybrid_no_risk_keeps_pure_path(rng):
    """On a uniform corpus no query is at risk: the hybrid wrapper must
    return bit-identical triples to the pure flat path (stage 2 never
    runs)."""
    import jax.numpy as jnp

    from fandom_search.ops.bucketed import (
        bucketed_candidates_flat, bucketed_hybrid_parts,
    )

    q_stream, s_stream = _world(rng, nq=512, ns=1200)
    windows = shingle_hashes(s_stream, SCFG)
    bidx = BucketedIndex.build(windows, BCFG, SCFG)
    assert bidx.overflow_frac == 0.0
    q_emb = jnp.asarray(embed_shingles_np(q_stream, SCFG))
    s_pad, _ = pad_rows(
        jnp.asarray(embed_shingles_np(s_stream, SCFG)), 2048
    )
    kw = dict(
        n=SCFG.n, cap=BCFG.cap, num_buckets=bidx.num_buckets,
        salts=bidx.salts, k=K, dim=DIM,
        threshold=CFG.search.candidate_threshold, max_out=4096,
    )
    qs = jnp.asarray(q_stream)
    qp, si, sc, cnt = bucketed_candidates_flat(
        qs, q_emb, bidx.entries, bidx.offsets, s_pad, **kw
    )
    hqp, hsi, hsc, hcnt, risk_rows, risk_count = bucketed_hybrid_parts(
        qs, q_emb, bidx.entries, bidx.offsets, s_pad,
        risk_budget=1024, **kw
    )
    assert int(risk_count) == 0
    n = int(cnt)
    assert int(hcnt) == n
    np.testing.assert_array_equal(np.asarray(qp)[:n], np.asarray(hqp)[:n])
    np.testing.assert_array_equal(np.asarray(si)[:n], np.asarray(hsi)[:n])
    np.testing.assert_array_equal(np.asarray(sc)[:n], np.asarray(hsc)[:n])


def test_hybrid_risk_budget_retry(rng):
    """More at-risk queries than the sticky risk budget: the attach
    wrapper must grow the budget (pow2) and still produce exact rows."""
    from fandom_search.search.engine import SearchEngine

    # long stopword-only works: virtually every query shingle is at
    # risk, far beyond the 1024 floor
    _, index, works = _skewed_world(
        rng, num_lines=20, num_works=2, words_per_work=1200
    )
    hot = "of the " * 600
    works = {w: hot + t for w, t in works.items()}
    cfg = dataclasses.replace(
        CFG, search=dataclasses.replace(CFG.search, batch_queries=8192)
    )
    exact = SearchEngine(index, cfg, interpret=True)
    want, _ = exact.search_works(works)

    eng = SearchEngine(index, cfg, interpret=True)
    attach_bucketed_prefilter(eng, BCFG)
    assert eng._bucketed_risk_budget == 1024
    got, _ = eng.search_works(works)
    assert eng._bucketed_risk_budget > 1024  # the retry path ran
    key = lambda r: (r.work_id, r.fan_token_start, r.line_no)  # noqa: E731
    assert {key(r) for r in got} == {key(r) for r in want}


def test_next_qpow2_sizing():
    """Quarter-pow2 stage-2 sizing: overshoot <= 25% (pow2 rounding of
    a near-full at-risk set doubled stage 2 on skewed corpora —
    DESIGN.md §4.4), floor respected, pow2 values returned exactly."""
    from fandom_search.ops.bucketed import _next_qpow2

    assert _next_qpow2(0, 1024) == 1024
    assert _next_qpow2(1024, 1024) == 1024
    assert _next_qpow2(1025, 1024) == 1280   # 1.25 * 1024
    assert _next_qpow2(1281, 1024) == 1536
    assert _next_qpow2(1537, 1024) == 1792
    assert _next_qpow2(1793, 1024) == 2048
    for n in (3, 57000, 123457):
        got = _next_qpow2(n, 1024)
        assert got >= max(n, 1024)
        assert got <= 1.25 * max(n, 1024) + 1
    # the #5c regression shape: 56.7k at-risk of 65536 queries must
    # NOT pad back to the full query count
    assert _next_qpow2(56700, 1024) == 57344  # 1.75 * 2^15 < 2^16


def test_hybrid_english_skew_low_reroute(rng):
    """The realistic-text regime (DESIGN.md §4.4, bench #5d): English-
    like skew (zipf-1.05 over a 2^11 vocab at this scale) under
    pairs="all" must (a) reroute only a small query fraction — the
    sub-linear path survives real text, unlike the #5c stress corpus —
    and (b) reproduce EVERY >=2-position-match entry of the exact
    kernel's above-threshold top-k (the all-pairs pigeonhole
    guarantee: a 2-matcher's pair is probed; cold -> enumerated, hot
    -> this query rerouted through the exact kernel)."""
    import jax.numpy as jnp

    from fandom_search.ops.bucketed import drive_hybrid

    n = SCFG.n
    ns, nq, vocab = 8192, 2048, 1 << 11

    def zw(count):
        return (
            (rng.zipf(1.05, size=count) % vocab).astype(np.uint32)
            * np.uint32(0x9E3779B9)
        )

    s_stream = zw(ns + n - 1)
    q_stream = zw(nq + n - 1)
    for qi in range(0, nq, 10):
        si = int(rng.integers(0, ns))
        q_stream[qi : qi + n] = s_stream[si : si + n]
    bcfg = dataclasses.replace(BCFG, pairs="all")
    windows = shingle_hashes(s_stream, SCFG)
    bidx = BucketedIndex.build(windows, bcfg, SCFG)
    assert bidx.overflow_frac > 0  # skewed enough to have hot pairs
    q_emb = jnp.asarray(embed_shingles_np(q_stream, SCFG))
    s_pad, nsv = pad_rows(
        jnp.asarray(embed_shingles_np(s_stream, SCFG)), 2048
    )
    thr = CFG.search.candidate_threshold
    (qp, si_, sc, cnt), rc, _, _ = drive_hybrid(
        jnp.asarray(q_stream), q_emb, bidx.entries, bidx.offsets,
        s_pad, nsv, n=n, cap=bcfg.cap, num_buckets=bidx.num_buckets,
        salts=bidx.salts, k=K, dim=DIM, threshold=thr,
        pairs_mode="all", max_out=1 << 15, risk_budget=1024,
        kernels=False, grow_max_out=True,
    )
    assert 0 < rc < 0.3 * nq  # rerouted, but a small fraction
    ev, ei = topk_dot_jnp(q_emb, s_pad, k=K, dim=DIM)
    evn, ein = np.asarray(ev), np.asarray(ei)
    q_windows = shingle_hashes(q_stream, SCFG)
    ncnt = int(cnt)
    # guaranteed entries are matched by exact (query, score, sid)
    # triple — rerank scores are semantically identical to the exact
    # kernel's, and value-only multiset matching misattributes score
    # ties between a guaranteed and a noise entry
    got = set()
    for q, s, v in zip(
        np.asarray(qp)[:ncnt], np.asarray(si_)[:ncnt],
        np.asarray(sc)[:ncnt],
    ):
        if q >= 0:
            got.add((int(q), round(float(v) * DIM), int(s)))
    missed_guaranteed = 0
    for i in range(nq):
        keepm = np.logical_and(evn[i] >= thr, ein[i] < ns)
        if not keepm.any():
            continue
        for v, s in zip(np.round(evn[i][keepm] * DIM), ein[i][keepm]):
            if (
                (i, int(v), int(s)) not in got
                and int((q_windows[i] == windows[s]).sum()) >= 2
            ):
                missed_guaranteed += 1
    assert missed_guaranteed == 0


def test_native_table_build_parity(rng):
    """The C++ counting-sort table build (fastingest.cpp
    fs_bucketed_table) must be bit-identical to the NumPy
    stable-argsort path: entries, offsets, and overflow accounting."""
    import fandom_search.ops.bucketed as B
    from fandom_search.data.fast_tokenizer import native_available

    if not native_available():
        pytest.skip("native library unavailable")

    # uniform + skewed (hot repeated pair -> overflow) streams
    streams = [
        rng.integers(0, 2**32, size=3000, dtype=np.uint32),
    ]
    skew = rng.integers(0, 2**32, size=3000, dtype=np.uint32)
    skew[::3] = 7
    skew[1::3] = 9  # every third window shares the (7, 9) pair
    streams.append(skew)
    for s_stream in streams:
        windows = shingle_hashes(s_stream, SCFG)
        nat = B.BucketedIndex.build(windows, BCFG, SCFG)
        orig = B._build_tables_native
        B._build_tables_native = lambda *a, **k: None
        try:
            ref = B.BucketedIndex.build(windows, BCFG, SCFG)
        finally:
            B._build_tables_native = orig
        np.testing.assert_array_equal(
            np.asarray(nat.entries), np.asarray(ref.entries)
        )
        np.testing.assert_array_equal(
            np.asarray(nat.offsets), np.asarray(ref.offsets)
        )
        assert nat.overflow_frac == ref.overflow_frac


@pytest.mark.parametrize("pairs_mode", ["triangles", "all"])
def test_seg_impl_matches_gather_impl(rng, pairs_mode):
    """The round-3 segment-scatter flat path (impl="seg", default) must
    emit bit-identical triples to the round-2 padded-gather control
    (impl="gather") — planted worlds, both pair modes, and a skewed
    stream with at-risk queries through the hybrid (drop_risk) path."""
    import jax.numpy as jnp

    from fandom_search.ops.bucketed import (
        bucketed_candidates_flat, bucketed_hybrid_parts,
    )

    q_stream, s_stream = _world(rng, nq=700, ns=2000)
    # splice in a hot run so some buckets overflow cap (at-risk rows)
    q_stream[90:140] = 7
    s_stream[300:420] = 7
    windows = shingle_hashes(s_stream, SCFG)
    q_emb = embed_shingles_np(q_stream, SCFG)
    s_pad, _ = pad_rows(embed_shingles_np(s_stream, SCFG), 512)
    bidx = BucketedIndex.build(
        windows, dataclasses.replace(BCFG, pairs=pairs_mode), SCFG
    )
    thr = CFG.search.candidate_threshold
    kw = dict(
        n=SCFG.n, cap=BCFG.cap, num_buckets=bidx.num_buckets,
        salts=bidx.salts, k=K, dim=DIM, threshold=thr, max_out=4096,
        pairs_mode=pairs_mode,
    )
    args = (
        jnp.asarray(q_stream), jnp.asarray(q_emb), bidx.entries,
        bidx.offsets, jnp.asarray(s_pad),
    )
    flat_seg = bucketed_candidates_flat(*args, impl="seg", **kw)
    flat_gat = bucketed_candidates_flat(*args, impl="gather", **kw)
    for a, b in zip(flat_seg, flat_gat):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(flat_seg[3]) > 0

    hy_seg = bucketed_hybrid_parts(*args, risk_budget=256, impl="seg", **kw)
    hy_gat = bucketed_hybrid_parts(*args, risk_budget=256, impl="gather", **kw)
    for a, b in zip(hy_seg, hy_gat):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(hy_seg[5]) > 0  # the splice produced at-risk rows


def test_seg_stream_exact_fill():
    """Pair mass exactly equal to the budget with trailing EMPTY
    segments (round-3 advisor medium): the trailing empties' markers
    must park in the spare marker slot, not clip onto the budget's
    last real slot — otherwise slot budget-1 resolves to the wrong
    segment (bogus candidate emitted, true last pair dropped) and no
    retry fires because the mass does not exceed the budget."""
    import jax.numpy as jnp

    from fandom_search.ops.bucketed import _seg_stream

    ln = jnp.asarray([3, 2, 0, 0], jnp.int32)
    start = jnp.asarray([100, 200, 300, 400], jnp.int32)
    seg, epos, valid, pair_count = _seg_stream(ln, start, pair_budget=5)
    assert int(pair_count) == 5
    np.testing.assert_array_equal(np.asarray(seg), [0, 0, 0, 1, 1])
    np.testing.assert_array_equal(
        np.asarray(epos), [100, 101, 102, 200, 201]
    )
    assert bool(np.asarray(valid).all())

    # overflow regime unchanged: mass beyond the budget still reports
    # pair_count > budget so the engine's regrow retry fires
    seg2, _, valid2, pc2 = _seg_stream(
        jnp.asarray([4, 3], jnp.int32), jnp.asarray([0, 50], jnp.int32),
        pair_budget=5,
    )
    assert int(pc2) == 7 > 5
    assert bool(np.asarray(valid2).all())
    np.testing.assert_array_equal(np.asarray(seg2), [0, 0, 0, 0, 1])


def test_flat_path_rejects_degenerate_stream(rng):
    """A query stream shorter than the shingle width has zero query
    shingles; both flat impls must reject it identically instead of
    diverging on fabricated rows (round-3 advisor low)."""
    import jax.numpy as jnp

    from fandom_search.ops.bucketed import bucketed_candidates_flat

    q_stream, s_stream = _world(rng, nq=64, ns=500)
    windows = shingle_hashes(s_stream, SCFG)
    q_emb = embed_shingles_np(q_stream, SCFG)
    s_pad, _ = pad_rows(embed_shingles_np(s_stream, SCFG), 512)
    bidx = BucketedIndex.build(windows, BCFG, SCFG)
    kw = dict(
        n=SCFG.n, cap=BCFG.cap, num_buckets=bidx.num_buckets,
        salts=bidx.salts, k=K, dim=DIM,
        threshold=CFG.search.candidate_threshold, max_out=1024,
    )
    for impl in ("seg", "gather"):
        with pytest.raises(ValueError, match="shorter than the shingle"):
            bucketed_candidates_flat(
                jnp.asarray(q_stream[: SCFG.n - 1]), jnp.asarray(q_emb),
                bidx.entries, bidx.offsets, jnp.asarray(s_pad),
                impl=impl, **kw,
            )
