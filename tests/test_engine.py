"""End-to-end device engine vs the CPU oracle (SURVEY.md section 5 golden test)."""

import dataclasses

import numpy as np
import pytest

from fandom_search.config import PipelineConfig
from fandom_search.data.script_parser import parse_script
from fandom_search.search.engine import SearchEngine
from fandom_search.search.index import build_script_index
from fandom_search.search.oracle import search_works_oracle
from fandom_search.utils.synthetic import (
    make_corpus_with_quotes,
    make_script,
    make_vocab,
)

CFG = PipelineConfig()


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(11)
    vocab = make_vocab(rng, 1500)
    script_text = make_script(rng, vocab, num_lines=25, words_per_line=(7, 13))
    lines = parse_script(script_text)
    index = build_script_index(lines, CFG.shingle, CFG.search)
    dialogue = [ln.text for ln in lines]
    works, planted = make_corpus_with_quotes(
        rng, dialogue, num_works=8, words_per_work=300,
        quotes_per_work=2, num_edits=0, vocab=vocab,
    )
    # some mutated quotes too
    works2, planted2 = make_corpus_with_quotes(
        rng, dialogue, num_works=4, words_per_work=250,
        quotes_per_work=1, num_edits=1, vocab=vocab,
    )
    for wid, text in works2.items():
        works["mut_" + wid] = text
    return works, planted, index


def _row_key(r):
    return (r.work_id, r.fan_token_start, r.fan_token_end, r.line_no)


def test_engine_jnp_matches_oracle(world):
    works, planted, index = world
    oracle_rows, _ = search_works_oracle(works, index, CFG)
    eng = SearchEngine(index, CFG)
    rows, stats = eng.search_works(works)
    assert {_row_key(r) for r in rows} == {_row_key(r) for r in oracle_rows}
    assert stats.num_works == len(works)
    assert stats.num_verified > 0


def test_engine_pallas_matches_oracle(world):
    works, planted, index = world
    oracle_rows, _ = search_works_oracle(works, index, CFG)
    eng = SearchEngine(index, CFG, interpret=True)
    rows, _ = eng.search_works(works)
    assert {_row_key(r) for r in rows} == {_row_key(r) for r in oracle_rows}
    # scores should agree to rounding
    o = {_row_key(r): (r.score, r.verify_score) for r in oracle_rows}
    for r in rows:
        so, vo = o[_row_key(r)]
        assert abs(r.score - so) < 1e-3
        assert abs(r.verify_score - vo) < 1e-3


def test_engine_finds_planted(world):
    works, planted, index = world
    eng = SearchEngine(index, CFG)
    rows, _ = eng.search_works(works)
    found = {(r.work_id, r.line_no) for r in rows}
    missed = [p for p in planted if (p.work_id, p.line_no) not in found]
    assert not missed


def test_engine_empty_and_short_works(world):
    _, _, index = world
    eng = SearchEngine(index, CFG)
    rows, stats = eng.search_works({"empty": "", "short": "two words"})
    assert rows == []
    assert stats.num_works == 2


def test_engine_multi_batch(world):
    """Force tiny batches so the batch-packing path is exercised."""
    works, planted, index = world
    small = dataclasses.replace(
        CFG, search=dataclasses.replace(CFG.search, batch_queries=512)
    )
    eng = SearchEngine(index, small)
    rows, stats = eng.search_works(works)
    assert stats.num_batches > 1
    oracle_rows, _ = search_works_oracle(works, index, small)
    assert {_row_key(r) for r in rows} == {_row_key(r) for r in oracle_rows}


def test_nonzero_compact_matches_builtin(rng):
    import jax.numpy as jnp

    from fandom_search.search.engine import nonzero_compact

    for frac, size in [(0.0, 64), (0.01, 128), (0.5, 4096), (1.0, 512)]:
        mask = rng.random(4096) < frac
        want = np.asarray(
            jnp.nonzero(jnp.asarray(mask), size=size, fill_value=-1)[0]
        )
        got = np.asarray(nonzero_compact(jnp.asarray(mask), size))
        np.testing.assert_array_equal(got, want)


def test_chain_hits_arrays_equals_object_chainer(world):
    """Property: the vectorized chainer reproduces chain_hits exactly
    on random (already-deduped) hit sets."""
    works, _, index = world
    from fandom_search.data.fast_tokenizer import tokenize_many
    from fandom_search.search.chain import chain_hits, chain_hits_arrays
    from fandom_search.search.types import CandidateHit

    tokenized = tokenize_many({w: t for w, t in works.items()})
    wids = sorted(tokenized)
    rng = np.random.default_rng(99)
    seen = set()
    hits = []
    for _ in range(400):
        wi = int(rng.integers(len(wids)))
        tk = tokenized[wids[wi]]
        if len(tk) < 10:
            continue
        pos = int(rng.integers(len(tk) - 6))
        line = int(rng.integers(index.line_start.shape[0]))
        if (wi, pos, line) in seen:
            continue
        seen.add((wi, pos, line))
        hits.append((wi, pos, line, float(rng.random() * 6),
                     float(rng.random())))
    arr = np.array(hits, dtype=np.float64)
    rows_a = chain_hits_arrays(
        arr[:, 0].astype(np.int64), arr[:, 1].astype(np.int64),
        arr[:, 2].astype(np.int64), arr[:, 3].astype(np.float32),
        arr[:, 4].astype(np.float32), wids, tokenized, index,
        CFG.shingle, CFG.search,
    )
    objs = [
        CandidateHit(wids[int(w)], int(p), int(ln),
                     float(np.float32(s)), float(np.float32(v)))
        for w, p, ln, s, v in hits
    ]
    rows_o = chain_hits(objs, tokenized, index, CFG.shingle, CFG.search)
    assert [r.to_csv_row() for r in rows_a] == [r.to_csv_row() for r in rows_o]


def test_stream_buckets_scale_with_content(world):
    """Small corpora upload small pow2 buckets, capped at batch_queries."""
    _, _, index = world
    eng = SearchEngine(index, CFG)
    g = eng._batch_granule
    n = CFG.shingle.n
    from fandom_search.data.fast_tokenizer import tokenize_many

    def tpads_for(total_tokens):
        text = " ".join(f"w{i % 97}" for i in range(total_tokens))
        items = sorted(tokenize_many({"w0": text}).items())
        # payload is ("enc", c_ext, t_pad, p_pad, nspans) or
        # ("raw", ext, t_pad, nspans); t_pad is [2] in both.
        return [p[2] for _, p, _, _ in eng._batches(items)]

    # under one granule -> minimum bucket
    (t1,) = tpads_for(g // 2)
    assert t1 == g + n - 1
    # just over a granule -> next pow2 rung
    (t2,) = tpads_for(g + 10)
    assert t2 == 2 * g + n - 1
    # a work at the cap fills exactly one full-cap bucket
    cap = CFG.search.batch_queries
    (t3,) = tpads_for(cap)
    assert t3 == cap + n - 1


def test_bucketed_batches_match_oracle(world):
    """Rows are identical when works straddle several bucket sizes."""
    works, _, index = world
    # granule shrunk so the fixture corpus spans multiple rungs
    eng = SearchEngine(index, CFG)
    eng._batch_granule = 256
    rows, stats = eng.search_works(works)
    oracle_rows, _ = search_works_oracle(works, index, CFG)
    assert {_row_key(r) for r in rows} == {_row_key(r) for r in oracle_rows}


def test_engine_giant_work_split(world):
    """A work longer than the batch capacity is chunked with overlap."""
    works, planted, index = world
    rng = np.random.default_rng(3)
    vocab = make_vocab(rng, 500)
    line = index.lines[5].text
    body = " ".join(vocab[i] for i in rng.integers(0, len(vocab), 2000))
    giant = body + " " + line + " " + body
    small = dataclasses.replace(
        CFG, search=dataclasses.replace(CFG.search, batch_queries=1024)
    )
    eng = SearchEngine(index, small)
    rows, _ = eng.search_works({"giant": giant})
    assert any(r.line_no == 5 for r in rows)


def test_giant_work_split_exact_oracle_parity(world):
    """Split-chunk verification is BIT-identical to the oracle's
    (chunk-boundary windows must not shift scores): quotes planted at
    every chunk-boundary-relative offset, rows AND scores compared."""
    _, _, index = world
    rng = np.random.default_rng(17)
    vocab = make_vocab(rng, 500)
    cap = 1024
    w = CFG.search.window_tokens
    words = [vocab[i] for i in rng.integers(0, len(vocab), 4 * cap)]
    # plant quotes straddling / flanking each chunk boundary
    for c in (1, 2, 3):
        base = c * (cap - (w - 1))  # chunk start
        for off in (-40, -3, 0, 7, w // 2):
            pos = base + off
            q = index.lines[(c + off) % len(index.lines)].text.split()
            words[pos : pos + len(q)] = q
    giant = " ".join(words)
    small = dataclasses.replace(
        CFG, search=dataclasses.replace(CFG.search, batch_queries=cap)
    )
    eng = SearchEngine(index, small)
    rows, _ = eng.search_works({"giant": giant})
    oracle_rows, _ = search_works_oracle({"giant": giant}, index, small)
    assert [r.to_csv_row() for r in rows] == [
        r.to_csv_row() for r in oracle_rows
    ]


@pytest.mark.parametrize("seed", [101, 202, 303, 404])
def test_engine_fuzz_parity(seed):
    """Randomized corpora: engine rows == oracle rows, exactly.

    Varies vocab size (hash-collision density), work/line lengths,
    edit noise, and batch size across seeds — insurance against rare
    tie-break and boundary interactions the targeted tests miss.
    """
    rng = np.random.default_rng(seed)
    vocab = make_vocab(rng, int(rng.integers(50, 2000)))
    lines = parse_script(make_script(
        rng, vocab, num_lines=int(rng.integers(5, 40)),
        words_per_line=(3, 20),
    ))
    cfg = dataclasses.replace(
        CFG, search=dataclasses.replace(
            CFG.search,
            batch_queries=int(rng.choice([512, 1024, 4096])),
            k=int(rng.choice([3, 10])),
        )
    )
    index = build_script_index(lines, cfg.shingle, cfg.search)
    works, _ = make_corpus_with_quotes(
        rng, [ln.text for ln in lines],
        num_works=int(rng.integers(3, 12)),
        words_per_work=int(rng.integers(30, 600)),
        quotes_per_work=int(rng.integers(1, 4)),
        num_edits=int(rng.integers(0, 3)),
        vocab=vocab,
    )
    eng = SearchEngine(index, cfg, interpret=True)
    rows, _ = eng.search_works(works)
    oracle_rows, _ = search_works_oracle(works, index, cfg)
    assert sorted(r.to_csv_row() for r in rows) == sorted(
        r.to_csv_row() for r in oracle_rows
    ), f"seed {seed} diverged"


def test_repeated_word_lines_parity():
    """Lines of one repeated word drive |score| toward its n^2 bound
    (embedding entries stack to +-n): the packed top-k selection and
    packed dedup sort must stay exact in this regime."""
    rng = np.random.default_rng(55)
    vocab = make_vocab(rng, 200)
    script_text = (
        f"ECHO: {' '.join(['drum'] * 12)}\n"
        f"ALICE: {' '.join(vocab[:9])}\n"
        f"ECHO: {' '.join(['drum'] * 8)} {' '.join(vocab[10:14])}\n"
    )
    lines = parse_script(script_text)
    index = build_script_index(lines, CFG.shingle, CFG.search)
    filler = " ".join(vocab[i] for i in rng.integers(0, len(vocab), 120))
    works = {
        "w0": filler + " " + " ".join(["drum"] * 12) + " " + filler,
        "w1": " ".join(["drum"] * 30),
    }
    eng = SearchEngine(index, CFG, interpret=True)
    rows, _ = eng.search_works(works)
    oracle_rows, _ = search_works_oracle(works, index, CFG)
    assert sorted(r.to_csv_row() for r in rows) == sorted(
        r.to_csv_row() for r in oracle_rows
    )
    assert any(r.work_id == "w0" for r in rows)


def test_long_line_tail_quote_verifies():
    # A 200-token script line: a quote of its TAIL must still verify
    # (round 1 truncated lines to max_line_tokens=64, so tail quotes of
    # long monologues could never match).
    rng = np.random.default_rng(77)
    from fandom_search.utils.synthetic import make_vocab

    vocab = make_vocab(rng, 3000)
    long_words = [vocab[i] for i in rng.integers(0, len(vocab), 200)]
    other = " ".join(vocab[i] for i in rng.integers(0, len(vocab), 9))
    script_text = (
        f"ALICE: {' '.join(long_words)}\n"
        f"BOB: {other}\n"
    )
    lines = parse_script(script_text)
    index = build_script_index(lines, CFG.shingle, CFG.search)
    # 30 tokens: long enough that aligned/min(window, segment) = 60/128
    # clears the 0.35 verify threshold -- the same bar a HEAD quote of
    # this line faces; round 1 truncation made tail quotes score ~0.
    tail_quote = " ".join(long_words[-30:])          # tokens 170..200
    noise = " ".join(vocab[i] for i in rng.integers(0, len(vocab), 120))
    works = {"w_tail": f"{noise} {tail_quote} {noise}"}

    oracle_rows, _ = search_works_oracle(works, index, CFG)
    eng = SearchEngine(index, CFG, interpret=True)
    rows, _ = eng.search_works(works)

    assert any(
        r.line_no == 0 and r.verify_score >= CFG.search.verify_threshold
        for r in rows
    ), f"tail quote of long line not verified: {rows}"
    assert {_row_key(r) for r in rows} == {_row_key(r) for r in oracle_rows}


def test_candidate_budget_overflow_retries(world, caplog):
    # A tiny candidate budget must not drop matches: the engine reruns
    # the batch with a doubled budget until everything fits.
    works, planted, index = world
    big = SearchEngine(index, CFG)
    rows_big, _ = big.search_works(works)

    tiny_cfg = dataclasses.replace(
        CFG, search=dataclasses.replace(CFG.search, max_candidates_per_batch=8)
    )
    tiny = SearchEngine(index, tiny_cfg)
    import logging

    with caplog.at_level(logging.INFO, logger="fandom_search.search.engine"):
        rows_tiny, _ = tiny.search_works(works)
    assert tiny._cand_budget > 8, "budget never grew despite overflow"
    assert {_row_key(r) for r in rows_tiny} == {_row_key(r) for r in rows_big}


def test_recall_curve_over_edit_distance():
    # SURVEY.md section 5: planted quotes "mutated at controlled edit
    # distance ... recall must be 1.0 above the verification threshold,
    # ~0 below".  10-word lines with e substitutions score roughly
    # (10-e)/10 after alignment, so e <= 4 clears verify_threshold=0.35
    # comfortably; pure noise must produce nothing.
    rng = np.random.default_rng(123)
    from fandom_search.utils.synthetic import make_vocab

    vocab = make_vocab(rng, 3000)
    script_lines = [
        " ".join(vocab[i] for i in rng.integers(0, len(vocab), 10))
        for _ in range(12)
    ]
    script_text = "\n".join(f"ALICE: {t}" for t in script_lines)
    lines = parse_script(script_text)
    index = build_script_index(lines, CFG.shingle, CFG.search)
    eng = SearchEngine(index, CFG, interpret=True)

    for edits in (0, 1, 2, 3):
        works, planted = make_corpus_with_quotes(
            rng, script_lines, num_works=6, words_per_work=200,
            quotes_per_work=1, num_edits=edits, vocab=vocab,
        )
        rows, _ = eng.search_works(works)
        found = {(r.work_id, r.line_no) for r in rows}
        want = {(p.work_id, p.line_no) for p in planted}
        missed = want - found
        assert not missed, f"edits={edits}: missed {missed}"

    # below the threshold: pure noise from a disjoint vocab
    noise_vocab = make_vocab(np.random.default_rng(777), 2000)
    noise_works = {
        f"n{i}": " ".join(
            noise_vocab[j] for j in rng.integers(0, len(noise_vocab), 300)
        )
        for i in range(6)
    }
    rows, _ = eng.search_works(noise_works)
    assert rows == [], f"noise produced {len(rows)} spurious rows"


def test_precompile_seen_and_warm_buckets(world):
    """precompile_seen() re-invokes every fused variant seen so far on
    a synthetic no-match stream (budget growth mid-pass leaves early
    buckets compiled at stale budgets, which the next pass would
    recompile on its timed path).  It must not change results or grow
    the budgets; warm_buckets() pre-compiles the smallest and full-cap
    buckets before any search."""
    works, planted, index = world
    eng = SearchEngine(index, CFG, interpret=True)
    rows1, _ = eng.search_works(works)
    assert eng._seen_variants  # the pass recorded its fused variants
    cand0, ver0 = eng._cand_budget, eng._verify_budget
    n = eng.precompile_seen()
    assert n == len(eng._seen_variants) >= 1
    # synthetic streams must not bump the sticky budgets
    assert (eng._cand_budget, eng._verify_budget) == (cand0, ver0)
    rows2, _ = eng.search_works(works)
    assert {_row_key(r) for r in rows1} == {_row_key(r) for r in rows2}

    # small batch cap so warm_buckets' full-cap compile stays fast in
    # interpret mode (the real cap is a 2^20-token stream)
    cfg_small = dataclasses.replace(
        CFG, search=dataclasses.replace(CFG.search, batch_queries=1 << 14)
    )
    eng2 = SearchEngine(index, cfg_small, interpret=True)
    assert eng2.warm_buckets() >= 1
    rows3, _ = eng2.search_works(works)
    assert {_row_key(r) for r in rows1} == {_row_key(r) for r in rows3}

    # with a prefilter attached the engine never dispatches the fused
    # path — warming fused variants would burn the compile minutes
    # --warm exists to save, so it must no-op
    from fandom_search.ops.bucketed import attach_bucketed_prefilter

    eng3 = SearchEngine(index, cfg_small, interpret=True)
    attach_bucketed_prefilter(eng3, CFG.bucketed)
    assert eng3.warm_buckets() == 0
    assert not eng3._seen_variants


def test_engine_kernel_rows_identical_to_plain(world):
    """The kernels (interpret mode) and the plain path give IDENTICAL
    MatchRows, verify scores included: both are exact."""
    works, planted, index = world
    rows_k, _ = SearchEngine(index, CFG, interpret=True).search_works(works)
    rows_p, _ = SearchEngine(index, CFG).search_works(works)
    assert [r.to_csv_row() for r in rows_k] == [r.to_csv_row() for r in rows_p]
    assert rows_k
