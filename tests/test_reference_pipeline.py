"""Reference-style CPU pipeline (BallTree + Levenshtein) parity tests."""

import numpy as np

from fandom_search.config import PipelineConfig
from fandom_search.data.script_parser import parse_script
from fandom_search.search.reference_pipeline import ReferenceSearch
from fandom_search.utils.synthetic import (
    make_corpus_with_quotes,
    make_script,
    make_vocab,
)

CFG = PipelineConfig()


def test_reference_pipeline_finds_planted_quotes(rng):
    vocab = make_vocab(rng, 1200)
    lines = parse_script(make_script(rng, vocab, num_lines=20,
                                     words_per_line=(7, 12)))
    works, planted = make_corpus_with_quotes(
        rng, [ln.text for ln in lines], num_works=8, words_per_work=250,
        quotes_per_work=1, vocab=vocab,
    )
    ref = ReferenceSearch(list(lines), CFG)
    rows, stats = ref.search_works(works)
    assert stats.num_query_shingles > 0
    found = {(r.work_id, r.line_no) for r in rows}
    want = {(p.work_id, p.line_no) for p in planted}
    missed = want - found
    assert not missed, f"reference pipeline missed planted quotes: {missed}"


def test_reference_pipeline_no_false_positives_on_noise(rng):
    vocab = make_vocab(rng, 1200)
    lines = parse_script(make_script(rng, vocab, num_lines=15))
    # Noise from a char-alphabet DISJOINT from make_vocab's ("x"/"y"
    # never appear in its consonant/vowel sets), so the corpus is far
    # from every script line in BOTH of the pipeline's metrics.  A
    # second make_vocab seed is NOT far enough: same alphabet + same
    # word shapes means Levenshtein.ratio between random gibberish
    # pairs sits ~0.45, and the BallTree radius (at the null-distance
    # mean) lets borderline candidates through — a seed reshuffle once
    # produced a ratio-0.50 hit, exactly at the reference's >= 0.5
    # verify gate.  Candidates may still fire here; verification must
    # kill them all, deterministically.
    noise_rng = np.random.default_rng(999)
    noise_vocab = [
        "".join("xy"[b] for b in noise_rng.integers(0, 2, int(ln)))
        for ln in noise_rng.integers(4, 12, 800)
    ]
    noise = " ".join(
        noise_vocab[i] for i in rng.integers(0, len(noise_vocab), 400)
    )
    ref = ReferenceSearch(list(lines), CFG)
    rows, _ = ref.search_works({"noise": noise})
    assert rows == []
