"""Synthetic-corpus generator properties (utils/synthetic.py).

The Zipf-skew option (zipf_a) feeds the flagship-scale bucketed e2e
parity stage in bench.py: text with an English-like heavy head (hot
"stopword" pairs) is what makes the hybrid prefilter's reroute
machinery do real work, so the generator's skew must be real and
deterministic.
"""

import numpy as np

from fandom_search.data.script_parser import parse_script
from fandom_search.utils.synthetic import (
    make_corpus_with_quotes,
    make_script,
    make_vocab,
    random_text,
)


def test_make_script_format_and_determinism():
    rng = np.random.default_rng(3)
    vocab = make_vocab(rng, 200)
    text = make_script(np.random.default_rng(7), vocab, num_lines=50,
                       words_per_line=(4, 14))
    lines = text.split("\n")
    assert len(lines) == 50
    for ln in lines:
        sp, _, body = ln.partition(": ")
        assert sp in ("ALICE", "BOB", "CAROL")
        assert 4 <= len(body.split()) < 14
    # deterministic per seed
    again = make_script(np.random.default_rng(7), vocab, num_lines=50,
                        words_per_line=(4, 14))
    assert again == text
    # parses into attributed lines
    parsed = parse_script(text)
    assert len(parsed) == 50


def test_zipf_skew_is_real():
    rng = np.random.default_rng(11)
    vocab = make_vocab(rng, 500)
    flat = random_text(np.random.default_rng(1), vocab, 20000).split()
    skew = random_text(np.random.default_rng(1), vocab, 20000,
                       zipf_a=1.05).split()
    top_flat = max(np.unique(flat, return_counts=True)[1]) / len(flat)
    top_skew = max(np.unique(skew, return_counts=True)[1]) / len(skew)
    # uniform: ~1/500 +- noise; zipf head must be several x that
    assert top_flat < 0.01
    assert top_skew > 3 * top_flat
    # skewed text still draws only vocab words
    assert set(skew) <= set(vocab)


def test_corpus_with_quotes_zipf_plants_verbatim():
    rng = np.random.default_rng(5)
    vocab = make_vocab(rng, 300)
    script = ["alpha beta gamma delta epsilon zeta eta theta"]
    works, planted = make_corpus_with_quotes(
        rng, script, num_works=4, words_per_work=60, quotes_per_work=2,
        vocab=vocab, zipf_a=1.05,
    )
    assert len(works) == 4 and len(planted) == 8
    for p in planted:
        words = works[p.work_id].split()
        quote = script[p.line_no].split()
        # the quote text must appear somewhere (offsets shift as later
        # inserts land before earlier ones)
        joined = " ".join(words)
        assert " ".join(quote) in joined
