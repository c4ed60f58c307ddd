"""Reference-verifier parity: the SW word-level verdict must track the
reference's Levenshtein-ratio verdict (SURVEY.md section 3 "Verifier").

The reference verified candidate pairs with python-Levenshtein's ratio
on the matched strings; this build verifies with word-level
Smith-Waterman on token hashes over a context window.  On planted-quote
pairs (positive: window contains an exact or lightly-edited quote of
the line; negative: pure noise) the two verdicts must agree >= 95%.
"""

import numpy as np
import pytest

from fandom_search.config import PipelineConfig
from fandom_search.data.tokenizer import tokenize
from fandom_search.search.verify_np import levenshtein_ratio, sw_normalized_np
from fandom_search.utils.synthetic import make_vocab

CFG = PipelineConfig()

pytest.importorskip("Levenshtein")


def _make_pairs(rng, n_pos=60, n_neg=60):
    vocab = make_vocab(rng, 4000)

    def words(k):
        return [vocab[i] for i in rng.integers(0, len(vocab), k)]

    pairs = []  # (window_text, span_text, line_text, is_quote)
    for _ in range(n_pos):
        line_w = words(int(rng.integers(7, 13)))
        quote_w = list(line_w)
        for _ in range(int(rng.integers(0, 2))):  # 0 or 1 word edits
            quote_w[int(rng.integers(0, len(quote_w)))] = words(1)[0]
        pre, post = words(25), words(25)
        window_w = pre + quote_w + post
        pairs.append(
            (" ".join(window_w), " ".join(quote_w), " ".join(line_w), True)
        )
    for _ in range(n_neg):
        line_w = words(int(rng.integers(7, 13)))
        window_w = words(60)
        span_w = window_w[25 : 25 + len(line_w)]
        pairs.append(
            (" ".join(window_w), " ".join(span_w), " ".join(line_w), False)
        )
    return pairs


def test_sw_verdict_tracks_levenshtein_verdict(rng):
    pairs = _make_pairs(rng)
    agree = 0
    sw_right = 0
    lev_right = 0
    for window_text, span_text, line_text, is_quote in pairs:
        a = tokenize(window_text).hashes
        b = tokenize(line_text).hashes
        sw_verdict = (
            sw_normalized_np(a, b, CFG.search) >= CFG.search.verify_threshold
        )
        # the reference compares the matched span's text to the line text
        lev_verdict = levenshtein_ratio(span_text, line_text) >= 0.8
        agree += sw_verdict == lev_verdict
        sw_right += sw_verdict == is_quote
        lev_right += lev_verdict == is_quote
    n = len(pairs)
    assert sw_right / n >= 0.95, f"SW verdict wrong on {n - sw_right}/{n}"
    assert lev_right / n >= 0.95, f"Lev verdict wrong on {n - lev_right}/{n}"
    assert agree / n >= 0.95, f"verdicts agree only {agree}/{n}"
