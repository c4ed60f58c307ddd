import numpy as np

from fandom_search.data.tokenizer import tokenize


def test_basic_tokens():
    t = tokenize("The QUICK brown-fox, jumps!  don't stop")
    assert t.tokens == ["the", "quick", "brown", "fox", "jumps", "don't", "stop"]


def test_offsets_point_into_original():
    text = "Hello, World! It's me."
    t = tokenize(text)
    for tok, (a, b) in zip(t.tokens, t.offsets):
        assert text[a:b].lower() == tok


def test_span_text_roundtrip():
    text = "one two three four five"
    t = tokenize(text)
    assert t.span_text(1, 4) == "two three four"
    assert t.span_text(0, 5) == text
    assert t.span_text(2, 2) == ""


def test_empty_and_symbol_only():
    t = tokenize("!!! ---")
    assert t.tokens == []
    assert t.offsets.shape == (0, 2)
    assert t.hashes.shape == (0,)


def test_unicode_length_change_does_not_desync():
    # 'İ' lowercases to 2 chars via str.lower(); offsets must stay valid.
    text = "İstanbul is big"
    t = tokenize(text)
    for tok, (a, b) in zip(t.tokens, t.offsets):
        assert len(text[a:b]) == b - a


def test_hashes_deterministic():
    t1 = tokenize("alpha beta gamma")
    t2 = tokenize("alpha beta gamma")
    assert np.array_equal(t1.hashes, t2.hashes)
