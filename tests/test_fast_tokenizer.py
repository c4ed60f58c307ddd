"""Native C++ tokenizer must match the Python reference byte-for-byte."""

import numpy as np
import pytest

from fandom_search.data.fast_tokenizer import (
    fast_tokenize,
    native_available,
    tokenize_many,
)
from fandom_search.data.tokenizer import tokenize

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native library unavailable"
)


def _assert_equal(text):
    a = tokenize(text)
    b = fast_tokenize(text)
    assert a.tokens == b.tokens, text
    assert np.array_equal(a.offsets, b.offsets), text
    assert np.array_equal(a.hashes, b.hashes), text


def test_simple():
    _assert_equal("The QUICK brown-fox, jumps! don't stop o'clock 123abc")


def test_apostrophe_edges():
    for t in ["'hello'", "don''t", "a'b'c", "'", "''", "x'", "'x", "it's"]:
        _assert_equal(t)


def test_unicode():
    for t in [
        "café naïve résumé",        # non-ASCII letters are separators
        "İstanbul is big",           # length-changing lowercase
        "Kelvin sign",          # KELVIN SIGN lowercases to ASCII k
        "日本語 text here",
        "emoji 😀 mixed 𝔘𝔫𝔦 text",
        "Ａｂｃ fullwidth",
    ]:
        _assert_equal(t)


def test_empty_and_symbols():
    for t in ["", "   ", "!!! --- ???", "\n\t\r"]:
        _assert_equal(t)


def test_fuzz_ascii(rng):
    chars = list("abc XYZ 012,.!?'\"-\n\t")
    for _ in range(200):
        n = int(rng.integers(0, 200))
        t = "".join(chars[i] for i in rng.integers(0, len(chars), n))
        _assert_equal(t)


def test_fuzz_unicode(rng):
    chars = list("abz AZ09'é漢Kİ😀 .")
    for _ in range(100):
        n = int(rng.integers(0, 100))
        t = "".join(chars[i] for i in rng.integers(0, len(chars), n))
        _assert_equal(t)


def test_tokenize_many():
    texts = {f"w{i}": f"hello world number {i} don't" for i in range(20)}
    out = tokenize_many(texts)
    assert set(out) == set(texts)
    for k, v in texts.items():
        ref = tokenize(v)
        assert out[k].tokens == ref.tokens
        assert np.array_equal(out[k].hashes, ref.hashes)


def test_lone_surrogate_falls_back():
    # surrogateescape-decoded bytes produce lone surrogates that cannot
    # encode to utf-8; the native path must fall back, not crash
    s = b"hello \xff world".decode("utf-8", errors="surrogateescape")
    out = fast_tokenize(s)
    ref = tokenize(s)
    assert out.tokens == ref.tokens
    assert (out.hashes == ref.hashes).all()


def test_fuzz_unicode_codepoint_classes(rng):
    """Randomized parity over adversarial codepoint classes: astral
    plane, length-changing lowercase (U+0130, U+212A, U+1E9E),
    combining marks, zero-width/control chars, CJK, fullwidth forms
    (round-1 review item #9)."""
    classes = [
        list("abcz09'"),                                   # token chars
        list(" .,!-\n\t\r\"(){}"),                         # separators
        list("éñüÉÑÜßàø"),                                  # latin-1 letters
        ["İ", "K", "ẞ", "ı", "I", "İ"],  # casing edges
        list("😀🎉🚀💯") + ["\U0001d518", "\U0001d4d0", "\U00010400"],  # astral
        list("日本語漢字한국어"),                             # CJK
        ["́", "̈", "ำ"],                     # combining marks
        ["​", "﻿", "­", "\x00", "\x1b"],     # invisible/ctrl
        list("ＡｂｃＺ０９"),                                 # fullwidth
    ]
    for _ in range(300):
        n = int(rng.integers(0, 80))
        cls_ix = rng.integers(0, len(classes), n)
        t = "".join(
            classes[c][int(rng.integers(0, len(classes[c])))] for c in cls_ix
        )
        _assert_equal(t)


def test_fuzz_malformed_utf8_surrogateescape(rng):
    """Random byte soup decoded with surrogateescape (how a scraper
    reads damaged files) must tokenize identically on both paths —
    the native path falls back on unencodable surrogates."""
    for _ in range(100):
        n = int(rng.integers(1, 120))
        raw = bytes(rng.integers(0, 256, n, dtype=np.uint8).tolist())
        t = raw.decode("utf-8", errors="surrogateescape")
        _assert_equal(t)
