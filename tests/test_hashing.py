import numpy as np

from fandom_search.data.hashing import (
    derive_sign_mults,
    fmix32,
    hash_word,
    hash_words,
)


def test_hash_word_deterministic():
    assert hash_word("hello") == hash_word("hello")
    assert 0 <= hash_word("hello") < 2**32


def test_hash_word_distinct():
    words = ["the", "quick", "brown", "fox", "The", "the ", "thé"]
    # "The" never reaches hashing (tokenizer lowercases) but hash must
    # still distinguish raw strings.
    hashes = [hash_word(w) for w in words]
    assert len(set(hashes)) == len(words)


def test_hash_words_matches_scalar():
    ws = ["alpha", "beta", "gamma"]
    vec = hash_words(ws)
    assert vec.dtype == np.uint32
    assert [int(v) for v in vec] == [hash_word(w) for w in ws]


def test_fmix32_known_zero_input():
    # fmix32(0) == 0 is a murmur3 finalizer property.
    assert int(fmix32(np.array([0], dtype=np.uint32))[0]) == 0


def test_fmix32_avalanche():
    x = np.arange(1, 10_000, dtype=np.uint32)
    y = fmix32(x)
    # Output bits should be ~uniform: each of the 32 bits set ~half the time.
    bits = ((y[:, None] >> np.arange(32, dtype=np.uint32)) & 1).mean(axis=0)
    assert np.all(np.abs(bits - 0.5) < 0.05)


def test_derive_sign_mults_shape_and_determinism():
    s1 = derive_sign_mults(123, 6, 128)
    s2 = derive_sign_mults(123, 6, 128)
    s3 = derive_sign_mults(124, 6, 128)
    assert s1.shape == (6, 128) and s1.dtype == np.uint32
    assert np.array_equal(s1, s2)
    assert not np.array_equal(s1, s3)
    assert np.all(s1 % 2 == 1)  # odd -> multiply mod 2^32 is a bijection
    assert len(np.unique(s1)) == 6 * 128  # all constants distinct
