import numpy as np

from fandom_search.config import ShingleConfig
from fandom_search.data.hashing import hash_words
from fandom_search.data.shingler import (
    embed_shingles,
    embed_shingles_np,
    shingle_hashes,
)

CFG = ShingleConfig()


def test_shingle_windows(rng):
    t = rng.integers(0, 2**32, size=10, dtype=np.uint32)
    w = shingle_hashes(t, CFG)
    assert w.shape == (5, 6)
    assert np.array_equal(w[0], t[:6])
    assert np.array_equal(w[4], t[4:10])


def test_shingle_too_short():
    t = np.arange(3, dtype=np.uint32)
    assert shingle_hashes(t, CFG).shape == (0, 6)
    assert embed_shingles_np(t, CFG).shape == (0, CFG.dim)


def test_embed_np_vs_jax_bit_identical(rng):
    t = rng.integers(0, 2**32, size=64, dtype=np.uint32)
    e_np = embed_shingles_np(t, CFG)
    e_jx = np.asarray(embed_shingles(t, CFG))
    assert e_np.dtype == np.int8
    assert e_np.shape == (59, CFG.dim)
    assert np.array_equal(e_np, e_jx)


def test_embed_entries_in_range(rng):
    t = rng.integers(0, 2**32, size=200, dtype=np.uint32)
    e = embed_shingles_np(t, CFG)
    assert e.min() >= -CFG.n and e.max() <= CFG.n


def test_dot_estimates_matching_positions(rng):
    """dot/dim ~= #positions where two shingles share a word."""
    words = [f"w{i}" for i in range(100)]
    h = hash_words(words)
    base = h[:6].copy()
    for m in [6, 5, 3, 0]:
        other = base.copy()
        # replace (6 - m) positions with fresh words
        for p in range(6 - m):
            other[p] = h[50 + p]
        ea = embed_shingles_np(base, CFG)[0].astype(np.int32)
        eb = embed_shingles_np(other, CFG)[0].astype(np.int32)
        est = ea @ eb / CFG.dim
        assert abs(est - m) < 1.6, (m, est)


def test_identical_shingles_exact_score(rng):
    t = rng.integers(0, 2**32, size=6, dtype=np.uint32)
    e = embed_shingles_np(t, CFG)[0].astype(np.int32)
    # self-dot/dim is the mean squared entry ~ n, not exactly n;
    # but two *identical* shingles always produce identical embeddings.
    e2 = embed_shingles_np(t.copy(), CFG)[0]
    assert np.array_equal(e.astype(np.int8), e2)
