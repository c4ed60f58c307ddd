import numpy as np
import pytest

from fandom_search.config import SearchConfig
from fandom_search.ops.smith_waterman import (
    sw_normalized,
    sw_normalized_jnp,
    sw_normalized_triton,
)
from fandom_search.search.verify_np import sw_normalized_np

CFG = SearchConfig()
LA, LB = 32, 24


def _make_batch(rng, bsz, vocab=50):
    a = rng.integers(1, vocab, size=(bsz, LA)).astype(np.uint32)
    b = rng.integers(1, vocab, size=(bsz, LB)).astype(np.uint32)
    len_a = rng.integers(1, LA + 1, size=bsz).astype(np.int32)
    len_b = rng.integers(1, LB + 1, size=bsz).astype(np.int32)
    # plant exact containment in some rows
    for i in range(0, bsz, 4):
        lb = int(len_b[i])
        if int(len_a[i]) >= lb:
            a[i, : lb] = b[i, :lb]
    return a, b, len_a, len_b


def _np_scores(a, b, len_a, len_b):
    return np.array(
        [
            sw_normalized_np(a[i, : len_a[i]], b[i, : len_b[i]], CFG)
            for i in range(a.shape[0])
        ],
        dtype=np.float32,
    )


def test_jnp_matches_numpy(rng):
    a, b, len_a, len_b = _make_batch(rng, 16)
    got = np.asarray(sw_normalized_jnp(a, b, len_a, len_b, CFG))
    want = _np_scores(a, b, len_a, len_b)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_pallas_matches_numpy(rng):
    a, b, len_a, len_b = _make_batch(rng, 64)
    got = np.asarray(
        sw_normalized_triton(a, b, len_a, len_b, CFG, tile_b=32, interpret=True)
    )
    want = _np_scores(a, b, len_a, len_b)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_exact_containment_scores_one(rng):
    a = rng.integers(1, 1000, size=(8, LA)).astype(np.uint32)
    b = np.zeros((8, LB), dtype=np.uint32)
    len_a = np.full(8, LA, dtype=np.int32)
    len_b = np.full(8, 10, dtype=np.int32)
    for i in range(8):
        b[i, :10] = a[i, 5:15]
    got = np.asarray(
        sw_normalized_triton(a, b, len_a, len_b, CFG, tile_b=8, interpret=True)
    )
    np.testing.assert_allclose(got, np.ones(8), atol=1e-6)


def test_disjoint_scores_zero(rng):
    a = np.arange(1, 1 + 8 * LA, dtype=np.uint32).reshape(8, LA)
    b = np.arange(10_000, 10_000 + 8 * LB, dtype=np.uint32).reshape(8, LB)
    len_a = np.full(8, LA, dtype=np.int32)
    len_b = np.full(8, LB, dtype=np.int32)
    got = np.asarray(
        sw_normalized_triton(a, b, len_a, len_b, CFG, tile_b=8, interpret=True)
    )
    np.testing.assert_allclose(got, np.zeros(8), atol=1e-6)


def test_ragged_batch_padding(rng):
    # batch size not a multiple of tile_b
    a, b, len_a, len_b = _make_batch(rng, 37)
    got = np.asarray(
        sw_normalized_triton(a, b, len_a, len_b, CFG, tile_b=16, interpret=True)
    )
    assert got.shape == (37,)
    want = _np_scores(a, b, len_a, len_b)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_empty_batch():
    out = sw_normalized_triton(
        np.zeros((0, LA), np.uint32),
        np.zeros((0, LB), np.uint32),
        np.zeros((0,), np.int32),
        np.zeros((0,), np.int32),
        CFG,
        interpret=True,
    )
    assert out.shape == (0,)


# ---- kernel vs the plain path, exact ----------------------------------------

W = 64  # the engine's window and line-segment width


def _assert_kernel_equals_plain(a, b, len_a, len_b, cfg=CFG, tile_b=16):
    got = np.asarray(sw_normalized_triton(
        a, b, len_a, len_b, cfg, tile_b=tile_b, interpret=True,
    ))
    want = np.asarray(sw_normalized_jnp(a, b, len_a, len_b, cfg))
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize(
    "la,lb", [(0, 0), (0, 5), (5, 0), (1, 1), (1, 64), (64, 1), (64, 64),
              (17, 33)]
)
def test_kernel_edge_lengths(rng, la, lb):
    """Lengths 0, 1 and 64 on either side, exact against the plain
    path (a zero length scores 0; the denominator floors at 1)."""
    a = rng.integers(1, 4, size=(16, W)).astype(np.uint32)
    b = rng.integers(1, 4, size=(16, W)).astype(np.uint32)
    got = _assert_kernel_equals_plain(
        a, b, np.full(16, la, np.int32), np.full(16, lb, np.int32)
    )
    if la == 0 or lb == 0:
        assert (got == 0).all()


def test_kernel_all_padding_blocks(rng):
    """An engine-like length-sorted batch whose trailing blocks hold only
    padding pairs (zero lengths): those score exactly 0."""
    n = 80
    a = rng.integers(1, 6, size=(n, W)).astype(np.uint32)
    b = rng.integers(1, 6, size=(n, W)).astype(np.uint32)
    len_a = np.zeros(n, np.int32)
    len_b = np.zeros(n, np.int32)
    len_a[:20] = W
    len_b[:20] = np.sort(rng.integers(1, 30, size=20))[::-1]
    got = _assert_kernel_equals_plain(a, b, len_a, len_b)
    assert (got[20:] == 0).all() and got[:20].max() > 0


@pytest.mark.parametrize("vocab", [2, 5, 1000])
def test_kernel_random_exact(rng, vocab):
    """Random pairs at every density of matches, exact."""
    n = 40
    a = rng.integers(0, vocab, size=(n, W)).astype(np.uint32)
    b = rng.integers(0, vocab, size=(n, W)).astype(np.uint32)
    len_a = rng.integers(0, W + 1, size=n).astype(np.int32)
    len_b = rng.integers(0, W + 1, size=n).astype(np.int32)
    _assert_kernel_equals_plain(a, b, len_a, len_b)


@pytest.mark.parametrize(
    "match,mismatch,gap", [(2.0, -1.0, -1.0), (1.0, -1.0, -2.0),
                           (3.0, -2.0, -1.0)]
)
def test_kernel_scoring_params(rng, match, mismatch, gap):
    cfg = SearchConfig(sw_match=match, sw_mismatch=mismatch, sw_gap=gap)
    a, b, len_a, len_b = _make_batch(rng, 24, vocab=4)
    _assert_kernel_equals_plain(a, b, len_a, len_b, cfg=cfg, tile_b=8)


def test_dispatch_follows_kernels_flag(rng):
    a, b, len_a, len_b = _make_batch(rng, 12)
    plain = np.asarray(sw_normalized(a, b, len_a, len_b, CFG, kernels=False))
    kern = np.asarray(sw_normalized(
        a, b, len_a, len_b, CFG, kernels=True, interpret=True,
    ))
    np.testing.assert_array_equal(plain, kern)
    np.testing.assert_allclose(plain, _np_scores(a, b, len_a, len_b), atol=1e-6)
