import jax.numpy as jnp
import numpy as np
import pytest

import fandom_search.ops.distance_topk as D
from fandom_search.ops.distance_topk import (
    NEG_INF, merge_topk, pad_rows, topk_dot, topk_dot_jnp, topk_dot_triton,
)
from fandom_search.search.oracle import topk_scores_np

K, DIM = 10, 128


def _rand_emb(rng, n, dim=DIM):
    return rng.integers(-6, 7, size=(n, dim)).astype(np.int8)


def _check_against_oracle(vals, idx, q, s):
    """vals must equal oracle vals exactly; idx must be score-consistent."""
    ovals, _ = topk_scores_np(q, s, K, DIM)
    np.testing.assert_allclose(np.asarray(vals), ovals, atol=1e-6)
    full = q.astype(np.int32) @ s.astype(np.int32).T / DIM
    picked = np.take_along_axis(full, np.asarray(idx), axis=1)
    np.testing.assert_allclose(picked, np.asarray(vals), atol=1e-6)


def _assert_exact(vals, idx, q, s, min_keep=-np.inf):
    """Every entry the oracle ranks at or above ``min_keep`` is equal,
    value and index (lowest index on ties); entries below it are
    (NEG_INF, 0) padding, never a fabricated score."""
    ovals, oidx = topk_scores_np(q, s, K, DIM)
    v, i = np.asarray(vals), np.asarray(idx)
    keep = np.isfinite(ovals) & (ovals >= min_keep)
    np.testing.assert_array_equal(v[keep], ovals[keep])
    np.testing.assert_array_equal(i[keep], oidx[keep])
    assert (v[~keep] == NEG_INF).all() and (i[~keep] == 0).all()


def _kernel(q, s, **kw):
    return topk_dot(q, s, k=K, dim=DIM, kernels=True, interpret=True, **kw)


def _plain(q, s, **kw):
    return topk_dot(q, s, k=K, dim=DIM, kernels=False, **kw)


def test_jnp_matches_oracle(rng):
    q, s = _rand_emb(rng, 100), _rand_emb(rng, 300)
    vals, idx = topk_dot_jnp(q, s, k=K, dim=DIM)
    _check_against_oracle(vals, idx, q, s)


def test_pallas_matches_oracle_aligned(rng):
    q, s = _rand_emb(rng, 256), _rand_emb(rng, 512)
    vals, idx = _kernel(q, s)
    _assert_exact(vals, idx, q, s)


def test_pallas_matches_oracle_ragged(rng):
    # Unaligned sizes exercise padding + the ns_valid mask.
    q, s = _rand_emb(rng, 300), _rand_emb(rng, 777)
    vals, idx = _kernel(q, s)
    assert vals.shape == (300, K)
    _assert_exact(vals, idx, q, s)


def test_pallas_multi_s_tile_merge(rng):
    # Many script tiles so the running merge really accumulates.
    q, s = _rand_emb(rng, 64), _rand_emb(rng, 2048 + 100)
    vals, idx = _kernel(q, s)
    _assert_exact(vals, idx, q, s)


@pytest.mark.parametrize("dim2", [256, 512, 2048])
def test_wide_dim_adapts_col_bits_or_falls_back_exact(rng, dim2):
    """Wide embeddings produce |score| past the 17-column-bit packing
    budget: the packed kernel trades column bits for score bits
    (dim=256 -> 16 bits, 512 -> 15); dim=2048 (|score| 73728 > the
    14-bit budget 65535) takes the exact unpacked path.  All must
    return exact results."""
    q = rng.integers(-6, 7, size=(128, dim2)).astype(np.int8)
    s = rng.integers(-6, 7, size=(64, dim2)).astype(np.int8)
    # a strong planted match: dot = 36*dim, past the 17-bit budget
    s[5] = q[0] = np.full(dim2, 6, np.int8)
    for kernels in (True, False):
        vals, idx = topk_dot(
            q, s, k=K, dim=dim2, kernels=kernels, interpret=True,
            max_abs_score=6 * 6 * dim2,
        )
        full = q.astype(np.int32) @ s.astype(np.int32).T / dim2
        want = np.sort(full, axis=1)[:, ::-1][:, :K]
        np.testing.assert_allclose(np.asarray(vals), want, atol=1e-6)
        assert int(np.asarray(idx)[0, 0]) == 5


def test_pallas_duplicate_rows_ties(rng):
    # Duplicate script shingles -> exact score ties; lowest index wins.
    s_half = _rand_emb(rng, 256)
    s = np.concatenate([s_half, s_half], axis=0)
    q = s_half[:64]
    vals, idx = _kernel(q, s)
    _assert_exact(vals, idx, q, s)
    # self-match must be in the top-k of each query (huge self-dot)
    self_scores = (q.astype(np.int32) * q.astype(np.int32)).sum(1) / DIM
    assert np.allclose(np.asarray(vals)[:, 0], self_scores)


def test_empty_inputs():
    q = np.zeros((0, DIM), dtype=np.int8)
    s = np.zeros((5, DIM), dtype=np.int8)
    vals, idx = _kernel(q, s)
    assert vals.shape == (0, K) and idx.shape == (0, K)


def test_oracle_boundary_ties_lowest_index(rng):
    # >k exactly-tied scores at the k-th boundary: the oracle must pick
    # the LOWEST indices, matching the plain path and the kernel
    # (argpartition alone picks an arbitrary tied subset).
    base = rng.integers(-3, 4, size=(5, DIM)).astype(np.int8)
    s = base[rng.integers(0, 5, size=300)]
    q = base[rng.integers(0, 5, size=64)]
    ovals, oidx = topk_scores_np(q, s, K, DIM)
    jvals, jidx = topk_dot_jnp(q, s, k=K, dim=DIM)
    np.testing.assert_allclose(ovals, np.asarray(jvals), atol=1e-6)
    np.testing.assert_array_equal(oidx, np.asarray(jidx))
    pvals, pidx = _kernel(q, s)
    np.testing.assert_array_equal(oidx, np.asarray(pidx))


def test_min_keep_gating_exact_above_threshold(rng):
    # With min_keep set, entries >= min_keep must be exactly the
    # oracle's (sub-threshold entries come back as padding).
    thr = 3.5
    q, s = _rand_emb(rng, 128), _rand_emb(rng, 1500)
    # plant strong matches for some queries so gating has both regimes
    s[100:150] = q[:50]
    vals, idx = _kernel(q, s, min_keep=thr)
    _assert_exact(vals, idx, q, s, min_keep=thr)
    assert (np.asarray(vals) >= thr).sum() >= 50


def test_column_chunking_beyond_pack_range(rng, monkeypatch):
    # Scripts wider than 2^COL_BITS shingles process in column chunks
    # with an exact cross-chunk merge.  Exercise the chunk logic with
    # shrunken constants (8 column bits -> 256-column chunks).
    monkeypatch.setattr(D, "_COL_BITS", 8)  # _col_bits_for reads it live
    q, s = _rand_emb(rng, 64), _rand_emb(rng, 700)  # 3 chunks of <=256
    qp, _ = pad_rows(jnp.asarray(q), 64)
    sp, _ = pad_rows(jnp.asarray(s), 64)
    vals, idx = topk_dot_triton(
        qp, sp, s.shape[0], k=K, dim=DIM, interpret=True,
        tile_q=64, tile_s=64, max_abs_score=100,
    )
    _assert_exact(vals[: q.shape[0]], idx[: q.shape[0]], q, s)


# ---- kernel cases: shapes, ties, the min_keep gate, chunking ---------------


@pytest.mark.parametrize(
    "nq,ns", [(1, 1), (63, 65), (64, 64), (65, 129), (130, 700), (7, 2100)]
)
def test_kernel_ragged_shapes_exact(rng, nq, ns):
    """Ragged NQ and NS (one row, fewer columns than k, a partial last
    tile) pad correctly: padded script rows never enter, padded query
    rows are dropped."""
    q, s = _rand_emb(rng, nq), _rand_emb(rng, ns)
    vals, idx = _kernel(q, s)
    assert vals.shape == (nq, K) and idx.shape == (nq, K)
    _assert_exact(vals, idx, q, s)
    pv, pi = _plain(q, s)
    np.testing.assert_array_equal(np.asarray(vals), np.asarray(pv))
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(pi))


@pytest.mark.parametrize("thr", [1.0 / DIM, 2.0, 3.5, 6.0])
def test_kernel_min_keep_gate(rng, thr):
    """Entries >= min_keep are the oracle's; everything below is padding,
    on both paths alike.  thr=1/DIM is the smallest positive gate
    (padded zero columns must still never enter)."""
    q, s = _rand_emb(rng, 96), _rand_emb(rng, 600)
    s[10:40] = q[:30]
    s[500] = s[10]  # a tied duplicate of a planted row
    vals, idx = _kernel(q, s, min_keep=thr)
    _assert_exact(vals, idx, q, s, min_keep=thr)
    pv, pi = _plain(q, s, min_keep=thr)
    np.testing.assert_array_equal(np.asarray(vals), np.asarray(pv))
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(pi))


@pytest.mark.parametrize("copies", [2, 12])
def test_kernel_ties_across_tiles(rng, copies):
    """One script row repeated in several tiles: every copy ties, and
    the k lowest-index copies win, in ascending index order."""
    s = _rand_emb(rng, 64 * copies)
    row = _rand_emb(rng, 1)[0]
    where = np.arange(copies) * 64 + 3
    s[where] = row
    q = np.stack([row] * 5)
    vals, idx = _kernel(q, s)
    _assert_exact(vals, idx, q, s)
    n = min(copies, K)
    np.testing.assert_array_equal(np.asarray(idx)[:, :n], np.tile(where[:n], (5, 1)))


@pytest.mark.parametrize("col_bits", [7, 8])
@pytest.mark.parametrize("kernels", [True, False])
def test_column_chunks_both_paths(rng, monkeypatch, col_bits, kernels):
    monkeypatch.setattr(D, "_COL_BITS", col_bits)
    q, s = _rand_emb(rng, 70), _rand_emb(rng, 530)
    s[400] = s[3] = q[0]  # a tie that spans two chunks
    vals, idx = topk_dot(
        q, s, k=K, dim=DIM, kernels=kernels, interpret=True,
        max_abs_score=100,
    )
    _assert_exact(vals, idx, q, s)
    assert int(np.asarray(idx)[0, 0]) == 3


# ---- plain path: bounded chunks ---------------------------------------------


@pytest.mark.parametrize("chunk", [8, 16, 64, 256, None])
def test_plain_chunk_sizes_agree(rng, chunk):
    """Every query-chunk size gives the oracle's answer (the last chunk
    is partial for all but the largest)."""
    q, s = _rand_emb(rng, 200), _rand_emb(rng, 333)
    vals, idx = topk_dot_jnp(q, s, k=K, dim=DIM, chunk=chunk)
    _assert_exact(vals, idx, q, s)


@pytest.mark.parametrize("ns", [1, 2048, 16384, 1 << 17])
def test_plain_chunk_scratch_bounded(ns):
    """The plain path's score block is at most 256 MiB, whatever NQ."""
    rows = D._plain_chunk_rows(ns)
    assert 8 <= rows <= 8192 and rows & (rows - 1) == 0
    assert rows * ns * 4 <= (1 << 28) or rows == 8


def test_plain_masks_padded_columns(rng):
    q, s = _rand_emb(rng, 20), _rand_emb(rng, 40)
    s_pad = np.concatenate([s, np.full((24, DIM), 6, np.int8)])
    vals, idx = topk_dot_jnp(q, s_pad, 40, k=K, dim=DIM)
    _assert_exact(vals, idx, q, s)


def test_merge_topk_lowest_index_on_ties():
    vals = jnp.asarray([[1.0, 3.0, 3.0, 2.0, 3.0]])
    idx = jnp.asarray([[9, 7, 2, 1, 5]], jnp.int32)
    v, i = merge_topk(vals, idx, 3)
    np.testing.assert_array_equal(np.asarray(v), [[3.0, 3.0, 3.0]])
    np.testing.assert_array_equal(np.asarray(i), [[2, 5, 7]])
