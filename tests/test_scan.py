"""The prefix scans the candidate path relies on, against NumPy: the
cumsum compaction (``nonzero_compact``), the segment recovery of the
bucketed stream (``_seg_stream``) and the cumsum/cummax segment rank
(``rank_in_segments``).  Exact integer equality, ragged sizes.

No reference analogue (SURVEY.md section 3 — infrastructure for the
sub-linear candidate path).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from fandom_search.ops.bucketed import _seg_stream, rank_in_segments
from fandom_search.search.engine import nonzero_compact

SIZES = [1, 7, 128, 129, 1 << 16, (1 << 16) + 1, 2 * (1 << 16) + 12345]


def _np_rank(keep, first):
    out = np.zeros(len(keep), np.int64)
    seen = 0
    for i in range(len(keep)):
        if first[i]:
            seen = 0
        out[i] = seen
        seen += int(keep[i])
    return out


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("op", ["add", "max"])
def test_scan_parity_interpret(rng, n, op):
    if op == "add":
        # cumsum compaction: ascending indices of set slots, -1 padded
        mask = rng.random(n) < 0.3
        size = max(1, int(mask.sum()) + 3)
        got = np.asarray(nonzero_compact(jnp.asarray(mask), size))
        want = np.full(size, -1)
        nz = np.flatnonzero(mask)
        want[: len(nz)] = nz
        np.testing.assert_array_equal(got, want)
    else:
        # cummax segment-start propagation inside rank_in_segments
        keep = rng.random(n) < 0.7
        first = rng.random(n) < 0.05
        first[0] = True
        got = np.asarray(rank_in_segments(jnp.asarray(keep), jnp.asarray(first)))
        np.testing.assert_array_equal(got, _np_rank(keep, first))


def test_scan_cpu_fallback_matches(rng):
    # a budget smaller than the set count keeps the FIRST slots only
    mask = rng.random(100_000) < 0.5
    got = np.asarray(nonzero_compact(jnp.asarray(mask), 1000))
    np.testing.assert_array_equal(got, np.flatnonzero(mask)[:1000])


def test_scan_rejects_bad_op():
    # an all-False mask compacts to all -1
    got = np.asarray(nonzero_compact(jnp.zeros((64,), bool), 8))
    np.testing.assert_array_equal(got, np.full(8, -1))


def test_scan_empty():
    ln = jnp.asarray([0, 0, 0], jnp.int32)
    seg, epos, valid, count = _seg_stream(ln, jnp.zeros(3, jnp.int32), 4)
    assert int(count) == 0 and not np.asarray(valid).any()


def test_scan_negative_values_max(rng):
    # segment recovery: every valid slot maps to its segment and entry
    ln = rng.integers(0, 5, size=40).astype(np.int32)
    start = rng.integers(0, 100, size=40).astype(np.int32)
    budget = int(ln.sum()) + 5
    seg, epos, valid, count = (
        np.asarray(x) for x in _seg_stream(
            jnp.asarray(ln), jnp.asarray(start), budget
        )
    )
    assert int(count) == ln.sum()
    want_seg = np.repeat(np.arange(40), ln)
    want_pos = np.concatenate(
        [start[i] + np.arange(ln[i]) for i in range(40)]
    )
    np.testing.assert_array_equal(valid, np.arange(budget) < ln.sum())
    np.testing.assert_array_equal(seg[: ln.sum()], want_seg)
    np.testing.assert_array_equal(epos[: ln.sum()], want_pos)
