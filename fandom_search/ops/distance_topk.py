"""Fused distance-matrix + top-k — the BallTree replacement.

The reference's candidate generation is a BallTree query per fanwork
shingle (SURVEY.md section 4.2 HOT LOOP 1).  Here it is one int8
matrix product of shingle embeddings folded into a per-row top-k:
scores are ``dot(e_q, e_s) / dim`` ~= number of matching shingle
positions (see data/shingler.py).  Two implementations with identical
semantics, including lowest-index tie-breaking:

  * ``topk_dot_jnp``    — plain XLA: ``lax.map`` over fixed-size query
                          chunks, an int8 x int8 -> int32 product and
                          ``lax.top_k``.  Its scratch is one
                          [chunk, NS] score block, whatever NQ is.  The
                          CPU path and the oracle for the kernel.
  * ``topk_dot_triton`` — a Pallas kernel on the Triton route: each
                          program owns a block of query rows, loops over
                          script tiles, scores each tile with ``pl.dot``
                          on the tensor cores and folds it into a
                          running top-k held in registers.  The
                          [NQ, NS] score matrix never exists.

``topk_dot`` chooses between them (ops/backend.py) and pads.

Both rank *packed* candidates: one int32
    packed = score * 2^col_bits + (2^col_bits - 1 - col)
is monotone in (score asc, col desc), so a max picks "highest score,
lowest column wins ties" and every (score, col) is unique — the
selection never depends on how a top-k breaks ties.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

NEG_INF = float(np.finfo(np.float32).min)

# global_col < 2^col_bits is enforced by column chunking; the score
# budget is |score| <= 2^(30-col_bits) - 1: above that the positive side
# overflows int32 and the negative side collides with the sentinel.
# col_bits ADAPTS to the caller's max_abs_score: the default 17 bits
# covers the n=6/dim=128 spec (|score| <= n^2*dim = 4608 <= 8191); wider
# embeddings trade column bits for score bits (dim=256 -> 16 bits, 512
# -> 15, 1024 -> 14).  Beyond 14 bits' budget (65535) the wrapper runs
# an exact unpacked top-k instead.
_COL_BITS = 17
_MIN_COL_BITS = 14
_PACK_SENTINEL = -(1 << 30)  # below any real packed value
_PACK_MAX_SCORE = (1 << (30 - _MIN_COL_BITS)) - 1
# a kernel slot past k: never the running minimum, never replaced
_LOCKED = 2**31 - 1

# Kernel block shape: BQ query rows per program, BS script rows per
# tile.  Powers of two (Triton), BS >= 16 (tensor-core operand).
TILE_Q = 128
TILE_S = 128
NUM_WARPS = 8


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


def _next_pow2(n: int) -> int:
    v = 1
    while v < n:
        v *= 2
    return v


def _col_bits_for(max_abs_score: int) -> int:
    """Narrowest-score column field fitting the caller's score bound
    (prefer MORE column bits: fewer chunks at huge NS)."""
    cb = _COL_BITS
    while cb > _MIN_COL_BITS and max_abs_score > (1 << (30 - cb)) - 1:
        cb -= 1
    return cb


def _min_keep_int(min_keep: float, dim: int) -> int:
    """``score >= min_keep`` in raw-dot units (scores are exact
    integers, so ceil keeps the comparison exact); -inf maps to the
    sentinel, which every packed value clears."""
    if np.isfinite(min_keep):
        return max(int(np.ceil(min_keep * dim)), _PACK_SENTINEL)
    return _PACK_SENTINEL


def _unpack(packed, col_bits: int, dim: int, col0=0):
    """packed int32 -> (vals f32 dot/dim, idx int32); sentinels (and
    anything below) come back as (NEG_INF, 0)."""
    cmask = (1 << col_bits) - 1
    empty = packed <= jnp.int32(_PACK_SENTINEL)
    score = jax.lax.shift_right_arithmetic(packed, jnp.int32(col_bits))
    vals = jnp.where(empty, NEG_INF, score.astype(jnp.float32) / dim)
    idx = jnp.where(empty, 0, col0 + jnp.int32(cmask) - (packed & cmask))
    return vals, idx.astype(jnp.int32)


def merge_topk(vals, idx, k: int):
    """Exact top-k of candidate lists along the last axis: highest value
    first, lowest index on ties — a two-key sort, so the result does
    not depend on how a top-k primitive breaks ties."""
    neg, idx_s = jax.lax.sort((-vals, idx), dimension=-1, num_keys=2)
    return -neg[..., :k], idx_s[..., :k]


# ---------------------------------------------------------------------------
# plain XLA path (CPU path and oracle)
# ---------------------------------------------------------------------------


def _plain_chunk_rows(ns: int) -> int:
    """Query rows per plain-path chunk: one [rows, NS] int32 score block
    of at most 256 MiB, a power of two in [8, 8192]."""
    rows = 8
    while rows < 8192 and 2 * rows * max(ns, 1) * 4 <= (1 << 28):
        rows *= 2
    return rows


def _plain_block(q, s, ns_valid, *, k, dim, col_bits):
    scores = jax.lax.dot_general(
        q, s,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    col = jax.lax.broadcasted_iota(jnp.int32, scores.shape, 1)
    if col_bits is None:
        # unpacked: scores too wide to pack; masked f32 + two-key merge
        v = jnp.where(col < ns_valid, scores.astype(jnp.float32), NEG_INF)
        vals, idx = merge_topk(v, col, k)
        return (
            jnp.where(vals > NEG_INF, vals / dim, NEG_INF),
            jnp.where(vals > NEG_INF, idx, 0),
        )
    cmask = (1 << col_bits) - 1
    packed = jnp.where(
        col < ns_valid,
        scores * jnp.int32(1 << col_bits) + (jnp.int32(cmask) - col),
        jnp.int32(_PACK_SENTINEL),
    )
    top, _ = jax.lax.top_k(packed, k)
    return _unpack(top, col_bits, dim)


@functools.partial(
    jax.jit, static_argnames=("k", "dim", "chunk", "max_abs_score")
)
def topk_dot_jnp(
    q_emb: jax.Array,   # int8 [NQ, D]
    s_emb: jax.Array,   # int8 [NS, D] (rows >= ns_valid are padding)
    ns_valid=None,      # int32 scalar; None = all NS rows are valid
    *,
    k: int,
    dim: int,
    chunk: int | None = None,
    max_abs_score: int = 4608,
) -> Tuple[jax.Array, jax.Array]:
    """Exact top-k of dot/dim with bounded scratch.

    Rows run in chunks of ``chunk`` queries (``lax.map``), so the peak
    scratch is one [chunk, NS] int32 block however large NQ is.  The
    product is int8 x int8 -> int32, exact.  Columns at or past
    ``ns_valid`` never enter; rows with fewer than k valid columns pad
    with (NEG_INF, 0).
    """
    nq, d = q_emb.shape
    ns = s_emb.shape[0]
    if ns_valid is None:
        ns_valid = ns
    if nq == 0 or ns == 0:
        return (
            jnp.full((nq, k), NEG_INF, jnp.float32),
            jnp.zeros((nq, k), jnp.int32),
        )
    q_emb = q_emb.astype(jnp.int8)
    s_emb = s_emb.astype(jnp.int8)
    packable = max_abs_score <= _PACK_MAX_SCORE
    col_bits = _col_bits_for(max_abs_score) if packable else None
    if col_bits is not None and ns > (1 << col_bits):
        return _column_chunks(
            lambda s_c, nsv_c: topk_dot_jnp(
                q_emb, s_c, nsv_c, k=k, dim=dim, chunk=chunk,
                max_abs_score=max_abs_score,
            ),
            s_emb, ns_valid, k, 1 << col_bits,
        )
    if k > ns:
        # fewer columns than k: pad the script side with masked rows
        s_emb = jnp.pad(s_emb, ((0, k - ns), (0, 0)))
    block = functools.partial(
        _plain_block, k=k, dim=dim, col_bits=col_bits,
    )
    rows = chunk or _plain_chunk_rows(s_emb.shape[0])
    if nq <= rows:
        return block(q_emb, s_emb, ns_valid)
    q_p = jnp.pad(q_emb, ((0, (-nq) % rows), (0, 0)))
    vals, idx = jax.lax.map(
        lambda qc: block(qc, s_emb, ns_valid),
        q_p.reshape(-1, rows, d),
    )
    return vals.reshape(-1, k)[:nq], idx.reshape(-1, k)[:nq]


def _column_chunks(fn, s_emb, ns_valid, k: int, max_cols: int):
    """Run ``fn(s_chunk, ns_valid_chunk)`` per 2^col_bits-column chunk
    and merge the small per-chunk tables exactly (global indices)."""
    ns = s_emb.shape[0]
    vs, ids = [], []
    for c0 in range(0, ns, max_cols):
        s_c = s_emb[c0 : c0 + max_cols]
        nsv_c = jnp.clip(
            jnp.asarray(ns_valid, jnp.int32) - c0, 0, s_c.shape[0]
        )
        v, i = fn(s_c, nsv_c)
        vs.append(v)
        ids.append(jnp.where(v > NEG_INF, i + c0, 0))
    return merge_topk(
        jnp.concatenate(vs, axis=1), jnp.concatenate(ids, axis=1), k
    )


# ---------------------------------------------------------------------------
# Triton-route Pallas kernel
# ---------------------------------------------------------------------------


def _topk_kernel(
    nsv_ref,    # [] int32 — valid script rows
    q_ref,      # [BQ, D] int8 — this program's query rows
    s_ref,      # [NS_pad, D] int8 — the whole script matrix
    out_ref,    # [BQ, KP] int32 out — packed, descending
    *,
    k: int,
    tile_s: int,
    n_tiles: int,
    min_keep: int,
    col_bits: int,
):
    """Running top-k over script tiles for one block of query rows.

    The running set is ``KP`` (next pow2 >= k) int32 slots per row:
    slots < k hold packed candidates (sentinel when empty), slots >= k
    are locked at INT32_MAX so they are never the row minimum.  The set
    is unordered; its minimum is the current k-th best, and an entrant
    replaces the (lowest-numbered) minimum slot.  A tile merges only if
    some row's best raw score clears both ``min_keep`` and that row's
    k-th; a merging tile extracts entrants in descending order until
    no row has one (at most k rounds).  Integer flags stand in for
    booleans throughout: this route has no boolean reduction.
    """
    cmask = (1 << col_bits) - 1
    scale = jnp.int32(1 << col_bits)
    sent = jnp.int32(_PACK_SENTINEL)
    q = q_ref[...]
    bq = q.shape[0]
    kp = out_ref.shape[1]
    nsv = nsv_ref[...]
    slot = jax.lax.broadcasted_iota(jnp.int32, (bq, kp), 1)
    col = jax.lax.broadcasted_iota(jnp.int32, (bq, tile_s), 1)
    run0 = jnp.where(slot < k, sent, jnp.int32(_LOCKED))

    def merge(t, sc, run):
        gcol = t * tile_s + col
        p = jnp.where(gcol < nsv, sc * scale + (jnp.int32(cmask) - gcol), sent)

        def step(p, run):
            m = jnp.max(p, axis=1)                              # [BQ]
            kth = jnp.min(run, axis=1)                          # [BQ]
            enter = jnp.logical_and(
                m > kth,
                jax.lax.shift_right_arithmetic(m, jnp.int32(col_bits))
                >= jnp.int32(min_keep),
            )
            first_min = jnp.min(
                jnp.where(run == kth[:, None], slot, jnp.int32(kp)), axis=1
            )
            put = jnp.logical_and(slot == first_min[:, None], enter[:, None])
            run = jnp.where(put, m[:, None], run)
            p = jnp.where(p == m[:, None], sent, p)
            return jnp.max(enter.astype(jnp.int32)), p, run

        # k extraction rounds, unrolled; a round runs only while some
        # row still had an entrant in the previous one.  (Written as
        # conds, not a while loop: a while loop carrying the [BQ, BS]
        # tile crashes the Triton compile.)
        go = jnp.int32(1)
        for _ in range(k):
            def do(args):
                _, p, run = args
                return step(p, run)

            def skip(args):
                go, p, run = args
                return go * 0, p, run   # a traced zero: literals break cond

            go, p, run = jax.lax.cond(go > 0, do, skip, (go, p, run))
        return run

    def tile(t, run):
        s = s_ref[pl.ds(pl.multiple_of(t * tile_s, tile_s), tile_s), :]
        sc = pl.dot(q, s, trans_b=True)                         # [BQ, BS] i32
        rmax = jnp.max(sc, axis=1)
        kth = jnp.min(run, axis=1)
        # conservative: the packed value of rmax at the best column
        fire = jnp.logical_and(
            rmax >= jnp.int32(min_keep), rmax * scale + jnp.int32(cmask) > kth
        )
        return jax.lax.cond(
            jnp.max(fire.astype(jnp.int32)) > 0,
            lambda r: merge(t, sc, r), lambda r: r, run,
        )

    run = jax.lax.fori_loop(0, n_tiles, tile, run0)

    # emit in descending order: k extractions over the KP slots (the
    # caller unpacks, so the division by dim is XLA's, as in the plain
    # path)
    cur = jnp.where(slot < k, run, sent)
    out = jnp.full((bq, kp), sent, jnp.int32)
    for r in range(k):
        m = jnp.max(cur, axis=1)
        out = jnp.where(slot == r, m[:, None], out)
        cur = jnp.where(cur == m[:, None], jnp.int32(-(2**31)), cur)
    out_ref[...] = out


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "dim", "tile_q", "tile_s", "num_warps", "interpret", "min_keep",
        "max_abs_score",
    ),
)
def topk_dot_triton(
    q_emb: jax.Array,   # int8 [NQ, D], NQ % tile_q == 0
    s_emb: jax.Array,   # int8 [NS, D], NS % tile_s == 0 (pad rows zero)
    ns_valid,           # int32 scalar — true NS before padding
    *,
    k: int,
    dim: int,
    tile_q: int = TILE_Q,
    tile_s: int = TILE_S,
    num_warps: int = NUM_WARPS,
    interpret: bool = False,
    min_keep: float = -float("inf"),
    max_abs_score: int = 4608,
) -> Tuple[jax.Array, jax.Array]:
    """Fused scores + top-k.  ``min_keep`` (in dot/dim units) declares
    that the caller discards scores below it: those never enter, so a
    row whose true top-k lies wholly below it returns (NEG_INF, 0)
    padding, and noise tiles skip the merge.  Every returned entry at
    or above ``min_keep`` equals the exact top-k's.  Leave at -inf for
    the exact full top-k.  ``max_abs_score`` bounds the raw integer dot
    (n^2 * dim for the shingle embedding); past the packing budget
    (65535) the exact plain path answers instead."""
    nq, d = q_emb.shape
    ns = s_emb.shape[0]
    assert nq % tile_q == 0, (nq, tile_q)
    assert ns % tile_s == 0, (ns, tile_s)
    if max_abs_score > _PACK_MAX_SCORE:
        return topk_dot_jnp(
            q_emb, s_emb, ns_valid, k=k, dim=dim,
            max_abs_score=max_abs_score,
        )
    col_bits = _col_bits_for(max_abs_score)
    if ns > (1 << col_bits):
        return _column_chunks(
            lambda s_c, nsv_c: topk_dot_triton(
                q_emb, s_c, nsv_c, k=k, dim=dim, tile_q=tile_q,
                tile_s=tile_s, num_warps=num_warps, interpret=interpret,
                min_keep=min_keep, max_abs_score=max_abs_score,
            ),
            s_emb, ns_valid, k, 1 << col_bits,
        )
    kernel = functools.partial(
        _topk_kernel, k=k, tile_s=tile_s, n_tiles=ns // tile_s,
        min_keep=_min_keep_int(min_keep, dim), col_bits=col_bits,
    )
    packed = pl.pallas_call(
        kernel,
        grid=(nq // tile_q,),
        in_specs=[
            pl.BlockSpec((), lambda i: ()),
            pl.BlockSpec((tile_q, d), lambda i: (i, 0)),
            pl.BlockSpec((ns, d), lambda i: (0, 0)),
        ],
        out_specs=pl.BlockSpec((tile_q, _next_pow2(k)), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((nq, _next_pow2(k)), jnp.int32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps),
        interpret=interpret,
        name="topk_dot",
    )(jnp.asarray(ns_valid, jnp.int32), q_emb, s_emb)
    return _unpack(packed[:, :k], col_bits, dim)


def pad_rows(x: np.ndarray | jax.Array, multiple: int):
    """Zero-pad axis 0 to a multiple; returns (padded, original_len)."""
    n = x.shape[0]
    target = max(multiple, _round_up(n, multiple))
    if target == n:
        return x, n
    pad = [(0, target - n)] + [(0, 0)] * (x.ndim - 1)
    xp = jnp if isinstance(x, jax.Array) else np
    return xp.pad(x, pad), n


def topk_dot(
    q_emb,
    s_emb,
    ns_valid=None,
    *,
    k: int,
    dim: int,
    kernels: bool,
    interpret: bool = False,
    min_keep: float = -float("inf"),
    max_abs_score: int = 4608,
):
    """Top-k of dot/dim for every query row: the Triton kernel when
    ``kernels`` (ops/backend.py decides), else the plain path.  Pads
    both sides for the kernel and returns the true rows only.  Script
    rows at or past ``ns_valid`` (default: all valid) never enter."""
    nq = q_emb.shape[0]
    ns = s_emb.shape[0]
    if ns_valid is None:
        ns_valid = ns
    if nq == 0 or ns == 0:
        return (
            jnp.full((nq, k), NEG_INF, dtype=jnp.float32),
            jnp.zeros((nq, k), dtype=jnp.int32),
        )
    if not kernels:
        vals, idx = topk_dot_jnp(
            jnp.asarray(q_emb), jnp.asarray(s_emb), ns_valid, k=k, dim=dim,
            max_abs_score=max_abs_score,
        )
        return _apply_min_keep(vals, idx, min_keep)
    qp, _ = pad_rows(jnp.asarray(q_emb), TILE_Q)
    sp, _ = pad_rows(jnp.asarray(s_emb), TILE_S)
    vals, idx = topk_dot_triton(
        qp, sp, ns_valid, k=k, dim=dim, interpret=interpret,
        min_keep=min_keep, max_abs_score=max_abs_score,
    )
    return vals[:nq], idx[:nq]


def _apply_min_keep(vals, idx, min_keep: float):
    """The kernel's ``min_keep`` contract on plain results: entries
    below it come back as (NEG_INF, 0), so both paths return the same
    tables."""
    if not np.isfinite(min_keep):
        return vals, idx
    keep = vals >= min_keep
    return jnp.where(keep, vals, NEG_INF), jnp.where(keep, idx, 0)
