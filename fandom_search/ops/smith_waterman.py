"""Batched Smith-Waterman — the Levenshtein replacement.

The reference verifies each candidate pair with a C-extension
Levenshtein ratio on strings (SURVEY.md section 4.2 HOT LOOP 2).  This
build verifies at the word level: local alignment of a fan-side token
window against the attributed script line's tokens, on the device, for
a whole batch of pairs at once.

Scoring is linear-gap Smith-Waterman:

    H[i][j] = max(0, H[i-1][j-1] + sub(i, j), H[i-1][j] + gap,
                     H[i][j-1] + gap)

and the output is normalized: best / (match * min(len_a, len_b)) — 1.0
when the shorter side is contained exactly.  Semantics are bit-matched
by three implementations: NumPy (search/verify_np.py), the jnp
anti-diagonal ``lax.scan`` (``sw_normalized_jnp``, the plain path and
oracle), and a Pallas kernel on the Triton route
(``sw_normalized_triton``).

The kernel gives each GPU thread whole pairs: a block of ``tile_b``
pairs is a set of [tile_b] vectors, one lane per pair, and the DP row
of every pair (LA cells) stays in registers for the whole alignment.
Rows walk the script-line side b (the short side in the engine: lines
are mostly far shorter than the 64-token fan window), up to the
block's longest b — the engine length-sorts its verify batches, so a
block's rows hug its pairs' real lengths.  Columns walk a, unrolled.
No lane ever talks to another, so there is no shuffle, no shared
memory and no barrier; all scores are small integers in f32, exact.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from fandom_search.config import SearchConfig


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# jnp reference path (lax.scan over anti-diagonals) — runs anywhere
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("match", "mismatch", "gap"))
def _sw_best_jnp(a, b, len_a, len_b, *, match, mismatch, gap):
    """a: uint32 [B, LA], b: uint32 [B, LB] -> best score f32 [B]."""
    bsz, la = a.shape
    lb = b.shape[1]
    j_ids = jnp.arange(lb, dtype=jnp.int32)[None, :]            # [1, LB]
    valid_j = j_ids < len_b[:, None]                             # [B, LB]

    def shift_right(x):
        return jnp.pad(x, ((0, 0), (1, 0)))[:, :-1]

    def step(carry, d):
        h_prev, h_prevprev, a_diag, best = carry
        # a_diag[j] should hold a[d - j]; roll right and inject a[:, d].
        a_col = jnp.take_along_axis(
            a, jnp.minimum(d, la - 1)[None, None].astype(jnp.int32)
            .repeat(bsz, axis=0), axis=1
        )                                                        # [B, 1]
        a_diag = shift_right(a_diag)
        a_diag = a_diag.at[:, 0].set(jnp.where(d < la, a_col[:, 0], jnp.uint32(0)))

        i_ids = d - j_ids                                        # [1, LB]
        valid = (i_ids >= 0) & (i_ids < len_a[:, None]) & valid_j

        sub = jnp.where(a_diag == b, match, mismatch)
        h = jnp.maximum(
            shift_right(h_prevprev) + sub,
            jnp.maximum(shift_right(h_prev), h_prev) + gap,
        )
        h = jnp.maximum(h, 0.0)
        h = jnp.where(valid, h, 0.0)
        best = jnp.maximum(best, h)
        return (h, h_prev, a_diag, best), None

    init = (
        jnp.zeros((bsz, lb), jnp.float32),
        jnp.zeros((bsz, lb), jnp.float32),
        jnp.full((bsz, lb), 0xFFFFFFFF, dtype=jnp.uint32),
        jnp.zeros((bsz, lb), jnp.float32),
    )
    steps = jnp.arange(la + lb - 1, dtype=jnp.int32)
    (_, _, _, best), _ = jax.lax.scan(step, init, steps)
    return jnp.max(best, axis=1)


def sw_normalized_jnp(a, b, len_a, len_b, cfg: SearchConfig):
    len_a = jnp.asarray(len_a, jnp.int32).reshape(-1)
    len_b = jnp.asarray(len_b, jnp.int32).reshape(-1)
    best = _sw_best_jnp(
        jnp.asarray(a, jnp.uint32),
        jnp.asarray(b, jnp.uint32),
        len_a,
        len_b,
        match=cfg.sw_match,
        mismatch=cfg.sw_mismatch,
        gap=cfg.sw_gap,
    )
    denom = cfg.sw_match * jnp.maximum(
        1, jnp.minimum(jnp.asarray(len_a), jnp.asarray(len_b))
    ).astype(jnp.float32)
    return best / denom


# ---------------------------------------------------------------------------
# Triton-route Pallas kernel
# ---------------------------------------------------------------------------

# pairs per program and warps per program: one pair per thread
TILE_B = 32
NUM_WARPS = 1


def _sw_kernel(
    a_ref,      # [LA, TB] uint32 — fan windows, one column per pair
    b_ref,      # [LB, TB] uint32 — script segments, one column per pair
    lena_ref,   # [TB] int32
    lenb_ref,   # [TB] int32
    out_ref,    # [TB] f32 — best raw score per pair
    *,
    la: int,
    match: float,
    mismatch: float,
    gap: float,
):
    len_a = lena_ref[...]
    len_b = lenb_ref[...]
    a_cols = [a_ref[j, :] for j in range(la)]
    col_ok = [len_a > j for j in range(la)]
    zero = jnp.zeros(len_a.shape, jnp.float32)

    def row(i, carry):
        h_prev, best = carry
        b_i = b_ref[i, :]
        row_ok = len_b > i
        left = zero
        h_row = []
        for j in range(la):
            diag = h_prev[j - 1] if j else zero
            sub = jnp.where(a_cols[j] == b_i, jnp.float32(match),
                            jnp.float32(mismatch))
            h = jnp.maximum(
                jnp.maximum(diag + sub, h_prev[j] + jnp.float32(gap)),
                jnp.maximum(left + jnp.float32(gap), zero),
            )
            h = jnp.where(jnp.logical_and(row_ok, col_ok[j]), h, zero)
            best = jnp.maximum(best, h)
            h_row.append(h)
            left = h
        return tuple(h_row), best

    rows = jnp.max(len_b)
    _, best = jax.lax.fori_loop(
        0, rows, row, (tuple(zero for _ in range(la)), zero)
    )
    out_ref[...] = best


@functools.partial(
    jax.jit,
    static_argnames=(
        "match", "mismatch", "gap", "tile_b", "num_warps", "interpret",
    ),
)
def _sw_best_triton(
    a, b, len_a, len_b, *, match, mismatch, gap, tile_b, num_warps,
    interpret,
):
    bsz, la = a.shape
    lb = b.shape[1]
    return pl.pallas_call(
        functools.partial(
            _sw_kernel, la=la, match=match, mismatch=mismatch, gap=gap,
        ),
        grid=(bsz // tile_b,),
        in_specs=[
            pl.BlockSpec((la, tile_b), lambda i: (0, i)),
            pl.BlockSpec((lb, tile_b), lambda i: (0, i)),
            pl.BlockSpec((tile_b,), lambda i: (i,)),
            pl.BlockSpec((tile_b,), lambda i: (i,)),
        ],
        out_specs=pl.BlockSpec((tile_b,), lambda i: (i,)),
        out_shape=jax.ShapeDtypeStruct((bsz,), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps),
        interpret=interpret,
        name="smith_waterman",
    )(a.T, b.T, len_a, len_b)


def sw_normalized_triton(
    a,
    b,
    len_a,
    len_b,
    cfg: SearchConfig,
    *,
    tile_b: int = TILE_B,
    num_warps: int = NUM_WARPS,
    interpret: bool = False,
):
    """Normalized SW scores for a batch of pairs (the kernel). Pads the
    batch to ``tile_b``; padding pairs have zero lengths."""
    a = jnp.asarray(a, jnp.uint32)
    b = jnp.asarray(b, jnp.uint32)
    len_a = jnp.asarray(len_a, jnp.int32).reshape(-1)
    len_b = jnp.asarray(len_b, jnp.int32).reshape(-1)
    bsz = a.shape[0]
    if bsz == 0:
        return jnp.zeros((0,), jnp.float32)
    pad = _cdiv(bsz, tile_b) * tile_b - bsz
    if pad:
        a = jnp.pad(a, ((0, pad), (0, 0)))
        b = jnp.pad(b, ((0, pad), (0, 0)))
        len_a = jnp.pad(len_a, (0, pad))
        len_b = jnp.pad(len_b, (0, pad))
    best = _sw_best_triton(
        a, b, len_a, len_b,
        match=cfg.sw_match, mismatch=cfg.sw_mismatch, gap=cfg.sw_gap,
        tile_b=tile_b, num_warps=num_warps, interpret=interpret,
    )[:bsz]
    # the normalization is the reference's own XLA expression, so kernel
    # and plain path agree bit for bit
    denom = cfg.sw_match * jnp.maximum(
        1, jnp.minimum(len_a[:bsz], len_b[:bsz])
    ).astype(jnp.float32)
    return best / denom


def sw_normalized(a, b, len_a, len_b, cfg: SearchConfig, *, kernels: bool,
                  interpret: bool = False):
    """The kernel when ``kernels`` (ops/backend.py decides), else the
    plain path."""
    if kernels:
        return sw_normalized_triton(
            a, b, len_a, len_b, cfg, interpret=interpret
        )
    return sw_normalized_jnp(a, b, len_a, len_b, cfg)
