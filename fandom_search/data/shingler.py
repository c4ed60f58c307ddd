"""Shingle construction and signed-random-feature embedding.

Reference behavior (SURVEY.md section 3, "Shingler + hash vectorizer";
BASELINE.json:5): slide a 6-word window, map each word to a numeric hash,
treat the shingle as a point in metric space, and find near neighbors.

Accelerator redesign: the 6 small coordinates become one dense vector
built from pseudo-random signs, so similarity is a *dot product* and
candidate generation is an int8 matrix product on the tensor cores:

    v(p, w)[l] = sign bit of (hash(w) * mult[p, l])   (wrapping uint32)
    e(shingle) = sum_p v(p, w_p)                 (entries in [-n, n])
    dot(e_q, e_s) = dim * (#positions matching) + noise(sd ~ n*sqrt(dim))

so score = dot / dim estimates "matching words out of n" with sd ~
n/sqrt(dim) (~0.5 for n=6, dim=128) — a razor-thin candidate threshold.
The sign features are multiply-shift hashes (one odd constant per
(position, lane); data/hashing.py derive_sign_mults): word hashes are
already fmix32-finalized, so the single wrapping multiply costs ~4
integer ops per output element instead of ~80 for a per-lane re-hash,
with measured-identical noise statistics.  Host (NumPy) and device
(jnp) paths are bit-identical.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from fandom_search.config import ShingleConfig
from fandom_search.data.hashing import derive_sign_mults


def num_shingles(num_tokens: int, cfg: ShingleConfig) -> int:
    return max(0, num_tokens - cfg.n + 1)


def shingle_hashes(token_hashes: np.ndarray, cfg: ShingleConfig) -> np.ndarray:
    """[T] uint32 token hashes -> [T-n+1, n] uint32 shingle windows (host)."""
    t = np.asarray(token_hashes, dtype=np.uint32)
    m = num_shingles(t.shape[0], cfg)
    if m == 0:
        return np.zeros((0, cfg.n), dtype=np.uint32)
    return np.lib.stride_tricks.sliding_window_view(t, cfg.n).copy()


def embed_shingles_np(token_hashes: np.ndarray, cfg: ShingleConfig) -> np.ndarray:
    """Host-side oracle embedding: uint32[T] -> int8[T-n+1, dim].

    Entries are in [-n, n]; int8 is exact and matmul-friendly.
    """
    mults = derive_sign_mults(cfg.seed, cfg.n, cfg.dim)  # [n, dim]
    t = np.asarray(token_hashes, dtype=np.uint32)
    m = num_shingles(t.shape[0], cfg)
    if m == 0:
        return np.zeros((0, cfg.dim), dtype=np.int8)
    acc = np.zeros((m, cfg.dim), dtype=np.int16)
    for p in range(cfg.n):
        prod = t[p : p + m][:, None] * mults[p][None, :]  # wraps mod 2^32
        # top bit as sign: int32 arithmetic shift gives 0 / -1
        acc += (
            (prod.astype(np.int32) >> 31).astype(np.int16) * 2 + 1
        )
    return acc.astype(np.int8)


def embed_shingles(token_hashes, cfg: ShingleConfig, mults=None):
    """Device-side embedding: uint32[T] -> int8[T-n+1, dim] (jit-safe).

    ``token_hashes`` length must be static under jit (pad on host).  The
    whole thing is elementwise + a final sum, which XLA fuses into one
    pass; a hand-written Pallas kernel for it did not beat that fusion
    on the GPU (PERF.md, kernel decisions).
    """
    if mults is None:
        mults = jnp.asarray(derive_sign_mults(cfg.seed, cfg.n, cfg.dim))
    t = jnp.asarray(token_hashes, dtype=jnp.uint32)
    m = num_shingles(t.shape[0], cfg)
    if m == 0:
        return jnp.zeros((0, cfg.dim), dtype=jnp.int8)
    acc = jnp.zeros((m, cfg.dim), dtype=jnp.int16)
    for p in range(cfg.n):
        prod = t[p : p + m][:, None] * mults[p][None, :]
        acc = acc + (
            jax.lax.shift_right_arithmetic(
                prod.astype(jnp.int32), jnp.int32(31)
            ).astype(jnp.int16)
            * 2
            + 1
        )
    return acc.astype(jnp.int8)
