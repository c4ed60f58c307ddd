"""The device shingle embedding (plain XLA, data/shingler.py) vs the host
oracle, bit-exact.  (The names date from a fused embedding kernel that
measured no faster than XLA's fusion of the same arithmetic.)"""

import jax
import numpy as np
import pytest

from fandom_search.config import ShingleConfig
from fandom_search.data.hashing import derive_sign_mults
from fandom_search.data.shingler import embed_shingles, embed_shingles_np

CFG = ShingleConfig()


@pytest.mark.parametrize("t_len", [6, 7, 100, 517, 2048])
def test_pallas_embed_matches_oracle(rng, t_len):
    t = rng.integers(0, 2**32, size=t_len, dtype=np.uint32)
    ref = embed_shingles_np(t, CFG)
    out = np.asarray(embed_shingles(t, CFG))
    assert out.shape == ref.shape and out.dtype == np.int8
    np.testing.assert_array_equal(out, ref)


def test_pallas_embed_matches_jnp(rng):
    """Passing the derived multipliers equals deriving them inside, and
    the jitted embedding equals the eager one."""
    t = rng.integers(0, 2**32, size=1000, dtype=np.uint32)
    mults = derive_sign_mults(CFG.seed, CFG.n, CFG.dim)
    a = np.asarray(embed_shingles(t, CFG, mults=mults))
    b = np.asarray(
        jax.jit(lambda x: embed_shingles(x, CFG, mults=mults))(t)
    )
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, np.asarray(embed_shingles(t, CFG)))


@pytest.mark.parametrize("dim,n", [(128, 3), (256, 6), (384, 1)])
def test_pallas_embed_t_matches_oracle(rng, dim, n):
    """Other widths and shingle sizes stay bit-exact."""
    cfg = ShingleConfig(n=n, dim=dim)
    t = rng.integers(0, 2**32, size=300, dtype=np.uint32)
    ref = embed_shingles_np(t, cfg)
    assert ref.shape == (300 - n + 1, dim)
    np.testing.assert_array_equal(np.asarray(embed_shingles(t, cfg)), ref)


def test_pallas_embed_empty():
    t = np.zeros((3,), dtype=np.uint32)  # fewer than n tokens -> 0 shingles
    out = np.asarray(embed_shingles(t, CFG))
    assert out.shape == (0, CFG.dim)
