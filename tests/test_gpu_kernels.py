"""The kernels as compiled for the GPU (no interpreter) against the plain
reference, exact.  Card-only: marked ``gpu``, skipped without a card;
``python chip_smoke.py`` runs them on the card (phase 1)."""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; run on the card by chip_smoke.py")


@pytest.mark.parametrize("min_keep", [-float("inf"), 3.5])
@pytest.mark.parametrize("nq,ns", [(4096, 2048), (1000, 3001)])
def test_topk_kernel_compiled_exact(gpu, nq, ns, min_keep):
    from fandom_search.ops.distance_topk import topk_dot

    rng = np.random.default_rng(nq + ns)
    q = rng.integers(-6, 7, size=(nq, 128)).astype(np.int8)
    s = rng.integers(-6, 7, size=(ns, 128)).astype(np.int8)
    s[::7] = q[: len(s[::7])]  # planted hits, and ties below
    s[1::97] = s[0]
    kv, ki = topk_dot(q, s, k=10, dim=128, kernels=True, min_keep=min_keep)
    pv, pi = topk_dot(q, s, k=10, dim=128, kernels=False, min_keep=min_keep)
    np.testing.assert_array_equal(np.asarray(kv), np.asarray(pv))
    np.testing.assert_array_equal(np.asarray(ki), np.asarray(pi))


@pytest.mark.parametrize("sorted_lengths", [True, False])
def test_sw_kernel_compiled_exact(gpu, sorted_lengths):
    from fandom_search.config import SearchConfig
    from fandom_search.ops.smith_waterman import (
        sw_normalized_jnp, sw_normalized_triton,
    )

    rng = np.random.default_rng(3)
    n = 3000
    a = rng.integers(0, 6, size=(n, 64)).astype(np.uint32)
    b = rng.integers(0, 6, size=(n, 64)).astype(np.uint32)
    la = rng.integers(0, 65, size=n).astype(np.int32)
    lb = rng.integers(0, 65, size=n).astype(np.int32)
    if sorted_lengths:
        order = np.argsort(-(la + lb), kind="stable")
        a, b, la, lb = a[order], b[order], la[order], lb[order]
    cfg = SearchConfig()
    got = np.asarray(sw_normalized_triton(a, b, la, lb, cfg))
    want = np.asarray(sw_normalized_jnp(a, b, la, lb, cfg))
    np.testing.assert_array_equal(got, want)
