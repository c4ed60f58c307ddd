"""Multi-chip sharding on a virtual 8-device CPU mesh (SURVEY.md section 5)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fandom_search.config import MeshConfig, PipelineConfig
from fandom_search.data.script_parser import parse_script
from fandom_search.ops.distance_topk import topk_dot_jnp
from fandom_search.parallel.mesh import make_mesh
from fandom_search.parallel.sharded import ShardedSearchEngine, sharded_topk
from fandom_search.search.engine import SearchEngine
from fandom_search.search.index import build_script_index
from fandom_search.utils.synthetic import (
    make_corpus_with_quotes,
    make_script,
    make_vocab,
)

K, DIM = 10, 128


def _mesh(works, script):
    return make_mesh(MeshConfig(works=works, script=script))


@pytest.mark.parametrize("works,script", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_topk_exact(rng, works, script):
    mesh = _mesh(works, script)
    nq = works * 256
    ns_true = 700
    per = -(-max(ns_true, 1) // (script * 512)) * 512
    q = rng.integers(-6, 7, size=(nq, DIM)).astype(np.int8)
    s = np.zeros((per * script, DIM), dtype=np.int8)
    s[:ns_true] = rng.integers(-6, 7, size=(ns_true, DIM)).astype(np.int8)
    ns_valid = np.clip(ns_true - np.arange(script) * per, 0, per).astype(np.int32)

    vals, idx = sharded_topk(
        mesh, jnp.asarray(q), jnp.asarray(s), jnp.asarray(ns_valid),
        K, DIM, kernels=False,
    )
    want_vals, _ = topk_dot_jnp(q, s[:ns_true], k=K, dim=DIM)
    np.testing.assert_allclose(np.asarray(vals), np.asarray(want_vals), atol=1e-6)
    # picked indices must be score-consistent and within the true range
    full = q.astype(np.int32) @ s[:ns_true].astype(np.int32).T / DIM
    idx_h = np.asarray(idx)
    assert idx_h.max() < ns_true
    picked = np.take_along_axis(full, idx_h, axis=1)
    np.testing.assert_allclose(picked, np.asarray(vals), atol=1e-6)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(23)
    vocab = make_vocab(rng, 1200)
    script_text = make_script(rng, vocab, num_lines=20, words_per_line=(7, 12))
    lines = parse_script(script_text)
    works, planted = make_corpus_with_quotes(
        rng, [ln.text for ln in lines], num_works=10, words_per_work=250,
        quotes_per_work=2, num_edits=0, vocab=vocab,
    )
    return lines, works, planted


@pytest.mark.parametrize("works_ax,script_ax", [(4, 2), (8, 1), (1, 8)])
def test_sharded_engine_matches_single(world, works_ax, script_ax):
    lines, works, planted = world
    cfg = PipelineConfig(mesh=MeshConfig(works=works_ax, script=script_ax))
    cfg = dataclasses.replace(
        cfg, search=dataclasses.replace(cfg.search, batch_queries=works_ax * 512)
    )
    index = build_script_index(lines, cfg.shingle, cfg.search)

    single = SearchEngine(index, cfg)
    rows1, _ = single.search_works(works)

    sharded = ShardedSearchEngine(index, cfg)
    rows2, stats = sharded.search_works(works)

    key = lambda r: (r.work_id, r.fan_token_start, r.fan_token_end, r.line_no)
    assert {key(r) for r in rows1} == {key(r) for r in rows2}
    assert stats.num_verified > 0

    found = {(r.work_id, r.line_no) for r in rows2}
    assert all((p.work_id, p.line_no) in found for p in planted)


def test_sharded_batch_granule_alignment(world):
    """Stream buckets stay works-shardable: granule % (works*256) == 0."""
    lines, _, _ = world
    cfg = PipelineConfig(mesh=MeshConfig(works=4, script=2))
    cfg = dataclasses.replace(
        cfg, search=dataclasses.replace(cfg.search, batch_queries=1 << 18)
    )
    index = build_script_index(lines, cfg.shingle, cfg.search)
    eng = ShardedSearchEngine(index, cfg)
    assert eng._batch_granule % (4 * 256) == 0
    # every bucket rung (granule * pow2, capped) stays aligned too
    g = eng._batch_granule
    b = g
    while b < cfg.search.batch_queries:
        assert b % (4 * 256) == 0
        b *= 2


def test_sharded_engine_pallas_interpret(world):
    """Pallas kernels inside shard_map (interpret mode) agree too."""
    lines, works, planted = world
    cfg = PipelineConfig(mesh=MeshConfig(works=2, script=2))
    cfg = dataclasses.replace(
        cfg, search=dataclasses.replace(cfg.search, batch_queries=2 * 512)
    )
    index = build_script_index(lines, cfg.shingle, cfg.search)
    mesh = _mesh(2, 2)

    single = SearchEngine(index, cfg)
    rows1, _ = single.search_works(works)
    sharded = ShardedSearchEngine(
        index, cfg, mesh=mesh, interpret=True
    )
    rows2, _ = sharded.search_works(works)
    key = lambda r: (r.work_id, r.fan_token_start, r.fan_token_end, r.line_no)
    assert {key(r) for r in rows1} == {key(r) for r in rows2}


def test_mesh_shape_for_device_count_math():
    """Multi-host mesh factorization logic (no real hosts needed)."""
    from fandom_search.parallel.mesh import mesh_shape_for

    assert mesh_shape_for(1) == (1, 1)
    assert mesh_shape_for(8) == (8, 1)
    assert mesh_shape_for(8, prefer_script=2) == (4, 2)
    assert mesh_shape_for(8, prefer_script=4) == (2, 4)
    # prefer_script clamps to the largest divisor <= prefer_script
    assert mesh_shape_for(6, prefer_script=4) == (2, 3)
    assert mesh_shape_for(7, prefer_script=4) == (7, 1)
    # v4-pod-ish sizes
    assert mesh_shape_for(256, prefer_script=8) == (32, 8)
    with pytest.raises(ValueError):
        mesh_shape_for(0)


def test_make_mesh_device_count_validation():
    from fandom_search.parallel.mesh import AXIS_SCRIPT, AXIS_WORKS

    n = len(jax.devices())
    if n >= 8:
        mesh = _mesh(4, 2)
        assert mesh.shape[AXIS_WORKS] == 4 and mesh.shape[AXIS_SCRIPT] == 2
    with pytest.raises(ValueError, match="needs"):
        make_mesh(MeshConfig(works=n + 1, script=1))


def test_multihost_cli_flag_wiring():
    """--multihost exists and routes to initialize_multihost (mocked —
    there is no second host here)."""
    from fandom_search import cli
    from fandom_search.parallel import mesh as mesh_mod

    p = cli.build_parser()
    args = p.parse_args([
        "search", "works", "script.txt", "-o", "out.csv",
        "--multihost", "--coordinator", "h:1234",
        "--num-processes", "2", "--process-id", "0",
    ])
    assert args.multihost and args.coordinator == "h:1234"

    called = {}
    orig = mesh_mod.initialize_multihost
    mesh_mod.initialize_multihost = lambda **kw: called.update(kw) or 8
    try:
        cli._maybe_multihost(args)
    finally:
        mesh_mod.initialize_multihost = orig
    assert called == {
        "coordinator_address": "h:1234",
        "num_processes": 2,
        "process_id": 0,
    }


def test_sharded_engine_with_bucketed_prefilter(world):
    """The bucketed prefilter attaches to the sharded engine (two-stage
    flow, replicated rerank) and reproduces its rows."""
    import dataclasses as dc

    from fandom_search.config import BucketedConfig
    from fandom_search.ops.bucketed import attach_bucketed_prefilter
    from fandom_search.search.index import build_script_index

    lines, works, planted = world
    cfg = PipelineConfig()
    cfg = dc.replace(cfg, search=dc.replace(cfg.search, batch_queries=2048))
    index = build_script_index(lines, cfg.shingle, cfg.search)
    mesh = _mesh(2, 1)
    base = ShardedSearchEngine(index, cfg, mesh=mesh)
    want, _ = base.search_works(works)

    eng = ShardedSearchEngine(index, cfg, mesh=mesh)
    attach_bucketed_prefilter(eng, BucketedConfig())
    got, stats = eng.search_works(works)
    key = lambda r: (r.work_id, r.fan_token_start, r.line_no)  # noqa: E731
    assert {key(r) for r in got} == {key(r) for r in want}
    assert stats.num_verified > 0


def test_sharded_engine_with_stream_compression(world):
    """Compressed uploads decode before the sharded fused call
    (ShardedSearchEngine._fused_call_enc): rows identical to the
    uncompressed sharded engine across multiple batches."""
    lines, works, planted = world
    cfg = PipelineConfig(mesh=MeshConfig(works=4, script=2))
    index = build_script_index(lines, cfg.shingle, cfg.search)

    def run(compress):
        c = dataclasses.replace(
            cfg, search=dataclasses.replace(
                cfg.search, batch_queries=4 * 512, stream_compress=compress
            )
        )
        eng = ShardedSearchEngine(index, c)
        rows, stats = eng.search_works(works)
        return rows, stats, eng

    rows_off, _, _ = run(False)
    rows_on, stats_on, eng_on = run(True)
    assert stats_on.num_batches > 1  # encoded path exercised past bootstrap
    assert eng_on._venc is not None and eng_on._venc.ready
    key = lambda r: (r.work_id, r.fan_token_start, r.fan_token_end,
                     r.line_no, round(r.score, 4), round(r.verify_score, 4))
    assert sorted(map(key, rows_on)) == sorted(map(key, rows_off))


@pytest.mark.parametrize("works_ax,script_ax", [(4, 1), (1, 4)])
def test_sharded_engine_kernel_meshes(world, works_ax, script_ax):
    """The kernels (interpret mode) inside shard_map on an all-works and
    an all-script mesh give the single-device rows."""
    lines, works, planted = world
    cfg = PipelineConfig(mesh=MeshConfig(works=works_ax, script=script_ax))
    cfg = dataclasses.replace(
        cfg, search=dataclasses.replace(
            cfg.search, batch_queries=works_ax * 512
        )
    )
    index = build_script_index(lines, cfg.shingle, cfg.search)
    single = SearchEngine(index, cfg)
    rows1, _ = single.search_works(works)
    sharded = ShardedSearchEngine(
        index, cfg, mesh=_mesh(works_ax, script_ax), interpret=True
    )
    rows2, _ = sharded.search_works(works)
    key = lambda r: (r.work_id, r.fan_token_start, r.fan_token_end, r.line_no)
    assert {key(r) for r in rows1} == {key(r) for r in rows2}


@pytest.mark.parametrize("works_ax,script_ax", [(2, 2), (1, 4)])
def test_sharded_topk_kernel_exact_indices(rng, works_ax, script_ax):
    """The cross-shard merge keeps the lowest global index on ties: a
    script row duplicated into every shard resolves to its first copy,
    exactly as the single-device plain path does."""
    mesh = _mesh(works_ax, script_ax)
    per = 128
    ns_true = per * script_ax - 37
    q = rng.integers(-6, 7, size=(64 * works_ax, DIM)).astype(np.int8)
    s = np.zeros((per * script_ax, DIM), dtype=np.int8)
    s[:ns_true] = rng.integers(-6, 7, size=(ns_true, DIM)).astype(np.int8)
    for sh in range(script_ax):
        s[sh * per + 5] = q[0]
    ns_valid = np.clip(
        ns_true - np.arange(script_ax) * per, 0, per
    ).astype(np.int32)
    vals, idx = sharded_topk(
        mesh, jnp.asarray(q), jnp.asarray(s), jnp.asarray(ns_valid),
        K, DIM, kernels=True, interpret=True,
    )
    want_v, want_i = topk_dot_jnp(q, s[:ns_true], k=K, dim=DIM)
    np.testing.assert_array_equal(np.asarray(vals), np.asarray(want_v))
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(want_i))
    assert int(np.asarray(idx)[0, 0]) == 5
