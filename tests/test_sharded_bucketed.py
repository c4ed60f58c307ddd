"""Mesh-sharded bucketed prefilter (parallel/sharded_bucketed.py) on
the virtual 8-device CPU mesh: query-sharded probing with a ppermute
halo, all_gather triple merge, and the hybrid exact rescue — all
row-parity-checked against the single-device exact engine."""

import dataclasses

import numpy as np
import pytest

from fandom_search.config import BucketedConfig, MeshConfig, PipelineConfig
from fandom_search.data.script_parser import parse_script
from fandom_search.parallel.mesh import make_mesh
from fandom_search.parallel.sharded import ShardedSearchEngine
from fandom_search.parallel.sharded_bucketed import (
    attach_bucketed_prefilter_sharded,
)
from fandom_search.search.engine import SearchEngine
from fandom_search.search.index import build_script_index
from fandom_search.utils.synthetic import (
    make_corpus_with_quotes,
    make_script,
    make_vocab,
)

CFG = PipelineConfig()
BCFG = BucketedConfig()

_KEY = staticmethod(lambda r: (r.work_id, r.fan_token_start, r.line_no))


def _key(r):
    return (r.work_id, r.fan_token_start, r.line_no)


def _cfg(works_ax, script_ax):
    cfg = PipelineConfig(mesh=MeshConfig(works=works_ax, script=script_ax))
    return dataclasses.replace(
        cfg,
        search=dataclasses.replace(
            cfg.search, batch_queries=works_ax * 512
        ),
    )


@pytest.fixture(scope="module")
def uniform_world():
    rng = np.random.default_rng(91)
    vocab = make_vocab(rng, 1000)
    lines = parse_script(
        make_script(rng, vocab, num_lines=18, words_per_line=(7, 12))
    )
    works, planted = make_corpus_with_quotes(
        rng, [ln.text for ln in lines], num_works=10, words_per_work=220,
        quotes_per_work=2, vocab=vocab,
    )
    return lines, works, planted


@pytest.mark.parametrize("works_ax,script_ax", [(4, 2), (8, 1), (2, 4)])
def test_sharded_bucketed_pure_matches_exact(
    uniform_world, works_ax, script_ax
):
    """Uniform vocab -> zero overflow -> the pure query-sharded flat
    path; rows must equal the single-device exact engine's."""
    lines, works, planted = uniform_world
    cfg = _cfg(works_ax, script_ax)
    index = build_script_index(lines, cfg.shingle, cfg.search)

    exact = SearchEngine(index, cfg)
    want, _ = exact.search_works(works)
    assert want

    eng = ShardedSearchEngine(
        index, cfg, mesh=make_mesh(cfg.mesh)
    )
    attach_bucketed_prefilter_sharded(eng, BCFG)
    assert eng.bucketed.overflow_frac == 0.0
    got, stats = eng.search_works(works)
    assert {_key(r) for r in got} == {_key(r) for r in want}
    found = {(r.work_id, r.line_no) for r in got}
    assert all((p.work_id, p.line_no) in found for p in planted)


def test_sharded_bucketed_hybrid_rescues_skew(rng):
    """Skewed (stopword-led) script: hot buckets overflow, at-risk
    queries reroute through the replicated exact rescue, and the mesh
    rows still equal the single-device exact engine's."""
    from tests.test_bucketed import _skewed_world

    _, index, works = _skewed_world(rng)
    cfg = _cfg(4, 2)
    # rebuild the index under the mesh cfg (identical shingle params)
    exact = SearchEngine(index, cfg)
    want, wstats = exact.search_works(works)
    assert wstats.num_verified > 0

    eng = ShardedSearchEngine(
        index, cfg, mesh=make_mesh(cfg.mesh)
    )
    attach_bucketed_prefilter_sharded(eng, BCFG)
    assert eng.bucketed.overflow_frac > 0.05
    got, _ = eng.search_works(works)
    assert {_key(r) for r in got} == {_key(r) for r in want}
    assert eng._bucketed_risk_queries > 0
    assert eng._bucketed_total_queries >= eng._bucketed_risk_queries


def test_sharded_bucketed_interpret_pallas(uniform_world):
    """The attach composes with the Pallas-interpret sharded engine
    (the configuration dryrun_multichip runs)."""
    lines, works, _ = uniform_world
    cfg = _cfg(2, 4)
    index = build_script_index(lines, cfg.shingle, cfg.search)
    exact = SearchEngine(index, cfg)
    want, _ = exact.search_works(works)

    eng = ShardedSearchEngine(
        index, cfg, mesh=make_mesh(cfg.mesh),
        interpret=True,
    )
    attach_bucketed_prefilter_sharded(eng, BCFG)
    got, _ = eng.search_works(works)
    assert {_key(r) for r in got} == {_key(r) for r in want}
