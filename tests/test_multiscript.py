"""Multi-script index (search/index.py concat_indexes): one corpus
pass against several scripts with per-script attribution.

Contracts under test:
- engine rows on the concatenated index == oracle rows (the existing
  golden contract, now on a multi-script index);
- with k large enough to avoid cross-script top-k crowding, the
  multi-index run equals the union of per-script runs (line numbers
  remapped);
- every row's ``script`` column names the script that owns its line;
- persistence round-trips the script labels;
- matrix aggregation carries the script column.
"""

import dataclasses

import numpy as np
import pytest

from fandom_search.config import PipelineConfig
from fandom_search.data.script_parser import parse_script
from fandom_search.search.engine import SearchEngine
from fandom_search.search.index import build_script_index, concat_indexes
from fandom_search.search.oracle import search_works_oracle
from fandom_search.utils.synthetic import (
    make_corpus_with_quotes,
    make_script,
    make_vocab,
)


@pytest.fixture(scope="module")
def multi_world():
    cfg = PipelineConfig()
    rng = np.random.default_rng(41)
    vocab = make_vocab(rng, 1500)
    texts = {
        "alpha": make_script(rng, vocab, num_lines=14, words_per_line=(7, 12)),
        "beta": make_script(rng, vocab, num_lines=11, words_per_line=(7, 12)),
    }
    lines = {n: parse_script(t) for n, t in texts.items()}
    parts = [
        (n, build_script_index(lines[n], cfg.shingle, cfg.search))
        for n in ("alpha", "beta")
    ]
    index = concat_indexes(parts)
    # corpus quoting BOTH scripts
    works_a, planted_a = make_corpus_with_quotes(
        rng, [ln.text for ln in lines["alpha"]], num_works=5,
        words_per_work=300, quotes_per_work=2, num_edits=0, vocab=vocab,
    )
    works_b, planted_b = make_corpus_with_quotes(
        rng, [ln.text for ln in lines["beta"]], num_works=5,
        words_per_work=300, quotes_per_work=2, num_edits=0, vocab=vocab,
    )
    works = {f"a_{w}": t for w, t in works_a.items()}
    works.update({f"b_{w}": t for w, t in works_b.items()})
    return cfg, lines, parts, index, works, planted_a, planted_b


def _key(r):
    return (r.work_id, r.fan_token_start, r.fan_token_end, r.line_no,
            round(r.score, 4), round(r.verify_score, 4))


def test_concat_index_tables(multi_world):
    cfg, lines, parts, index, *_ = multi_world
    na, nb = (p[1].num_shingles for p in parts)
    assert index.num_shingles == na + nb
    la = len(lines["alpha"])
    assert [ln.script for ln in index.lines[:la]] == ["alpha"] * la
    assert all(ln.script == "beta" for ln in index.lines[la:])
    assert [ln.line_no for ln in index.lines] == list(range(len(index.lines)))
    # shingle attribution points into the owning script's line range
    assert index.shingle_line[:na].max() < la
    assert index.shingle_line[na:].min() >= la
    # line_start offsets are consistent with line lengths
    ls, ll = index.line_start, index.line_lengths
    np.testing.assert_array_equal(ls[1:], ls[:-1] + ll[:-1])
    with pytest.raises(ValueError):
        concat_indexes([("x", parts[0][1]), ("x", parts[1][1])])


def test_engine_oracle_parity_on_multi_index(multi_world):
    cfg, _, _, index, works, planted_a, planted_b = multi_world
    eng = SearchEngine(index, cfg)
    rows, _ = eng.search_works(works)
    orows, _ = search_works_oracle(works, index, cfg)
    assert sorted(map(_key, rows)) == sorted(map(_key, orows)) != []
    # attribution: a row's script owns the row's line
    for r in rows:
        assert r.script == index.lines[r.line_no].script != ""
    found = {(r.work_id, r.line_no, r.script) for r in rows}
    la = len([ln for ln in index.lines if ln.script == "alpha"])
    for p in planted_a:
        assert (f"a_{p.work_id}", p.line_no, "alpha") in found
    for p in planted_b:
        assert (f"b_{p.work_id}", p.line_no + la, "beta") in found


def test_multi_equals_union_of_singles(multi_world):
    cfg, lines, parts, index, works, _, _ = multi_world
    # generous k so per-script and cross-script top-k agree
    cfg = dataclasses.replace(
        cfg, search=dataclasses.replace(cfg.search, k=32, batch_queries=8192)
    )
    parts = [
        (n, build_script_index(lines[n], cfg.shingle, cfg.search))
        for n, _ in parts
    ]
    index = concat_indexes(parts)
    multi_rows, _ = SearchEngine(index, cfg).search_works(
        works
    )
    la = len(lines["alpha"])
    union = []
    for name, idx in parts:
        rows, _ = SearchEngine(idx, cfg).search_works(works)
        off = 0 if name == "alpha" else la
        union.extend(
            (r.work_id, r.fan_token_start, r.fan_token_end, r.line_no + off)
            for r in rows
        )
    got = sorted(
        (r.work_id, r.fan_token_start, r.fan_token_end, r.line_no)
        for r in multi_rows
    )
    assert got == sorted(union) != []


def test_persist_roundtrip_scripts(multi_world, tmp_path):
    cfg, _, _, index, works, _, _ = multi_world
    from fandom_search.search.persist import load_index, save_index

    save_index(index, cfg, tmp_path / "idx")
    loaded, cfg2 = load_index(tmp_path / "idx")
    assert [ln.script for ln in loaded.lines] == [
        ln.script for ln in index.lines
    ]
    rows, _ = SearchEngine(loaded, cfg2).search_works(works)
    base, _ = SearchEngine(index, cfg).search_works(works)
    assert sorted(map(_key, rows)) == sorted(map(_key, base))


def test_matrix_carries_script_column(multi_world):
    cfg, _, _, index, works, _, _ = multi_world
    from fandom_search.search.report import aggregate_matrix

    rows, _ = SearchEngine(index, cfg).search_works(works)
    records = aggregate_matrix(rows, index.lines)
    assert all("script" in rec for rec in records)
    by_line = {rec["line_no"]: rec for rec in records}
    for r in rows:
        assert by_line[r.line_no]["script"] == r.script
    # single-script aggregation stays schema-identical to the reference
    single = aggregate_matrix(
        [r._replace(script="") for r in rows[:3]]
    )
    assert all("script" not in rec for rec in single)


def test_matrix_falls_back_to_row_scripts(multi_world):
    """`matrix --script one.txt` on a multi-script matches.csv: lines
    the provided script_lines can't label keep the attribution the
    match rows carry instead of a blank (advisor r2 low: report.py)."""
    from fandom_search.data.script_parser import ScriptLine
    from fandom_search.search.report import aggregate_matrix

    cfg, _, _, index, works, _, _ = multi_world
    rows, _ = SearchEngine(index, cfg).search_works(works)
    assert any(r.script for r in rows)
    # script_lines with EMPTY script labels (what parsing one lone file
    # produces), same global line_no space
    unlabeled = [
        ScriptLine(ln.line_no, ln.speaker, ln.text, "")
        for ln in index.lines
    ]
    records = aggregate_matrix(rows, unlabeled)
    by_line = {rec["line_no"]: rec for rec in records}
    for r in rows:
        assert by_line[r.line_no]["script"] == r.script


def test_multiscript_with_bucketed_prefilter(multi_world):
    """The bucketed prefilter attaches to a multi-script (concatenated)
    index — concat_indexes carries shingle_windows — and reproduces the
    exact engine's rows including script attribution."""
    from fandom_search.config import BucketedConfig
    from fandom_search.ops.bucketed import attach_bucketed_prefilter

    cfg, _, _, index, works, _, _ = multi_world
    exact = SearchEngine(index, cfg, interpret=True)
    want, _ = exact.search_works(works)
    assert want

    eng = SearchEngine(index, cfg, interpret=True)
    attach_bucketed_prefilter(eng, BucketedConfig())
    got, _ = eng.search_works(works)
    key = lambda r: (  # noqa: E731
        r.work_id, r.fan_token_start, r.line_no, r.script,
    )
    assert {key(r) for r in got} == {key(r) for r in want}
