import csv
import json
import subprocess
import sys

import numpy as np
import pytest

from fandom_search.config import PipelineConfig
from fandom_search.data.script_parser import parse_script
from fandom_search.search.engine import SearchEngine
from fandom_search.search.index import build_script_index
from fandom_search.search.persist import load_index, save_index
from fandom_search.search.runner import ResumableRunner
from fandom_search.utils.profiling import StageTimer
from fandom_search.utils.synthetic import (
    make_corpus_with_quotes,
    make_script,
    make_vocab,
)

CFG = PipelineConfig()


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(31)
    vocab = make_vocab(rng, 900)
    lines = parse_script(make_script(rng, vocab, num_lines=15))
    index = build_script_index(lines, CFG.shingle, CFG.search)
    works, planted = make_corpus_with_quotes(
        rng, [ln.text for ln in lines], num_works=9, words_per_work=150,
        quotes_per_work=1, vocab=vocab,
    )
    return index, works, planted


def test_save_load_roundtrip(tmp_path, world):
    index, works, _ = world
    save_index(index, CFG, tmp_path / "idx")
    index2, cfg2 = load_index(tmp_path / "idx")

    assert cfg2.shingle == CFG.shingle
    assert cfg2.search == CFG.search
    assert cfg2.bucketed == CFG.bucketed
    np.testing.assert_array_equal(index2.embeddings, index.embeddings)
    np.testing.assert_array_equal(index2.shingle_line, index.shingle_line)
    np.testing.assert_array_equal(index2.line_start, index.line_start)
    np.testing.assert_array_equal(index2.shingle_anchor, index.shingle_anchor)
    assert [ln.text for ln in index2.lines] == [ln.text for ln in index.lines]

    # a loaded index must search identically
    e1 = SearchEngine(index, CFG)
    e2 = SearchEngine(index2, cfg2)
    r1, _ = e1.search_works(works)
    r2, _ = e2.search_works(works)
    assert [r.to_csv_row() for r in r1] == [r.to_csv_row() for r in r2]


def test_index_files_are_npz_and_json(tmp_path, world):
    """The saved index is plain NumPy archives plus JSON: loadable with
    numpy alone, no checkpoint library."""
    index, _, _ = world
    save_index(index, CFG, tmp_path / "idx")
    names = sorted(p.name for p in (tmp_path / "idx").iterdir())
    assert names == ["arrays.npz", "meta.json"]
    with np.load(tmp_path / "idx" / "arrays.npz", allow_pickle=False) as z:
        np.testing.assert_array_equal(z["embeddings"], index.embeddings)
        assert z["embeddings"].dtype == np.int8
        assert z["stream_hashes"].dtype == np.uint32
    meta = json.loads((tmp_path / "idx" / "meta.json").read_text())
    assert meta["version"] == 4 and "lsh" not in meta


def test_old_index_version_is_refused(tmp_path, world):
    index, _, _ = world
    save_index(index, CFG, tmp_path / "idx")
    meta_p = tmp_path / "idx" / "meta.json"
    meta = json.loads(meta_p.read_text())
    meta["version"] = 3
    meta_p.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="rebuild"):
        load_index(tmp_path / "idx")


def test_save_overwrites_in_place(tmp_path, world):
    """Saving twice to one directory leaves one complete archive (the
    write goes through a temporary name, then replaces)."""
    index, _, _ = world
    save_index(index, CFG, tmp_path / "idx")
    save_index(index, CFG, tmp_path / "idx")
    assert not list((tmp_path / "idx").glob("*.tmp"))
    index2, _ = load_index(tmp_path / "idx")
    np.testing.assert_array_equal(index2.shingle_windows, index.shingle_windows)


def test_no_module_imports_orbax():
    import pathlib

    pkg = pathlib.Path(__file__).resolve().parent.parent / "fandom_search"
    for f in pkg.rglob("*.py"):
        assert "orbax" not in f.read_text(encoding="utf-8"), f


def test_resumable_runner(tmp_path, world):
    index, works, planted = world
    eng = SearchEngine(index, CFG)
    direct, _ = eng.search_works(works)

    out = tmp_path / "run"
    runner = ResumableRunner(eng, out, unit_size=3)
    rows = runner.run(works)
    assert len(rows) == len(direct)
    manifest = json.loads((out / "manifest.json").read_text())
    assert len(manifest["units"]) == 3
    assert all(u["done"] for u in manifest["units"].values())

    # resume: no engine calls should happen for complete units
    calls = []
    orig = eng.search_works
    eng.search_works = lambda w: calls.append(len(w)) or orig(w)
    runner2 = ResumableRunner(eng, out, unit_size=3)
    rows2 = runner2.run(works)
    assert calls == []
    assert len(rows2) == len(direct)

    # delete one unit -> only that unit reruns
    (out / "unit_00001.csv").unlink()
    runner3 = ResumableRunner(eng, out, unit_size=3)
    runner3.manifest["units"]["00001"]["done"] = False
    rows3 = runner3.run(works)
    assert calls == [3]
    assert len(rows3) == len(direct)


def test_resumable_runner_sharded(tmp_path, world):
    """Resume works with the sharded engine too (same API surface)."""
    import dataclasses

    import jax

    from fandom_search.config import MeshConfig
    from fandom_search.parallel.sharded import ShardedSearchEngine

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices (conftest provisions 8)")
    index, works, planted = world
    cfg = dataclasses.replace(
        PipelineConfig(mesh=MeshConfig(works=4, script=1)),
        search=dataclasses.replace(CFG.search, batch_queries=4 * 512),
    )
    eng = ShardedSearchEngine(index, cfg)
    direct, _ = eng.search_works(works)

    out = tmp_path / "run_sharded"
    runner = ResumableRunner(eng, out, unit_size=4)
    rows = runner.run(works)
    assert sorted(r.to_csv_row() for r in rows) == sorted(
        r.to_csv_row() for r in direct
    )
    summary = runner.stats_summary()
    assert summary["units"] == 3 and summary["verified"] > 0

    # resume path returns identical rows without recomputing
    runner2 = ResumableRunner(eng, out, unit_size=4)
    rows2 = runner2.run(works)
    assert sorted(r.to_csv_row() for r in rows2) == sorted(
        r.to_csv_row() for r in direct
    )


def test_resumable_runner_detects_corpus_change(tmp_path, world):
    """Adding works shifts unit membership: stale units must recompute,
    never silently skip the new works (round-2 review finding)."""
    index, works, planted = world
    eng = SearchEngine(index, CFG)
    out = tmp_path / "run_grow"
    some = dict(list(sorted(works.items()))[:6])
    ResumableRunner(eng, out, unit_size=3).run(some)

    # grow the corpus with an id that sorts INTO the first unit
    grown = dict(some)
    first_id = sorted(some)[0]
    grown["a_" + first_id] = some[first_id]
    rows = ResumableRunner(eng, out, unit_size=3).run(grown)
    direct, _ = eng.search_works(grown)
    assert sorted(r.to_csv_row() for r in rows) == sorted(
        r.to_csv_row() for r in direct
    )


def test_retry_after_http_date():
    import time as _time

    from fandom_search.scrape.ao3 import _parse_retry_after

    assert _parse_retry_after("120") == 120.0
    assert _parse_retry_after("0") == 0.0
    # HTTP-date form ~90s in the future
    from email.utils import format_datetime
    from datetime import datetime, timedelta, timezone

    future = datetime.now(timezone.utc) + timedelta(seconds=90)
    got = _parse_retry_after(format_datetime(future, usegmt=True))
    assert 80 <= got <= 95
    assert _parse_retry_after("garbage") == 60.0


def test_stage_timer():
    t = StageTimer()
    with t("a"):
        pass
    with t("a"):
        pass
    with t("b"):
        pass
    d = t.as_dict()
    assert d["a"]["calls"] == 2 and d["b"]["calls"] == 1


def test_cli_index_then_search(tmp_path):
    rng = np.random.default_rng(5)
    vocab = make_vocab(rng, 500)
    script_text = make_script(rng, vocab, num_lines=10, words_per_line=(7, 12))
    script_path = tmp_path / "script.txt"
    script_path.write_text(script_text, encoding="utf-8")
    fan_dir = tmp_path / "works"
    fan_dir.mkdir()
    quote = script_text.splitlines()[2].split(": ", 1)[1]
    noise = " ".join(vocab[i] for i in rng.integers(0, len(vocab), 80))
    (fan_dir / "w1.txt").write_text(f"{noise} {quote} {noise}", encoding="utf-8")

    cmd = [sys.executable, "-m", "fandom_search"]
    r = subprocess.run(
        cmd + ["index", str(script_path), "-o", str(tmp_path / "idx"), "--cpu"],
        capture_output=True, text=True, cwd="/root/repo",
    )
    assert r.returncode == 0, r.stderr

    r = subprocess.run(
        cmd + [
            "search", str(fan_dir), "--index", str(tmp_path / "idx"),
            "-o", str(tmp_path / "m.csv"), "--cpu",
            "--resume-dir", str(tmp_path / "units"),
        ],
        capture_output=True, text=True, cwd="/root/repo",
    )
    assert r.returncode == 0, r.stderr
    manifest = json.loads(r.stdout.strip().splitlines()[-1])
    assert manifest["matches"] >= 1
    assert (tmp_path / "units" / "manifest.json").exists()


def test_save_load_bucketed_roundtrip(tmp_path, world):
    """Persisted bucketed tables load bit-identical and attach on a
    loaded engine with identical rows."""
    from fandom_search.config import BucketedConfig
    from fandom_search.ops.bucketed import (
        BucketedIndex, attach_bucketed_prefilter,
    )
    from fandom_search.search.persist import load_bucketed, save_bucketed

    index, works, _ = world
    bcfg = BucketedConfig()
    bidx = BucketedIndex.build(index.shingle_windows, bcfg, CFG.shingle)
    save_index(index, CFG, tmp_path / "idx")
    save_bucketed(tmp_path / "idx", bidx, bcfg)

    loaded = load_bucketed(tmp_path / "idx", bcfg)
    assert loaded is not None
    np.testing.assert_array_equal(
        np.asarray(loaded.entries), np.asarray(bidx.entries)
    )
    np.testing.assert_array_equal(
        np.asarray(loaded.offsets), np.asarray(bidx.offsets)
    )
    assert loaded.salts == bidx.salts
    assert loaded.num_buckets == bidx.num_buckets

    import dataclasses as dc

    assert load_bucketed(
        tmp_path / "idx", dc.replace(bcfg, cap=16)
    ) is None

    index2, cfg2 = load_index(tmp_path / "idx")
    e_fresh = SearchEngine(index, CFG, interpret=True)
    attach_bucketed_prefilter(e_fresh, bcfg)
    e_loaded = SearchEngine(index2, cfg2, interpret=True)
    attach_bucketed_prefilter(e_loaded, bcfg, bidx=loaded)
    r1, _ = e_fresh.search_works(works)
    r2, _ = e_loaded.search_works(works)
    assert [r.to_csv_row() for r in r1] == [r.to_csv_row() for r in r2]


def test_nondefault_bucketed_config_survives_index_roundtrip(tmp_path, world):
    """An index built with a non-default BucketedConfig must hand that
    config back from load_index, so a later `search --index --bucketed`
    loads the persisted tables instead of silently rebuilding defaults
    (round-2 advisor medium: persist.py bucketed identity)."""
    import dataclasses as dc

    from fandom_search.config import BucketedConfig
    from fandom_search.ops.bucketed import BucketedIndex
    from fandom_search.search.persist import load_bucketed, save_bucketed

    index, _, _ = world
    bcfg = BucketedConfig(pairs="all", cap=16)
    cfg = dc.replace(CFG, bucketed=bcfg)
    bidx = BucketedIndex.build(index.shingle_windows, bcfg, cfg.shingle)
    save_index(index, cfg, tmp_path / "idx")
    save_bucketed(tmp_path / "idx", bidx, bcfg)

    _, cfg2 = load_index(tmp_path / "idx")
    assert cfg2.bucketed == bcfg
    # and the restored config loads the persisted tables (not None)
    assert load_bucketed(tmp_path / "idx", cfg2.bucketed) is not None


def test_cli_multiscript_index_then_search_and_matrix(tmp_path):
    """Two script files -> one persisted multi-script index -> search
    attributes rows to the right script; matrix carries the column."""
    rng = np.random.default_rng(6)
    vocab = make_vocab(rng, 600)
    paths = []
    texts = {}
    for name in ("ep1", "ep2"):
        t = make_script(rng, vocab, num_lines=8, words_per_line=(7, 12))
        p = tmp_path / f"{name}.txt"
        p.write_text(t, encoding="utf-8")
        paths.append(str(p))
        texts[name] = t
    fan_dir = tmp_path / "works"
    fan_dir.mkdir()
    noise = " ".join(vocab[i] for i in rng.integers(0, len(vocab), 60))
    q1 = texts["ep1"].splitlines()[2].split(": ", 1)[1]
    q2 = texts["ep2"].splitlines()[4].split(": ", 1)[1]
    (fan_dir / "w1.txt").write_text(f"{noise} {q1} {noise}", encoding="utf-8")
    (fan_dir / "w2.txt").write_text(f"{noise} {q2} {noise}", encoding="utf-8")

    cmd = [sys.executable, "-m", "fandom_search"]
    r = subprocess.run(
        cmd + ["index"] + paths + ["-o", str(tmp_path / "idx"), "--cpu"],
        capture_output=True, text=True, cwd="/root/repo",
    )
    assert r.returncode == 0, r.stderr
    r = subprocess.run(
        cmd + ["search", str(fan_dir), "--index", str(tmp_path / "idx"),
               "-o", str(tmp_path / "m.csv"), "--cpu"],
        capture_output=True, text=True, cwd="/root/repo",
    )
    assert r.returncode == 0, r.stderr
    with (tmp_path / "m.csv").open(newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    scripts_hit = {(r_["work_id"], r_["script"]) for r_ in rows}
    assert ("w1", "ep1") in scripts_hit
    assert ("w2", "ep2") in scripts_hit
    r = subprocess.run(
        cmd + ["matrix", str(tmp_path / "m.csv"),
               "-o", str(tmp_path / "x.csv"), "--script"] + paths,
        capture_output=True, text=True, cwd="/root/repo",
    )
    assert r.returncode == 0, r.stderr
    with (tmp_path / "x.csv").open(newline="", encoding="utf-8") as f:
        recs = list(csv.DictReader(f))
    assert {rec["script"] for rec in recs} == {"ep1", "ep2"}
    assert sum(int(rec["matches"]) for rec in recs) == len(rows)
