import csv
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

from fandom_search.search.report import (
    aggregate_matrix,
    read_matches_csv,
    write_matches_csv,
    write_matrix_csv,
)
from fandom_search.search.types import MatchRow
from fandom_search.utils.synthetic import make_script, make_vocab


def _row(wid, line, start=0):
    return MatchRow(
        work_id=wid, fan_token_start=start, fan_token_end=start + 6,
        fan_char_start=0, fan_char_end=30, fan_text="some text",
        line_no=line, speaker="ALICE", script_text="script line",
        score=5.5, verify_score=1.0, num_shingles=3,
    )


def test_csv_roundtrip(tmp_path):
    rows = [_row("w1", 0), _row("w2", 1, start=10)]
    p = tmp_path / "m.csv"
    write_matches_csv(rows, p)
    back = read_matches_csv(p)
    assert len(back) == 2
    assert back[0]["work_id"] == "w1"
    assert back[1]["line_no"] == "1"
    assert back[0]["verify_score"] == "1.0"


def test_aggregate_matrix():
    rows = [_row("w1", 0), _row("w2", 0), _row("w1", 2), _row("w1", 0, 50)]
    recs = aggregate_matrix(rows)
    by_line = {r["line_no"]: r for r in recs}
    assert by_line[0]["matches"] == 3
    assert by_line[0]["distinct_works"] == 2
    assert by_line[2]["matches"] == 1


def test_matrix_csv(tmp_path):
    recs = aggregate_matrix([_row("w1", 0)])
    p = tmp_path / "matrix.csv"
    write_matrix_csv(recs, p)
    with p.open() as f:
        rows = list(csv.DictReader(f))
    assert rows[0]["matches"] == "1"


def test_cli_end_to_end(tmp_path):
    """format -> search -> matrix through the real CLI (CPU backend)."""
    rng = np.random.default_rng(5)
    vocab = make_vocab(rng, 800)
    script_text = make_script(rng, vocab, num_lines=12, words_per_line=(7, 12))
    script_path = tmp_path / "script.txt"
    script_path.write_text(script_text, encoding="utf-8")

    fan_dir = tmp_path / "works"
    fan_dir.mkdir()
    quote = script_text.splitlines()[3].split(": ", 1)[1]
    noise = " ".join(vocab[i] for i in rng.integers(0, len(vocab), 120))
    (fan_dir / "w1.txt").write_text(f"{noise} {quote} {noise}", encoding="utf-8")
    (fan_dir / "w2.txt").write_text(noise, encoding="utf-8")

    env_cmd = [sys.executable, "-m", "fandom_search"]

    out_fmt = tmp_path / "script.csv"
    r = subprocess.run(
        env_cmd + ["format", str(script_path), "-o", str(out_fmt)],
        capture_output=True, text=True, cwd="/root/repo",
    )
    assert r.returncode == 0, r.stderr
    assert out_fmt.exists()

    out_csv = tmp_path / "matches.csv"
    r = subprocess.run(
        env_cmd + [
            "search", str(fan_dir), str(script_path),
            "-o", str(out_csv), "--cpu",
        ],
        capture_output=True, text=True, cwd="/root/repo",
    )
    assert r.returncode == 0, r.stderr
    manifest = json.loads(r.stdout.strip().splitlines()[-1])
    assert manifest["works"] == 2
    assert manifest["matches"] >= 1

    rows = read_matches_csv(out_csv)
    assert any(r_["line_no"] == "3" and r_["work_id"] == "w1" for r_ in rows)

    out_matrix = tmp_path / "matrix.csv"
    out_html = tmp_path / "engagement.html"
    r = subprocess.run(
        env_cmd + [
            "matrix", str(out_csv), "-o", str(out_matrix),
            "--script", str(script_path), "--html", str(out_html),
        ],
        capture_output=True, text=True, cwd="/root/repo",
    )
    assert r.returncode == 0, r.stderr
    with out_matrix.open() as f:
        recs = {int(x["line_no"]): x for x in csv.DictReader(f)}
    assert int(recs[3]["matches"]) >= 1
    assert recs[3]["speaker"] != ""

    page = out_html.read_text(encoding="utf-8")
    assert "<!DOCTYPE html>" in page and "Total matches" in page
    # the quoted line's text appears in the table, and its row carries
    # the same count the CSV reports
    assert quote.split()[0] in page
    assert f'data-m="{recs[3]["matches"]}"' in page


def test_engagement_html_rendering():
    from fandom_search.search.heatmap import render_engagement_html

    recs = [
        {"line_no": 0, "matches": 4, "distinct_works": 2,
         "speaker": "A", "text": "plain line", "script": "ep1"},
        {"line_no": 1, "matches": 0, "distinct_works": 0,
         "speaker": "B", "text": "<script>alert(1)</script>",
         "script": "ep2"},
    ]
    page = render_engagement_html(recs, title="T & co")
    # escaping: hostile text and title never reach the DOM unescaped
    assert "<script>alert" not in page
    assert "&lt;script&gt;alert(1)&lt;/script&gt;" in page
    assert "T &amp; co" in page
    # multi-script records group into named sections + a Scripts tile
    assert page.count('class="sect"') == 2 and "ep1" in page and "ep2" in page
    assert "Scripts" in page
    # peak row gets the full-width bar; zero rows an empty one
    assert 'style="width:100.00%"' in page
    assert 'class="bar zero"' in page
    # single-script records: no section headers, no Scripts tile
    solo = render_engagement_html([{**recs[0], "script": ""}])
    assert 'class="sect"' not in solo and "Scripts" not in solo


def test_cli_clean_and_getmeta(tmp_path):
    """clean + getmeta verbs through the real CLI on fixture HTML."""
    from tests.fixtures import work_page

    raw = tmp_path / "raw"
    raw.mkdir()
    (raw / "111.html").write_text(
        work_page("111", "First", "alice", ["hello world " * 20]),
        encoding="utf-8",
    )
    (raw / "222.html").write_text(
        work_page("222", "Second", "bob", ["more text here " * 15]),
        encoding="utf-8",
    )
    (raw / "333.html").write_text("<html><body>error page</body></html>",
                                  encoding="utf-8")

    env_cmd = [sys.executable, "-m", "fandom_search"]
    corpus = tmp_path / "corpus"
    r = subprocess.run(
        env_cmd + ["clean", str(raw), "-o", str(corpus)],
        capture_output=True, text=True, cwd="/root/repo",
    )
    assert r.returncode == 0, r.stderr
    kept = sorted(p.stem for p in corpus.glob("*.txt"))
    assert kept == ["111", "222"]  # broken page dropped
    assert "hello world" in (corpus / "111.txt").read_text()
    assert "Summary text to strip" not in (corpus / "111.txt").read_text()

    meta_csv = tmp_path / "meta.csv"
    r = subprocess.run(
        env_cmd + ["getmeta", str(raw), "-o", str(meta_csv)],
        capture_output=True, text=True, cwd="/root/repo",
    )
    assert r.returncode == 0, r.stderr
    recs = {m["work_id"]: m for m in csv.DictReader(meta_csv.open())}
    assert set(recs) == {"111", "222"}
    assert recs["111"]["author"] == "alice"
    assert recs["222"]["title"] == "Second"
    assert recs["111"]["kudos"] == "42"


def test_parquet_round_trip(tmp_path):
    import pandas as pd

    from fandom_search.search.report import write_matches_parquet

    rows = [_row("w1", 0), _row("w2", 1, start=10)]
    p = tmp_path / "m.parquet"
    write_matches_parquet(rows, p)
    df = pd.read_parquet(p)
    assert len(df) == len(rows)
    assert df["work_id"].tolist() == [r.work_id for r in rows]
    assert df["verify_score"].tolist() == [r.verify_score for r in rows]
