"""Reporting + aggregation — reference layer L5 (SURVEY.md section 2).

Match rows go to CSV with the reference's row semantics (fanwork id,
fan span, script line no, speaker, matched text, scores); the
``matrix`` aggregation reduces matches to per-script-line engagement
counts for the downstream visualization (SURVEY.md section 4.3).  Parquet is
offered as an option for large corpora (columnar, compressed).
"""

from __future__ import annotations

import csv
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

from fandom_search.data.script_parser import ScriptLine
from fandom_search.search.types import MatchRow


def write_matches_csv(rows: Sequence[MatchRow], path: str | Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(MatchRow.CSV_FIELDS)
        for r in rows:
            w.writerow(r.to_csv_row())


def write_matches_parquet(rows: Sequence[MatchRow], path: str | Path) -> None:
    import pandas as pd

    df = pd.DataFrame([r.to_csv_row() for r in rows], columns=MatchRow.CSV_FIELDS)
    df.to_parquet(path)


def read_matches_csv(path: str | Path) -> List[dict]:
    with Path(path).open(newline="", encoding="utf-8") as f:
        return list(csv.DictReader(f))


def aggregate_matrix(
    match_rows: Iterable[dict] | Sequence[MatchRow],
    script_lines: Sequence[ScriptLine] | None = None,
) -> List[dict]:
    """Per-script-line engagement counts (reference `matrix` subcommand).

    Returns one record per script line: line_no, speaker, text (when the
    script is provided), match count, distinct-work count.
    """
    counts: Counter = Counter()
    works: Dict[int, set] = {}
    scripts: Dict[int, str] = {}
    for r in match_rows:
        if isinstance(r, MatchRow):
            line_no, wid, script = r.line_no, r.work_id, r.script
        else:
            line_no, wid = int(r["line_no"]), r["work_id"]
            script = r.get("script", "")
        counts[line_no] += 1
        works.setdefault(line_no, set()).add(wid)
        if script:
            scripts[line_no] = script

    line_range = (
        range(len(script_lines))
        if script_lines is not None
        else sorted(counts)
    )
    # line_no is globally unique even in a multi-script index
    # (concat_indexes renumbers), so grouping stays per line; the
    # script column rides along when any row carries one.
    multi = bool(scripts) or (
        script_lines is not None and any(ln.script for ln in script_lines)
    )
    out = []
    for ln in line_range:
        rec = {
            "line_no": ln,
            "matches": counts.get(ln, 0),
            "distinct_works": len(works.get(ln, ())),
        }
        if multi:
            # Prefer the provided script_lines' label, but fall back to
            # the label the match rows carry: `matrix --script one.txt`
            # against a multi-script matches.csv must not blank the
            # rows' attribution (advisor r2 low: report.py:85).
            rec["script"] = (
                script_lines[ln].script
                if script_lines is not None and script_lines[ln].script
                else scripts.get(ln, "")
            )
        if script_lines is not None:
            rec["speaker"] = script_lines[ln].speaker
            rec["text"] = script_lines[ln].text
        out.append(rec)
    return out


def write_matrix_csv(records: List[dict], path: str | Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if not records:
        path.write_text("line_no,matches,distinct_works\n", encoding="utf-8")
        return
    with path.open("w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=list(records[0].keys()))
        w.writeheader()
        w.writerows(records)
