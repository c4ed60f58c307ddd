"""Resumable corpus runs — work-unit manifest (SURVEY.md section 6).

The reference's matching step has no failure recovery: a crash reruns
everything.  Here a big corpus run is split into work units (chunks of
works); each unit's match rows are written atomically to its own CSV,
and a manifest records completion.  Re-running the same command resumes
from the missing units only.  The per-unit CSVs concatenate into the
standard match CSV (identical schema).
"""

from __future__ import annotations

import csv
import json
import logging
import time
from pathlib import Path
from typing import Dict, List, Sequence

from fandom_search.search.report import write_matches_csv
from fandom_search.search.types import MatchRow

log = logging.getLogger(__name__)


class ResumableRunner:
    def __init__(self, engine, out_dir: str | Path, unit_size: int = 256):
        self.engine = engine
        self.out_dir = Path(out_dir)
        self.unit_size = unit_size
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.manifest_path = self.out_dir / "manifest.json"
        self.manifest: Dict = {"units": {}, "unit_size": unit_size}
        if self.manifest_path.exists():
            prev = json.loads(self.manifest_path.read_text(encoding="utf-8"))
            if prev.get("unit_size") == unit_size:
                self.manifest = prev
            else:
                log.warning("unit_size changed; restarting run from scratch")

    def _unit_path(self, unit_id: str) -> Path:
        return self.out_dir / f"unit_{unit_id}.csv"

    def run(self, works: Dict[str, str]) -> List[MatchRow]:
        """Search all works, resuming complete units. Returns all rows."""
        wids = sorted(works)
        units = [
            wids[i : i + self.unit_size]
            for i in range(0, len(wids), self.unit_size)
        ]
        all_rows: List[MatchRow] = []
        for i, unit in enumerate(units):
            unit_id = f"{i:05d}"
            rec = self.manifest["units"].get(unit_id)
            # A unit only resumes if it covered EXACTLY these work ids:
            # unit membership is positional over sorted(works), so a
            # grown/shrunk corpus shifts boundaries and stale unit CSVs
            # would silently miss new works / duplicate shifted ones.
            ids_hash = _ids_hash(unit)
            if (
                rec
                and rec.get("done")
                and rec.get("ids_hash") == ids_hash
                and self._unit_path(unit_id).exists()
            ):
                log.info("unit %s already complete; skipping", unit_id)
                all_rows.extend(_read_unit(self._unit_path(unit_id)))
                continue
            if rec and rec.get("done") and rec.get("ids_hash") != ids_hash:
                log.info(
                    "unit %s membership changed (corpus grew or shrank); "
                    "recomputing", unit_id,
                )
            t0 = time.perf_counter()
            rows, stats = self.engine.search_works(
                {w: works[w] for w in unit}
            )
            tmp = self._unit_path(unit_id).with_suffix(".csv.tmp")
            write_matches_csv(rows, tmp)
            tmp.rename(self._unit_path(unit_id))  # atomic completion
            self.manifest["units"][unit_id] = {
                "done": True,
                "ids_hash": ids_hash,
                "works": len(unit),
                "rows": len(rows),
                "seconds": round(time.perf_counter() - t0, 3),
                "query_shingles": stats.num_query_shingles,
                "candidates": stats.num_candidates,
                "verified": stats.num_verified,
                "seconds_device_topk": round(stats.seconds_device_topk, 3),
                "seconds_device_verify": round(stats.seconds_device_verify, 3),
                "seconds_host": round(stats.seconds_host, 3),
            }
            self._write_manifest()
            all_rows.extend(rows)
        return all_rows

    def stats_summary(self) -> Dict:
        """Aggregate per-unit stats (including units resumed from disk)."""
        units = self.manifest["units"]
        total = {"resumable": True, "units": len(units)}
        for key in (
            "works", "rows", "seconds", "query_shingles", "candidates",
            "verified", "seconds_device_topk", "seconds_device_verify",
            "seconds_host",
        ):
            total[key] = round(
                sum(u.get(key, 0) for u in units.values()), 3
            )
        return total

    def _write_manifest(self) -> None:
        tmp = self.manifest_path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(self.manifest, indent=1), encoding="utf-8")
        tmp.rename(self.manifest_path)


def _ids_hash(unit: Sequence[str]) -> str:
    import hashlib

    return hashlib.sha1("\x00".join(unit).encode("utf-8")).hexdigest()[:16]


def _read_unit(path: Path) -> List[MatchRow]:
    rows = []
    with path.open(newline="", encoding="utf-8") as f:
        for d in csv.DictReader(f):
            rows.append(
                MatchRow(
                    work_id=d["work_id"],
                    fan_token_start=int(d["fan_token_start"]),
                    fan_token_end=int(d["fan_token_end"]),
                    fan_char_start=int(d["fan_char_start"]),
                    fan_char_end=int(d["fan_char_end"]),
                    fan_text=d["fan_text"],
                    line_no=int(d["line_no"]),
                    speaker=d["speaker"],
                    script_text=d["script_text"],
                    score=float(d["score"]),
                    verify_score=float(d["verify_score"]),
                    num_shingles=int(d["num_shingles"]),
                    script=d.get("script", ""),
                )
            )
    return rows
