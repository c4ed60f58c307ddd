"""Reference-style CPU pipeline: sklearn BallTree + python-Levenshtein.

This is a faithful emulation of the reference's own stack (SURVEY.md
section 4.2): per fanwork, shingle into word-hash vectors, query a
BallTree built over the script's shingle matrix for near neighbors,
verify candidates with python-Levenshtein's C ratio on the text, and
chain hits into spans.  Two roles:

  1. the honest "CPU pipeline" wall-clock baseline for the
     >= 100x target of BASELINE.json:5 — this is what the reference
     actually runs, measured on this machine;
  2. a behavioral-parity mode (``fandomsearch search --reference``) so
     a reference user can reproduce reference-flavored results from
     the same CLI.

Differences from the NumPy oracle (search/oracle.py): the oracle is the
bit-exact golden twin of the device kernels (same embeddings, same SW
verifier); this module reproduces the REFERENCE's method — coordinates
are small per-word hashes (so BallTree distance counts word mismatches)
and verification is Levenshtein ratio on strings, with its own
threshold scale.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from fandom_search.config import PipelineConfig
from fandom_search.data.script_parser import ScriptLine
from fandom_search.data.tokenizer import Tokenized, tokenize
from fandom_search.search.chain import chain_hits
from fandom_search.search.common import verify_window
from fandom_search.search.index import ScriptIndex, build_script_index
from fandom_search.search.types import CandidateHit, MatchRow

# Per-word coordinate range.  The reference maps words to numeric
# hashes so a shingle is a point in metric space; small coordinates
# keep euclidean distance ~ "number of differing words" (any mismatch
# contributes an O(range) offset in its coordinate).
_COORD_MOD = 1009  # prime, ~2^10


@dataclass
class ReferenceStats:
    num_works: int = 0
    num_query_shingles: int = 0
    num_candidates: int = 0
    num_verified: int = 0
    seconds_query: float = 0.0
    seconds_verify: float = 0.0
    extra: Dict[str, float] = field(default_factory=dict)


def _points(hashes: np.ndarray, n: int) -> np.ndarray:
    """uint32[T] -> float64 [T-n+1, n] shingle points, reference-style."""
    if hashes.shape[0] < n:
        return np.zeros((0, n), dtype=np.float64)
    w = np.lib.stride_tricks.sliding_window_view(hashes, n)
    return (w % _COORD_MOD).astype(np.float64)


class ReferenceSearch:
    """BallTree-over-script index + Levenshtein verification."""

    def __init__(self, lines: List[ScriptLine], cfg: PipelineConfig):
        from sklearn.neighbors import BallTree

        self.cfg = cfg
        self.index: ScriptIndex = build_script_index(
            lines, cfg.shingle, cfg.search
        )
        pts = _points(self.index.stream_hashes, cfg.shingle.n)
        self._tree = BallTree(pts) if len(pts) else None
        # distance 0 == identical shingle; anything sharing < n words
        # lands O(_COORD_MOD) away.  Radius ~= one differing word.
        self.radius = float(_COORD_MOD)
        self.lev_threshold = 0.5

    def search_works(
        self, works: Dict[str, str] | Dict[str, Tokenized]
    ) -> Tuple[List[MatchRow], ReferenceStats]:
        import Levenshtein

        cfg = self.cfg
        stats = ReferenceStats()
        stats.extra["ns"] = float(self.index.num_shingles)
        tokenized = {
            wid: (t if isinstance(t, Tokenized) else tokenize(t))
            for wid, t in works.items()
        }
        stats.num_works = len(tokenized)
        hits: List[CandidateHit] = []
        if self._tree is None:
            return [], stats

        k = cfg.search.k
        for wid, tk in sorted(tokenized.items()):
            pts = _points(tk.hashes, cfg.shingle.n)
            if len(pts) == 0:
                continue
            stats.num_query_shingles += len(pts)

            t0 = time.perf_counter()
            dist, idx = self._tree.query(pts, k=min(k, self.index.num_shingles))
            stats.seconds_query += time.perf_counter() - t0

            t0 = time.perf_counter()
            cand_q, cand_k = np.nonzero(dist <= self.radius)
            seen: Dict[Tuple[int, int], float] = {}
            for qi, kj in zip(cand_q, cand_k):
                line = int(self.index.shingle_line[idx[qi, kj]])
                key = (int(qi), line)
                d = float(dist[qi, kj])
                if key not in seen or d < seen[key]:
                    seen[key] = d
            stats.num_candidates += len(seen)

            for (fan_pos, line), d in seen.items():
                a0, a1 = verify_window(fan_pos, len(tk), cfg.shingle, cfg.search)
                window_text = tk.span_text(a0, a1)
                ratio = Levenshtein.ratio(
                    window_text, self.index.line_text(line)
                )
                # partial_ratio-style: also try the tight span around
                # the matched shingle (the reference verifies matched
                # text against the line, not a wide window)
                tight = tk.span_text(
                    fan_pos, min(len(tk), fan_pos + cfg.shingle.n)
                )
                ratio = max(
                    ratio, Levenshtein.ratio(tight, self.index.line_text(line))
                )
                if ratio >= self.lev_threshold:
                    stats.num_verified += 1
                    hits.append(
                        CandidateHit(wid, int(fan_pos), line,
                                     float(-d), float(ratio))
                    )
            stats.seconds_verify += time.perf_counter() - t0

        rows = chain_hits(hits, tokenized, self.index, cfg.shingle, cfg.search)
        return rows, stats
