"""Index persistence — decouple index build from query (SURVEY.md section 6).

The reference's only checkpointing is filesystem-as-checkpoint between
pipeline stages.  Here the device-side index (script shingle embeddings,
attribution tables, optional bucketed tables) persists as NumPy ``.npz``
archives, and the host-side line records and configs as JSON
(``meta.json``), so a large corpus can be searched repeatedly without
re-parsing or re-embedding the script.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Tuple

import numpy as np

from fandom_search.config import (
    BucketedConfig,
    PipelineConfig,
    SearchConfig,
    ShingleConfig,
)
from fandom_search.data.script_parser import ScriptLine
from fandom_search.data.tokenizer import tokenize
from fandom_search.search.index import ScriptIndex

# v4: .npz arrays (v3 and older used a checkpoint library; rebuild them)
_VERSION = 4

_ARRAY_FIELDS = (
    "stream_hashes",
    "token_line",
    "shingle_line",
    "shingle_anchor",
    "shingle_windows",
    "embeddings",
    "line_start",
    "line_lengths",
)


def _save_arrays(path: Path, arrays: dict) -> None:
    """Write ``arrays`` atomically: a crash mid-write never leaves a
    truncated archive under the final name."""
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    tmp.replace(path)


def _load_arrays(path: Path) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {name: z[name] for name in z.files}


def save_index(index: ScriptIndex, cfg: PipelineConfig, path: str | Path) -> None:
    path = Path(path).resolve()
    path.mkdir(parents=True, exist_ok=True)
    _save_arrays(
        path / "arrays.npz",
        {f: np.asarray(getattr(index, f)) for f in _ARRAY_FIELDS},
    )
    meta = {
        "version": _VERSION,
        "lines": [
            {"line_no": ln.line_no, "speaker": ln.speaker, "text": ln.text,
             "script": ln.script}
            for ln in index.lines
        ],
        "shingle": dataclasses.asdict(cfg.shingle),
        "search": dataclasses.asdict(cfg.search),
        # Persisted so a `search --index idx --bucketed` run compares
        # load_bucketed's identity against the config the tables were
        # BUILT with, not the default (an `index --bucketed-pairs all`
        # index would otherwise silently rebuild default 'triangles'
        # tables, discarding the stronger guarantee the user built).
        "bucketed": dataclasses.asdict(cfg.bucketed),
    }
    (path / "meta.json").write_text(json.dumps(meta), encoding="utf-8")


def load_index(path: str | Path) -> Tuple[ScriptIndex, PipelineConfig]:
    path = Path(path).resolve()
    meta = json.loads((path / "meta.json").read_text(encoding="utf-8"))
    if meta.get("version") != _VERSION:
        raise ValueError(
            f"index at {path} is format v{meta.get('version')}; this build "
            f"reads v{_VERSION} — rebuild it with `fandomsearch index`"
        )
    arrays = _load_arrays(path / "arrays.npz")
    lines = [
        ScriptLine(d["line_no"], d["speaker"], d["text"], d.get("script", ""))
        for d in meta["lines"]
    ]
    tokenized = [tokenize(ln.text) for ln in lines]
    index = ScriptIndex(
        lines=lines,
        tokenized=tokenized,
        **{
            f: np.asarray(arrays[f])
            for f in _ARRAY_FIELDS
        },
    )
    cfg = PipelineConfig(
        shingle=ShingleConfig(**meta["shingle"]),
        search=SearchConfig(**meta["search"]),
        bucketed=BucketedConfig(**meta["bucketed"]),
    )
    return index, cfg


def _bucketed_identity(cfg) -> dict:
    """The BucketedConfig fields that determine the built tables.

    ``hybrid`` is a runtime routing choice (exact-kernel fallback for
    at-risk queries) — the same persisted tables serve both modes, so
    it must not participate in the saved-index identity."""
    d = dataclasses.asdict(cfg)
    d.pop("hybrid", None)
    return d


def save_bucketed(path: str | Path, bidx, cfg) -> None:
    """Persist a built BucketedIndex (ops/bucketed.py) next to the
    script index: loading skips the build (native counting sort) and
    keeps attach deterministic."""
    path = Path(path).resolve()
    _save_arrays(
        path / "bucketed_arrays.npz",
        {
            "entries": np.asarray(bidx.entries),
            "offsets": np.asarray(bidx.offsets),
        },
    )
    meta = {
        "num_buckets": int(bidx.num_buckets),
        "salts": list(bidx.salts),
        "ns_valid": int(bidx.ns_valid),
        "overflow_frac": float(bidx.overflow_frac),
        "bucketed": _bucketed_identity(cfg),
    }
    (path / "bucketed_meta.json").write_text(
        json.dumps(meta), encoding="utf-8"
    )


def load_bucketed(path: str | Path, cfg):
    """Load a persisted BucketedIndex; None if absent or
    config-mismatched."""
    from fandom_search.ops.bucketed import BucketedIndex

    path = Path(path).resolve()
    meta_path = path / "bucketed_meta.json"
    if not meta_path.exists():
        return None
    meta = json.loads(meta_path.read_text(encoding="utf-8"))
    saved = dict(meta.get("bucketed") or {})
    saved.pop("hybrid", None)  # saves from before the field existed
    if saved != _bucketed_identity(cfg):
        import sys

        print(
            f"warning: persisted bucketed tables at {path} were built "
            f"with {saved}, requested {_bucketed_identity(cfg)}; "
            f"rebuilding from the requested config",
            file=sys.stderr,
        )
        return None
    arrays = _load_arrays(path / "bucketed_arrays.npz")
    return BucketedIndex(
        entries=np.asarray(arrays["entries"]).astype(np.int32),
        offsets=np.asarray(arrays["offsets"]).astype(np.int32),
        num_buckets=int(meta["num_buckets"]),
        salts=tuple(int(s) for s in meta["salts"]),
        ns_valid=int(meta["ns_valid"]),
        overflow_frac=float(meta["overflow_frac"]),
    )
