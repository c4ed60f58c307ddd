"""Persistent serving mode: resident index + warm engine behind HTTP.

The reference is batch-only — one process per search run over a
directory of files (SURVEY.md §4.2's `Pool.map` driver) — so every
query pays process startup.  On an accelerator that cost is much
worse: index upload plus per-bucket jit compiles before the first row
comes back.  ``fandomsearch serve`` keeps ONE engine resident — script
embeddings in device memory, stream buckets
pre-compiled by an optional warmup — behind a localhost HTTP/JSON API,
so an interactive client (e.g. a Fan Engagement Meter backend) gets
per-request wall-clock equal to just the search itself.

Endpoints (JSON over HTTP/1.1):

  GET  /health  -> {"status": "ok", index/device facts}
  GET  /stats   -> cumulative counters since startup
  POST /search  -> {"works": {id: text, ...}}  or  {"text": "..."}
                   (single anonymous work, id "query");
                   optional "include_stats": true
                -> {"matches": [MatchRow dicts], "works": N, ...}

Concurrency: stdlib ThreadingHTTPServer (thread per connection), with
every engine call serialized behind a lock — the engine pipelines its
own device work internally, and interleaving two engines' dispatches
on one device corrupts both.  Binds 127.0.0.1 by
default; this is an app-backend socket, not an internet face.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Tuple

from fandom_search.search.types import MatchRow

log = logging.getLogger(__name__)

_MAX_BODY = 512 << 20  # refuse absurd request bodies (512 MB)


class SearchService:
    """Resident engine + counters; the object the HTTP layer fronts."""

    def __init__(self, engine, index, cfg) -> None:
        self.engine = engine
        self.index = index
        self.cfg = cfg
        self._lock = threading.Lock()
        # counters get read-modify-written from every handler thread
        # (ThreadingHTTPServer is thread-per-connection) AFTER the
        # engine lock is released, so they need their own lock
        self._stats_lock = threading.Lock()
        self._t0 = time.time()
        self.counters = {
            "requests": 0, "works": 0, "query_shingles": 0,
            "matches": 0, "search_seconds": 0.0, "queue_seconds": 0.0,
            "errors": 0,
        }

    def bump(self, **deltas) -> None:
        with self._stats_lock:
            for key, d in deltas.items():
                self.counters[key] += d

    def warm(self) -> float:
        """Compile the smallest stream bucket before the first request
        by searching one tiny synthetic work; returns seconds spent.

        Deliberately nonsense words: compilation depends only on the
        bucket shape, and script text here would flood the candidate
        stage and sticky-bump the engine's budgets (observed: a
        3-line warm text tripped a 32k-candidate retry, doubling both
        warm compiles and every later batch's pull size)."""
        t0 = time.perf_counter()
        text = " ".join(f"warmup{i}" for i in range(64))
        with self._lock:
            self.engine.search_works({"__warm__": text})
        return time.perf_counter() - t0

    def search(self, works: Dict[str, str]) -> Tuple[list, dict]:
        # Queue wait measured separately from engine time: requests
        # serialize behind one engine lock (one chip — see module doc),
        # so under concurrent clients latency is queue + search; the
        # response meta exposes both so a client can tell a slow engine
        # from a deep queue (SURVEY §6 observability).
        t_q = time.perf_counter()
        with self._lock:
            queued = time.perf_counter() - t_q
            t0 = time.perf_counter()
            rows, stats = self.engine.search_works(works)
            dt = time.perf_counter() - t0
        self.bump(
            requests=1,
            works=len(works),
            query_shingles=stats.num_query_shingles,
            matches=len(rows),
            search_seconds=dt,
            queue_seconds=queued,
        )
        meta = {
            "works": len(works),
            "num_matches": len(rows),
            "query_shingles": stats.num_query_shingles,
            "seconds": round(dt, 4),
            "queue_seconds": round(queued, 4),
        }
        if stats.extra:
            # per-run engine observability (stage timings; the hybrid
            # bucketed prefilter's reroute fraction when attached)
            meta["engine_extra"] = {
                k: round(float(v), 6) for k, v in stats.extra.items()
            }
        return rows, meta

    def health(self) -> dict:
        import jax

        dev = jax.devices()[0]
        return {
            "status": "ok",
            "script_lines": len(self.index.lines),
            "script_shingles": self.index.num_shingles,
            "device": f"{dev.platform}:{dev.device_kind}",
            "uptime_seconds": round(time.time() - self._t0, 1),
        }

    def stats(self) -> dict:
        with self._stats_lock:
            out = dict(self.counters)
        out["uptime_seconds"] = round(time.time() - self._t0, 1)
        out["search_seconds"] = round(out["search_seconds"], 3)
        out["queue_seconds"] = round(out["queue_seconds"], 3)
        return out


def _rows_json(rows) -> list:
    return [dict(zip(MatchRow.CSV_FIELDS, r.to_csv_row())) for r in rows]


def make_handler(service: SearchService):
    class Handler(BaseHTTPRequestHandler):
        # keep request logging on our logger, not stderr
        def log_message(self, fmt, *args):  # noqa: N802
            log.debug("%s - %s", self.address_string(), fmt % args)

        def _reply(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path == "/health":
                self._reply(200, service.health())
            elif self.path == "/stats":
                self._reply(200, service.stats())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/search":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if not 0 < length <= _MAX_BODY:
                    self._reply(413, {"error": "bad Content-Length"})
                    return
                req = json.loads(self.rfile.read(length))
                if not isinstance(req, dict):
                    self._reply(400, {"error": "body must be a JSON object"})
                    return
                works = req.get("works")
                if works is None and "text" in req:
                    works = {"query": req["text"]}
                if (
                    not isinstance(works, dict) or not works
                    or not all(
                        isinstance(k, str) and isinstance(v, str)
                        for k, v in works.items()
                    )
                ):
                    self._reply(400, {
                        "error": 'body must carry {"works": {id: text}} '
                                 'or {"text": "..."}'
                    })
                    return
            except (ValueError, json.JSONDecodeError) as e:
                self._reply(400, {"error": f"bad request: {e}"})
                return
            try:
                rows, summary = service.search(works)
            except Exception as e:  # engine failure must not kill serving
                service.bump(errors=1)
                log.exception("search request failed")
                self._reply(500, {"error": f"search failed: {e}"})
                return
            out = {"matches": _rows_json(rows), **summary}
            if req.get("include_stats"):
                out["server_stats"] = service.stats()
            self._reply(200, out)

    return Handler


def make_server(
    service: SearchService, host: str = "127.0.0.1", port: int = 8765
) -> ThreadingHTTPServer:
    """Bound, ready server — caller runs ``serve_forever()`` (the CLI)
    or drives it from a thread (tests)."""
    return ThreadingHTTPServer((host, port), make_handler(service))
