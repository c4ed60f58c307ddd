"""Serve mode: HTTP/JSON front over a resident engine (search/server.py).

Runs entirely on the CPU backend (conftest) with a threaded server on
an ephemeral localhost port — the same code path `fandomsearch serve`
drives, minus argparse.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from fandom_search.config import PipelineConfig
from fandom_search.data.script_parser import parse_script
from fandom_search.search.engine import SearchEngine
from fandom_search.search.index import build_script_index
from fandom_search.search.server import SearchService, make_server
from fandom_search.utils.synthetic import (
    make_corpus_with_quotes,
    make_script,
    make_vocab,
)


@pytest.fixture(scope="module")
def served():
    cfg = PipelineConfig()
    rng = np.random.default_rng(31)
    vocab = make_vocab(rng, 1200)
    script_text = make_script(rng, vocab, num_lines=20, words_per_line=(7, 12))
    lines = parse_script(script_text)
    index = build_script_index(lines, cfg.shingle, cfg.search)
    works, planted = make_corpus_with_quotes(
        rng, [ln.text for ln in lines], num_works=6, words_per_work=300,
        quotes_per_work=2, num_edits=0, vocab=vocab,
    )
    engine = SearchEngine(index, cfg)
    service = SearchService(engine, index, cfg)
    service.warm()
    srv = make_server(service, "127.0.0.1", 0)  # ephemeral port
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    yield base, service, engine, works, planted
    srv.shutdown()
    srv.server_close()
    t.join(timeout=5)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, obj):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_health(served):
    base, service, _, _, _ = served
    code, h = _get(base + "/health")
    assert code == 200 and h["status"] == "ok"
    assert h["script_shingles"] == service.index.num_shingles
    assert h["script_lines"] == len(service.index.lines)


def test_search_matches_direct_engine(served):
    base, _, engine, works, planted = served
    code, out = _post(base + "/search", {"works": works})
    assert code == 200
    assert out["works"] == len(works)
    direct, _ = engine.search_works(works)
    key = lambda d: (d["work_id"], d["fan_token_start"],
                     d["fan_token_end"], d["line_no"])
    got = sorted(key(m) for m in out["matches"])
    want = sorted(
        (r.work_id, r.fan_token_start, r.fan_token_end, r.line_no)
        for r in direct
    )
    assert got == want and got
    found = {(m["work_id"], m["line_no"]) for m in out["matches"]}
    assert all((p.work_id, p.line_no) in found for p in planted)


def test_single_text_and_stats(served):
    base, _, _, works, _ = served
    some_text = next(iter(works.values()))
    code, out = _post(
        base + "/search", {"text": some_text, "include_stats": True}
    )
    assert code == 200
    assert all(m["work_id"] == "query" for m in out["matches"])
    assert out["matches"]  # the work carries planted quotes
    assert out["server_stats"]["requests"] >= 1
    code, st = _get(base + "/stats")
    assert code == 200 and st["matches"] > 0 and st["errors"] == 0


def test_bad_requests(served):
    base = served[0]
    for body in ({}, {"works": {}}, {"works": {"a": 3}}, {"works": "x"}):
        code, out = _post(base + "/search", body)
        assert code == 400 and "error" in out
    code, out = _get(base + "/nope")
    assert code == 404


def test_unknown_post_path_and_raw_garbage(served):
    base = served[0]
    code, out = _post(base + "/elsewhere", {"works": {"a": "b"}})
    assert code == 404
    req = urllib.request.Request(
        base + "/search", data=b"not json", method="POST"
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            code = r.status
    except urllib.error.HTTPError as e:
        code = e.code
    assert code == 400


def test_concurrent_requests_consistent_counters(served):
    """Parallel clients: every request answers and the stats counters
    (read-modify-written outside the engine lock) lose no updates."""
    base, service, engine, works, _ = served
    with service._stats_lock:
        before = dict(service.counters)
    wid = sorted(works)[0]
    n_threads, per_thread = 6, 3
    errors = []

    def client():
        for _ in range(per_thread):
            code, body = _post(base + "/search", {"works": {wid: works[wid]}})
            if code != 200:
                errors.append((code, body))

    threads = [threading.Thread(target=client) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors
    stats = _get(base + "/stats")[1]
    n = n_threads * per_thread
    assert stats["requests"] == before["requests"] + n
    assert stats["works"] == before["works"] + n
    assert stats["errors"] == before["errors"]


def test_queue_seconds_reported_and_grows_under_contention(served):
    """Requests serialize behind the engine lock; the response meta
    must expose the lock wait (queue_seconds) so clients can tell a
    deep queue from a slow engine (round-2 verdict Weak #7)."""
    base, service, _, works, _ = served
    # uncontended: the field exists and is ~zero
    wid = sorted(works)[0]
    code, solo = _post(base + "/search", {"works": {wid: works[wid]}})
    assert code == 200
    assert "queue_seconds" in solo and solo["queue_seconds"] >= 0.0

    # contended: fire clients in parallel; all but the first must
    # queue, so the max observed queue_seconds exceeds the solo one
    # and the queue sum is a significant fraction of the search sum
    n_threads = 5
    metas = []
    lock = threading.Lock()

    def client():
        code, body = _post(base + "/search", {"works": {wid: works[wid]}})
        if code == 200:
            with lock:
                metas.append(body)

    threads = [threading.Thread(target=client) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert len(metas) == n_threads
    queues = sorted(m["queue_seconds"] for m in metas)
    searches = [m["seconds"] for m in metas]
    # the deepest-queued request waited at least ~the earlier searches
    assert queues[-1] > max(min(searches) * 0.5, solo["queue_seconds"])
    # cumulative counter moved too
    stats = _get(base + "/stats")[1]
    assert stats["queue_seconds"] >= queues[-1] * 0.9
