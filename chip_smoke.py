#!/usr/bin/env python
"""Prove the search system runs on one NVIDIA GPU, end to end.

    python chip_smoke.py              # phases 0-3, one card
    python chip_smoke.py --cards 4    # phase 4 only, four cards

Phases (any failure exits non-zero):

  0. device — the platform must be "gpu"; prints the card's name and
     power limit (nvidia-smi), the JAX version and the device kind;
  1. kernels at real widths, each against its plain reference, exact:
     the card-only tests (tests/test_gpu_kernels.py), then top-k for
     2^20 corpus queries against a 16,384-shingle script (min_keep at
     the candidate threshold and -inf), Smith-Waterman on 16,384 pairs
     of 64x64 (engine-like length-sorted and full-length), and the
     shingle embedding bit-exact against the host oracle; kernel and
     plain times, and the fused batch's compiled memory analysis;
  2. end to end through the CLI (`search`, `matrix`, `search
     --bucketed`) on a ~1,700-line script and 2,000 works of 2,000
     words with 3 planted quotes each: rows of a 50-work sample equal
     the NumPy oracle's, every plant is recovered, bucketed rows equal
     exact rows;
  3. `serve` — /health reports the GPU; three POST /search answers
     equal the batch rows for their works;
  4. (--cards 4) ShardedSearchEngine on 4x1 and 2x2 meshes and the
     sharded bucketed hybrid: rows equal the one-card rows.

Everything runs in this one process (one process per card).  The last
line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Data is generated from --seed; weights do not exist (the "model" is
the search pipeline).
"""

from __future__ import annotations

import argparse
import csv
import json
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# sizes: the engine's real widths (a full 2^20-query batch, a
# screenplay-sized script, a verify batch the size the engine budgets)
NQ = 1 << 20
NS = 16384
SW_PAIRS = 16384
SCRIPT_LINES = 1750      # ~16.6k shingles at 6-13 words per line
WORKS, WORDS = 2000, 2000
CARDS4_WORKS = 300


def say(*a):
    print(*a, flush=True)


def best_time(fn, reps=3):
    """Best wall seconds of ``reps`` calls after one warm-up call; every
    call ends in block_until_ready."""
    import jax

    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def make_world(seed: int, num_lines: int, num_works: int, words: int):
    from fandom_search.utils.synthetic import (
        make_corpus_with_quotes, make_script, make_vocab,
    )
    from fandom_search.data.script_parser import parse_script

    rng = np.random.default_rng(seed)
    vocab = make_vocab(rng, 5000)
    script = make_script(rng, vocab, num_lines=num_lines,
                         words_per_line=(6, 14))
    lines = parse_script(script)
    works, planted = make_corpus_with_quotes(
        rng, [ln.text for ln in lines], num_works=num_works,
        words_per_work=words, quotes_per_work=3, vocab=vocab,
    )
    return script, lines, works, planted


def row_key(r):
    if isinstance(r, dict):
        return (r["work_id"], int(r["fan_token_start"]),
                int(r["fan_token_end"]), int(r["line_no"]))
    return (r.work_id, r.fan_token_start, r.fan_token_end, r.line_no)


def read_rows(path):
    with open(path, newline="", encoding="utf-8") as f:
        return list(csv.DictReader(f))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase0_device():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"error: no GPU (JAX platform {devs[0].platform!r}); "
            "chip_smoke.py runs on an NVIDIA GPU only"
        )
    # the card's name and power limit, one line per card, as nvidia-smi
    # prints them (a card may be capped below its maximum power)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    for line in card or ["nvidia-smi gave nothing"]:
        say(line)
    say(f"jax {jax.__version__}; device_kind {devs[0].device_kind}; "
        f"{len(devs)} device(s)")
    return devs


def phase1_kernels(lines, works):
    import jax
    import jax.numpy as jnp
    import pytest

    from fandom_search.config import PipelineConfig
    from fandom_search.data.fast_tokenizer import tokenize_many
    from fandom_search.data.shingler import embed_shingles, embed_shingles_np
    from fandom_search.ops.distance_topk import topk_dot
    from fandom_search.ops.smith_waterman import (
        sw_normalized_jnp, sw_normalized_triton,
    )
    from fandom_search.search.engine import SearchEngine, _fused_jit
    from fandom_search.search.index import build_script_index

    rc = pytest.main([
        "-q", "-p", "no:cacheprovider", "--noconftest", "-m", "gpu",
        "-o", "addopts=", str(REPO / "tests" / "test_gpu_kernels.py"),
    ])
    if rc != 0:
        raise SystemExit(f"error: card-only kernel tests failed (rc={rc})")
    say("card-only kernel tests: passed")

    cfg = PipelineConfig()
    scfg, xcfg = cfg.shingle, cfg.search
    k, dim, n = xcfg.k, scfg.dim, scfg.n
    index = build_script_index(lines, scfg, xcfg)
    ns = NS
    if index.num_shingles < ns:
        raise SystemExit(f"error: script has {index.num_shingles} < {ns} "
                         "shingles")
    s_emb = jnp.asarray(index.embeddings[:ns])

    # embedding: the corpus stream, bit-exact against the host oracle
    tok = tokenize_many(works)
    stream = np.concatenate([tok[w].hashes for w in sorted(tok)])
    nq = NQ
    stream = stream[: nq + n - 1]
    embed_jit = jax.jit(lambda t: embed_shingles(t, scfg))
    stream_d = jnp.asarray(stream)
    q = embed_jit(stream_d)
    same = np.array_equal(np.asarray(q), embed_shingles_np(stream, scfg))
    t_embed = best_time(lambda: embed_jit(stream_d))
    say(f"embed {nq} shingles: bit-exact vs host oracle = {same}; "
        f"plain XLA {t_embed * 1e3:.3f} ms")
    if not same:
        raise SystemExit("error: device embedding differs from the oracle")

    # top-k: kernel vs plain, exact on every entry >= min_keep
    thr = xcfg.candidate_threshold
    for mk in (thr, -float("inf")):
        def run(kernels, mk=mk):
            return topk_dot(q, s_emb, k=k, dim=dim, kernels=kernels,
                            min_keep=mk, max_abs_score=n * n * dim)

        kv, ki = (np.asarray(x) for x in run(True))
        pv, pi = (np.asarray(x) for x in run(False))
        keep = pv >= mk
        bad = int((kv[keep] != pv[keep]).sum() + (ki[keep] != pi[keep]).sum()
                  + (kv[~keep] != pv[~keep]).sum())
        tk = best_time(lambda: run(True))
        tp = best_time(lambda: run(False))
        say(f"top-k {nq}x{ns} min_keep={mk}: mismatches {bad} over "
            f"{int(keep.sum())} kept entries; kernel {tk * 1e3:.3f} ms "
            f"({nq * ns / tk / 1e9:.1f} G pairs/s), plain "
            f"{tp * 1e3:.3f} ms ({nq * ns / tp / 1e9:.1f} G pairs/s)")
        if bad:
            raise SystemExit("error: top-k kernel differs from plain")

    # Smith-Waterman: 16,384 pairs of 64x64, kernel vs plain, exact
    rng = np.random.default_rng(11)
    bsz, w = SW_PAIRS, xcfg.window_tokens
    a = rng.integers(0, 50, size=(bsz, w)).astype(np.uint32)
    b = rng.integers(0, 50, size=(bsz, w)).astype(np.uint32)
    lb = rng.integers(5, 21, size=bsz).astype(np.int32)
    for i in range(0, bsz, 5):  # planted near-quotes
        a[i, 10 : 10 + lb[i]] = b[i, : lb[i]]
    la = np.full(bsz, w, np.int32)
    la[::50] = rng.integers(6, w, size=len(la[::50]))
    order = np.argsort(-(la + lb), kind="stable")
    cases = {
        "engine-like sorted": (a[order], b[order], la[order], lb[order]),
        "full-length": (a, b, np.full(bsz, w, np.int32),
                        np.full(bsz, w, np.int32)),
    }
    for name, (a_, b_, la_, lb_) in cases.items():
        ad, bd, lad, lbd = (jnp.asarray(x) for x in (a_, b_, la_, lb_))
        got = np.asarray(sw_normalized_triton(ad, bd, lad, lbd, xcfg))
        want = np.asarray(sw_normalized_jnp(ad, bd, lad, lbd, xcfg))
        bad = int((got != want).sum())
        tk = best_time(lambda: sw_normalized_triton(ad, bd, lad, lbd, xcfg))
        tp = best_time(lambda: sw_normalized_jnp(ad, bd, lad, lbd, xcfg))
        say(f"SW {bsz} pairs {w}x{w} {name}: mismatches {bad}; kernel "
            f"{tk * 1e3:.3f} ms, plain {tp * 1e3:.3f} ms")
        if bad:
            raise SystemExit("error: SW kernel differs from plain")

    # the fused batch as the engine compiles it, full 2^20 bucket
    eng = SearchEngine(index, cfg)
    nspans = 512
    ext = jax.ShapeDtypeStruct((nq + n - 1 + 2 * nspans,), jnp.uint32)
    compiled = _fused_jit.lower(
        ext, *eng._fused_args(), cand_budget=eng._cand_budget,
        verify_budget=eng._verify_budget, nspans=nspans,
        **eng._fused_statics(),
    ).compile()
    say(f"fused batch memory_analysis: {compiled.memory_analysis()}")
    return index


def phase2_cli(tmp: Path, script_text, lines, works, planted):
    from fandom_search import cli
    from fandom_search.config import PipelineConfig
    from fandom_search.search.index import build_script_index
    from fandom_search.search.oracle import search_works_oracle

    script = tmp / "script.txt"
    script.write_text(script_text, encoding="utf-8")
    wdir = tmp / "works"
    wdir.mkdir()
    for wid, text in works.items():
        (wdir / f"{wid}.txt").write_text(text, encoding="utf-8")
    ntok = sum(len(t.split()) for t in works.values())
    say(f"corpus: {len(works)} works, {ntok} tokens; script "
        f"{len(lines)} lines")

    exact_csv = tmp / "matches.csv"
    t0 = time.perf_counter()
    rc = cli.main(["search", str(wdir), str(script), "-o", str(exact_csv)])
    say(f"cli search: rc {rc}, {time.perf_counter() - t0:.1f} s wall "
        "(compiles included)")
    if rc != 0:
        raise SystemExit("error: search failed")
    rc = cli.main(["matrix", str(exact_csv), "-o", str(tmp / "matrix.csv"),
                   "--script", str(script)])
    n_matrix = len(read_rows(tmp / "matrix.csv"))
    say(f"cli matrix: rc {rc}, {n_matrix} line records")
    if rc != 0 or n_matrix == 0:
        raise SystemExit("error: matrix failed")
    rows = read_rows(exact_csv)

    cfg = PipelineConfig()
    index = build_script_index(lines, cfg.shingle, cfg.search)
    sample = {w: works[w] for w in sorted(works)[:50]}
    orows, _ = search_works_oracle(sample, index, cfg)
    want = {row_key(r) for r in orows}
    got = {row_key(r) for r in rows if r["work_id"] in sample}
    parity = len(got & want) / max(1, len(got | want))
    say(f"oracle parity on 50 works: {parity} ({len(want)} oracle rows)")
    if parity != 1.0:
        raise SystemExit("error: engine rows differ from the oracle's")

    found = {(r["work_id"], int(r["line_no"])) for r in rows}
    missed = sum((p.work_id, p.line_no) not in found for p in planted)
    say(f"plants recovered: {len(planted) - missed}/{len(planted)}")
    if missed:
        raise SystemExit("error: planted quotes missed")

    b_csv = tmp / "matches_bucketed.csv"
    t0 = time.perf_counter()
    rc = cli.main(["search", str(wdir), str(script), "-o", str(b_csv),
                   "--bucketed"])
    b_rows = read_rows(b_csv)
    same = sorted(map(tuple, (r.values() for r in b_rows))) == sorted(
        map(tuple, (r.values() for r in rows)))
    say(f"cli search --bucketed: rc {rc}, "
        f"{time.perf_counter() - t0:.1f} s wall; rows equal exact rows: "
        f"{same} ({len(b_rows)} rows)")
    if rc != 0 or not same:
        raise SystemExit("error: bucketed rows differ from exact rows")
    return rows


def phase3_serve(index, works, rows):
    from fandom_search.config import PipelineConfig
    from fandom_search.search.engine import SearchEngine
    from fandom_search.search.server import SearchService, make_server

    cfg = PipelineConfig()
    service = SearchService(SearchEngine(index, cfg), index, cfg)
    srv = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        health = json.loads(urllib.request.urlopen(
            base + "/health", timeout=60).read())
        say(f"serve /health: {health}")
        if not str(health.get("device", "")).startswith("gpu"):
            raise SystemExit("error: /health does not report the GPU")
        for wid in sorted(works)[:3]:
            req = urllib.request.Request(
                base + "/search",
                data=json.dumps({"works": {wid: works[wid]}}).encode(),
                headers={"Content-Type": "application/json"},
            )
            t0 = time.perf_counter()
            out = json.loads(urllib.request.urlopen(req, timeout=600).read())
            dt = time.perf_counter() - t0
            got = {row_key(r) for r in out["matches"]}
            want = {row_key(r) for r in rows if r["work_id"] == wid}
            say(f"serve POST /search {wid}: {len(got)} matches in "
                f"{dt * 1e3:.1f} ms; equal to batch rows: {got == want}")
            if got != want:
                raise SystemExit("error: served rows differ from batch rows")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)


def phase4_cards(lines, works):
    import dataclasses

    from fandom_search.config import BucketedConfig, MeshConfig, PipelineConfig
    from fandom_search.parallel.mesh import make_mesh
    from fandom_search.parallel.sharded import ShardedSearchEngine
    from fandom_search.parallel.sharded_bucketed import (
        attach_bucketed_prefilter_sharded,
    )
    from fandom_search.search.engine import SearchEngine
    from fandom_search.search.index import build_script_index

    base = PipelineConfig()
    index = build_script_index(lines, base.shingle, base.search)
    t0 = time.perf_counter()
    want, _ = SearchEngine(index, base).search_works(works)
    want = {row_key(r) for r in want}
    say(f"one card: {len(want)} rows ({time.perf_counter() - t0:.1f} s)")
    for w, s, bucketed in ((4, 1, False), (2, 2, False), (4, 1, True)):
        cfg = dataclasses.replace(base, mesh=MeshConfig(works=w, script=s))
        eng = ShardedSearchEngine(index, cfg, mesh=make_mesh(cfg.mesh))
        if bucketed:
            attach_bucketed_prefilter_sharded(eng, BucketedConfig())
        t0 = time.perf_counter()
        got, _ = eng.search_works(works)
        got = {row_key(r) for r in got}
        label = f"{w}x{s}{' bucketed hybrid' if bucketed else ''}"
        say(f"mesh {label}: {len(got)} rows, equal to one-card rows: "
            f"{got == want} ({time.perf_counter() - t0:.1f} s)")
        if got != want:
            raise SystemExit(f"error: mesh {label} rows differ")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card phase")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    devs = phase0_device()
    if len(devs) < args.cards:
        raise SystemExit(f"error: --cards {args.cards} but JAX sees "
                         f"{len(devs)} device(s)")
    from fandom_search.utils.jit_cache import enable_persistent_cache

    enable_persistent_cache()

    if args.cards == 4:
        _, lines, works, _ = make_world(
            args.seed, SCRIPT_LINES, CARDS4_WORKS, WORDS)
        phase4_cards(lines, works)
    else:
        t0 = time.perf_counter()
        script_text, lines, works, planted = make_world(
            args.seed, SCRIPT_LINES, WORKS, WORDS)
        say(f"data generated from seed {args.seed} in "
            f"{time.perf_counter() - t0:.1f} s")
        index = phase1_kernels(lines, works)
        with tempfile.TemporaryDirectory() as tmp:
            rows = phase2_cli(Path(tmp), script_text, lines, works, planted)
        phase3_serve(index, works, rows)
    say(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
