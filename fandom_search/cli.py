"""``fandomsearch`` CLI — the reference's subcommand surface (SURVEY.md section 3).

Subcommands (verbs match the reference's argparse driver):

  scrape   — download an AO3 tag's works (polite, resumable)
  clean    — extract story text from scraped HTML, drop broken works
  getmeta  — extract work metadata into one CSV
  format   — parse a source script into (line_no, speaker, text) CSV
  search   — find quotations of the script inside the corpus (GPU)
  serve    — persistent HTTP search service (resident index, warm engine)
  matrix   — aggregate matches into per-line engagement counts
  bench    — run the standard benchmark and print one JSON line
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import logging
import sys
import time
from pathlib import Path


def _add_search_flags(p: argparse.ArgumentParser) -> None:
    # Defaults are None so a persisted-index config (`search --index`)
    # can tell "user asked for this" from "flag left alone": only
    # explicitly-passed flags overlay the stored config.
    p.add_argument("--k", type=int, default=None,
                   help="top-k per query shingle (default 10)")
    p.add_argument("--shingle-n", type=int, default=None,
                   help="words per shingle (default 6; index-bound)")
    p.add_argument("--shingle-dim", type=int, default=None,
                   help="embedding lanes per shingle (default 128; "
                        "index-bound).  256 halves the overlap "
                        "estimator's noise sd for more kernel time — "
                        "recall-critical deployments)")
    p.add_argument(
        "--candidate-threshold", type=float, default=None,
        help="min estimated matching words (of n) to keep a candidate "
             "(default 3.5)",
    )
    p.add_argument(
        "--verify-threshold", type=float, default=None,
        help="min normalized alignment score to keep a hit (default 0.35)",
    )
    p.add_argument("--chain-gap", type=int, default=None,
                   help="max token gap when chaining hits (default 12)")
    p.add_argument("--batch-queries", type=int, default=None,
                   help="query shingles per device call (default 1048576)")
    p.add_argument("--lookahead-batches", type=int, default=None,
                   help="batches in flight ahead of result consumption "
                        "(default 1)")
    p.add_argument("--stream-compress", action="store_true", default=None,
                   help="u16 vocab-id compression of the query-stream "
                        "upload (halves wire bytes; wins only on "
                        "bandwidth-bound links)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain XLA paths, no kernels); "
                        "without it a run needs a GPU")
    p.add_argument("--oracle", action="store_true",
                   help="run the NumPy reference pipeline instead of the "
                        "device engine")
    p.add_argument("--reference", action="store_true",
                   help="run the reference-style CPU pipeline "
                        "(sklearn BallTree + Levenshtein ratio)")
    p.add_argument("--shards", type=int, default=None,
                   help="shard the corpus across N devices (data parallel; "
                        "shorthand for --mesh Nx1)")
    p.add_argument("--mesh", default=None, metavar="WxS",
                   help="device mesh: W works-shards x S script-shards "
                        "(e.g. 4x2)")
    p.add_argument("--bucketed", action="store_true",
                   help="use the sub-linear bucketed inverted-index "
                        "prefilter (recommended for very large script "
                        "indexes, e.g. whole-season search); queries "
                        "hitting overflowed (stopword-pair) buckets "
                        "reroute through the exact kernel automatically")
    p.add_argument("--bucketed-pairs", choices=("triangles", "all"),
                   default=None,
                   help="probe set: 'triangles' (6 probes, >=3-match "
                        "guarantee) or 'all' (15 probes, >=2-match "
                        "guarantee for recall-critical huge indexes)")
    p.add_argument("--multihost", action="store_true",
                   help="join a multi-host JAX cluster "
                        "(jax.distributed.initialize) before building the "
                        "mesh; pass --coordinator, --num-processes and "
                        "--process-id")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-host coordinator address (with --multihost)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-host process count (with --multihost)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank (with --multihost)")
    p.add_argument("--selfcheck", type=int, default=0, metavar="N",
                   help="re-run N sample works through the NumPy oracle "
                        "and report row agreement in the manifest")


def _maybe_multihost(args) -> None:
    """Join a multi-host cluster if requested; must precede any other
    jax call (so call it before enable_persistent_cache and the first
    device query).  After it, jax.devices() is the GLOBAL device list
    and make_mesh needs nothing special (parallel/mesh.py)."""
    if getattr(args, "multihost", False):
        from fandom_search.parallel.mesh import initialize_multihost

        n = initialize_multihost(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )
        print(f"multihost: joined cluster, {n} global devices",
              file=sys.stderr)


def _select_platform(args) -> str:
    """Pin the CPU when ``--cpu`` asks for it, join a multi-host cluster
    when asked (before the first device query), then insist on a platform
    a run may use: a GPU, or the CPU only when asked for.  There is no
    silent fallback — a run that wanted the GPU and found none exits
    non-zero with one message."""
    import jax

    from fandom_search.ops.backend import (
        UnsupportedPlatformError, require_gpu,
    )

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    _maybe_multihost(args)
    try:
        return require_gpu(allow_cpu=args.cpu)
    except UnsupportedPlatformError as e:
        raise SystemExit(f"error: {e}")


def _mesh_from_args(args) -> "MeshConfig | None":
    from fandom_search.config import MeshConfig

    if args.mesh is not None:
        try:
            w, s = (int(x) for x in args.mesh.lower().split("x"))
        except ValueError:
            raise SystemExit(f"error: --mesh must look like WxS, got {args.mesh!r}")
        return MeshConfig(works=w, script=s)
    if args.shards is not None:
        return MeshConfig(works=args.shards)
    return None


def _runtime_overrides(args) -> dict:
    """Runtime-only SearchConfig fields the user explicitly set."""
    out = {}
    for field, attr in (
        ("k", "k"),
        ("candidate_threshold", "candidate_threshold"),
        ("verify_threshold", "verify_threshold"),
        ("chain_gap", "chain_gap"),
        ("batch_queries", "batch_queries"),
        ("lookahead_batches", "lookahead_batches"),
        ("stream_compress", "stream_compress"),
    ):
        v = getattr(args, attr)
        if v is not None:
            out[field] = v
    return out


def _pipeline_config(args) -> "PipelineConfig":
    from fandom_search.config import (
        BucketedConfig, MeshConfig, PipelineConfig, SearchConfig,
        ShingleConfig,
    )

    sh_kw = {}
    if args.shingle_n is not None:
        sh_kw["n"] = args.shingle_n
    if getattr(args, "shingle_dim", None) is not None:
        sh_kw["dim"] = args.shingle_dim
    shingle = ShingleConfig(**sh_kw)
    bucketed = BucketedConfig() if args.bucketed_pairs is None else (
        BucketedConfig(pairs=args.bucketed_pairs)
    )
    return PipelineConfig(
        shingle=shingle,
        search=dataclasses.replace(SearchConfig(), **_runtime_overrides(args)),
        bucketed=bucketed,
        mesh=_mesh_from_args(args) or MeshConfig(),
    )


def _overlay_runtime(cfg: "PipelineConfig", args) -> "PipelineConfig":
    """Overlay explicit runtime flags onto a persisted-index config.

    Index-bound knobs (shingle width, embedding dim, max_line_tokens)
    are baked into the stored embeddings and cannot be overridden;
    warn if the user tries.
    """
    if args.shingle_n is not None and args.shingle_n != cfg.shingle.n:
        print(
            f"warning: --shingle-n {args.shingle_n} ignored; the loaded "
            f"index was built with n={cfg.shingle.n}",
            file=sys.stderr,
        )
    if (getattr(args, "shingle_dim", None) is not None
            and args.shingle_dim != cfg.shingle.dim):
        print(
            f"warning: --shingle-dim {args.shingle_dim} ignored; the "
            f"loaded index was built with dim={cfg.shingle.dim}",
            file=sys.stderr,
        )
    over = _runtime_overrides(args)
    if over:
        cfg = dataclasses.replace(
            cfg, search=dataclasses.replace(cfg.search, **over)
        )
    mesh = _mesh_from_args(args)
    if mesh is not None:
        cfg = dataclasses.replace(cfg, mesh=mesh)
    if args.bucketed_pairs is not None:
        cfg = dataclasses.replace(
            cfg,
            bucketed=dataclasses.replace(
                cfg.bucketed, pairs=args.bucketed_pairs
            ),
        )
    return cfg


def cmd_scrape(args) -> int:
    from fandom_search.scrape.ao3 import ScrapeConfig, scrape_tag

    cfg = ScrapeConfig(
        tag=args.tag,
        out_dir=Path(args.out),
        start_page=args.start_page,
        end_page=args.end_page,
        delay_seconds=args.delay,
    )
    n = 0
    for path in scrape_tag(cfg):
        n += 1
        print(path)
    print(f"downloaded {n} works", file=sys.stderr)
    return 0


def cmd_clean(args) -> int:
    from fandom_search.scrape.clean import clean_corpus

    kept = clean_corpus(Path(args.src), Path(args.out))
    print(f"kept {len(kept)} works", file=sys.stderr)
    return 0


def _parse_script_lines(paths):
    """Parse one or many script files into one line list.

    Multi-script: line numbers are renumbered globally and each line
    labeled with its file's stem — the same order/labeling
    ``concat_indexes`` produces, so `matrix --script a.txt b.txt`
    agrees with a multi-script search's line_no space.
    """
    from fandom_search.data.script_parser import parse_script

    paths = [paths] if isinstance(paths, (str, Path)) else list(paths)
    if len(paths) == 1:
        return parse_script(Path(paths[0]).read_text(encoding="utf-8"))
    names = [Path(p).stem for p in paths]
    if len(set(names)) != len(names):
        raise SystemExit(f"error: duplicate script names: {names}")
    lines, off = [], 0
    for p, name in zip(paths, names):
        part = parse_script(Path(p).read_text(encoding="utf-8"))
        lines.extend(
            dataclasses.replace(ln, line_no=off + ln.line_no, script=name)
            for ln in part
        )
        off += len(part)
    return lines


def _build_index_from_scripts(paths, cfg):
    """(lines, index) for one script file or a multi-script set."""
    from fandom_search.data.script_parser import parse_script
    from fandom_search.search.index import (
        build_script_index, concat_indexes,
    )

    paths = [paths] if isinstance(paths, (str, Path)) else list(paths)
    if len(paths) == 1:
        lines = parse_script(Path(paths[0]).read_text(encoding="utf-8"))
        return lines, build_script_index(lines, cfg.shingle, cfg.search)
    names = [Path(p).stem for p in paths]
    if len(set(names)) != len(names):
        raise SystemExit(f"error: duplicate script names: {names}")
    parts = []
    for p, name in zip(paths, names):
        part_lines = parse_script(Path(p).read_text(encoding="utf-8"))
        parts.append(
            (name, build_script_index(part_lines, cfg.shingle, cfg.search))
        )
    index = concat_indexes(parts)
    return index.lines, index


def cmd_getmeta(args) -> int:
    from fandom_search.scrape.clean import write_metadata_csv

    n = write_metadata_csv(Path(args.src), Path(args.out))
    print(f"wrote metadata for {n} works", file=sys.stderr)
    return 0


def cmd_format(args) -> int:
    from fandom_search.data.script_parser import parse_script

    lines = parse_script(Path(args.script).read_text(encoding="utf-8"))
    with open(args.out, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["line_no", "speaker", "text"])
        for ln in lines:
            w.writerow([ln.line_no, ln.speaker, ln.text])
    print(f"parsed {len(lines)} script lines", file=sys.stderr)
    return 0


def cmd_index(args) -> int:
    """Build + persist the script index (decoupled from query)."""
    _select_platform(args)
    from fandom_search.utils.jit_cache import enable_persistent_cache

    enable_persistent_cache()
    from fandom_search.search.persist import save_index

    cfg = _pipeline_config(args)
    lines, index = _build_index_from_scripts(args.script, cfg)
    save_index(index, cfg, Path(args.out))
    if args.bucketed:
        from fandom_search.ops.bucketed import BucketedIndex
        from fandom_search.search.persist import save_bucketed

        bidx = BucketedIndex.build(
            index.shingle_windows, cfg.bucketed, cfg.shingle
        )
        save_bucketed(Path(args.out), bidx, cfg.bucketed)
        print(
            f"saved bucketed tables ({bidx.num_buckets} buckets, "
            f"overflow {bidx.overflow_frac:.5f})", file=sys.stderr,
        )
    print(f"indexed {len(lines)} lines -> {index.num_shingles} shingles "
          f"at {args.out}", file=sys.stderr)
    return 0


def _build_engine(args, cfg, index):
    """Device engine with the flags' prefilter attached (search/serve).
    Its kernels follow the platform (ops/backend.py)."""
    if cfg.mesh.num_devices > 1:
        from fandom_search.parallel.sharded import ShardedSearchEngine

        eng = ShardedSearchEngine(index, cfg)
    else:
        from fandom_search.search.engine import SearchEngine

        eng = SearchEngine(index, cfg)
    if args.bucketed:
        from fandom_search.ops.bucketed import attach_bucketed_prefilter

        prebuilt_b = None
        if args.index:
            from fandom_search.search.persist import load_bucketed

            prebuilt_b = load_bucketed(Path(args.index), cfg.bucketed)
        attach_bucketed_prefilter(eng, cfg.bucketed, bidx=prebuilt_b)
    return eng


def _run_search(args, cfg, lines, index, works):
    """Dispatch one search run; returns (rows, stats_dict)."""
    if args.reference:
        from fandom_search.search.reference_pipeline import ReferenceSearch

        ref = ReferenceSearch(lines, cfg)
        rows, stats = ref.search_works(works)
        return rows, dataclasses.asdict(stats)
    if args.oracle:
        from fandom_search.search.oracle import search_works_oracle

        rows, stats = search_works_oracle(works, index, cfg)
        return rows, dataclasses.asdict(stats)
    eng = _build_engine(args, cfg, index)
    if getattr(args, "warm", False):
        t0 = time.perf_counter()
        # rough token estimate caps the largest bucket warmed, so a
        # small corpus doesn't compile the full-cap variant.  The ~6
        # chars/word correction applies only to raw text; Tokenized
        # works already count tokens.
        est = sum(
            len(t) // 6 if isinstance(t, str) else len(t.hashes)
            for t in works.values()
        )
        n = eng.warm_buckets(max_queries=max(1, est))
        if n:
            print(f"warm: precompiled {n} stream bucket(s) in "
                  f"{time.perf_counter()-t0:.1f}s", file=sys.stderr)
        else:
            print("warm: engine runs the --bucketed prefilter path; "
                  "fused-variant warming does not apply",
                  file=sys.stderr)
    if args.resume_dir:
        from fandom_search.search.runner import ResumableRunner

        runner = ResumableRunner(eng, Path(args.resume_dir))
        rows = runner.run(works)
        return rows, runner.stats_summary()
    rows, stats = eng.search_works(works)
    return rows, dataclasses.asdict(stats)


def cmd_search(args) -> int:
    _select_platform(args)
    # Amortize per-bucket jit compiles across CLI invocations.
    from fandom_search.utils.jit_cache import enable_persistent_cache

    enable_persistent_cache()

    from fandom_search.scrape.clean import load_works_dir
    from fandom_search.search.report import (
        write_matches_csv, write_matches_parquet,
    )

    t0 = time.perf_counter()
    if args.index:
        from fandom_search.search.persist import load_index

        index, cfg = load_index(Path(args.index))
        cfg = _overlay_runtime(cfg, args)
        lines = index.lines
    else:
        if not args.script:
            print("error: provide script file(s) or --index", file=sys.stderr)
            return 2
        cfg = _pipeline_config(args)
        lines, index = _build_index_from_scripts(args.script, cfg)
    works = load_works_dir(Path(args.fanworks))
    t_prep = time.perf_counter() - t0

    profile_ctx = None
    if args.profile:
        from fandom_search.utils.profiling import device_trace

        profile_ctx = device_trace(args.profile)
        profile_ctx.__enter__()

    t0 = time.perf_counter()
    try:
        rows, stats_d = _run_search(args, cfg, lines, index, works)
    finally:
        # close the profiler even on failure/interrupt, so the one run
        # being profiled still leaves a usable trace
        if profile_ctx is not None:
            profile_ctx.__exit__(None, None, None)
    t_search = time.perf_counter() - t0

    out = Path(args.out)
    if args.parquet:
        write_matches_parquet(rows, out)
    else:
        write_matches_csv(rows, out)
    manifest = {
        "works": len(works),
        "script_lines": len(lines),
        "script_shingles": index.num_shingles,
        "matches": len(rows),
        "seconds_prep": round(t_prep, 3),
        "seconds_search": round(t_search, 3),
        "stats": stats_d,
    }
    qs = (
        stats_d.get("num_query_shingles", 0)
        or stats_d.get("query_shingles", 0)  # ResumableRunner summary key
        or 0
    )
    # Resumed runs: qs sums ALL units (incl. ones restored from disk in
    # milliseconds), so divide by the manifest's all-time compute
    # seconds, not this invocation's wall-clock — otherwise a fully-
    # resumed run reports an absurd throughput for zero pairs scored.
    rate_seconds = (
        stats_d.get("seconds") if stats_d.get("resumable") else t_search
    )
    if qs and rate_seconds:
        manifest["shingle_pairs_per_sec"] = round(
            qs * index.num_shingles / rate_seconds
        )
    if args.selfcheck and not (args.oracle or args.reference):
        # (--reference has deliberately different verifier semantics —
        # comparing its rows to the oracle would report a bogus recall
        # failure)
        # recall-vs-oracle observability: replay a sample through the
        # NumPy golden pipeline and compare row sets
        from fandom_search.search.oracle import search_works_oracle

        sample_ids = sorted(works)[: args.selfcheck]
        sample = {w: works[w] for w in sample_ids}
        orows, _ = search_works_oracle(sample, index, cfg)
        key = lambda r: (r.work_id, r.fan_token_start, r.line_no)  # noqa: E731
        got = {key(r) for r in rows if r.work_id in sample}
        want = {key(r) for r in orows}
        manifest["selfcheck"] = {
            "works": len(sample),
            "oracle_rows": len(want),
            "agreement": (
                round(len(got & want) / len(want | got), 4)
                if (want or got) else 1.0
            ),
        }
    print(json.dumps(manifest, default=str))
    return 0


def cmd_serve(args) -> int:
    """Persistent search service (search/server.py): load or build the
    index once, keep the engine warm, answer HTTP/JSON queries."""
    if getattr(args, "oracle", False) or getattr(args, "reference", False):
        print("error: serve runs the device engine (no --oracle/--reference)",
              file=sys.stderr)
        return 2
    _select_platform(args)
    from fandom_search.utils.jit_cache import enable_persistent_cache

    enable_persistent_cache()
    from fandom_search.search.server import SearchService, make_server

    if args.index:
        from fandom_search.search.persist import load_index

        index, cfg = load_index(Path(args.index))
        cfg = _overlay_runtime(cfg, args)
        lines = index.lines
    else:
        if not args.script:
            print("error: provide script file(s) or --index", file=sys.stderr)
            return 2
        cfg = _pipeline_config(args)
        lines, index = _build_index_from_scripts(args.script, cfg)

    service = SearchService(_build_engine(args, cfg, index), index, cfg)
    if not args.no_warm:
        dt = service.warm()
        print(f"warmup search: {dt:.1f}s", file=sys.stderr)
    srv = make_server(service, args.host, args.port)
    print(
        f"serving {len(lines)} script lines ({index.num_shingles} shingles) "
        f"on http://{args.host}:{srv.server_address[1]} "
        f"(GET /health, GET /stats, POST /search)", file=sys.stderr,
    )
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        print("shutting down", file=sys.stderr)
    finally:
        srv.server_close()
    return 0


def cmd_matrix(args) -> int:
    from fandom_search.search.report import (
        aggregate_matrix, read_matches_csv, write_matrix_csv,
    )

    rows = read_matches_csv(Path(args.matches))
    lines = None
    if args.script:
        lines = _parse_script_lines(args.script)
    records = aggregate_matrix(rows, lines)
    write_matrix_csv(records, Path(args.out))
    if args.html:
        from fandom_search.search.heatmap import write_engagement_html

        write_engagement_html(records, Path(args.html), title=args.title)
    print(f"aggregated {len(rows)} matches over {len(records)} lines"
          + (f"; heatmap -> {args.html}" if args.html else ""),
          file=sys.stderr)
    return 0


def cmd_bench(args) -> int:
    # module-relative so it works from an installed wheel, in a fresh
    # interpreter so jax platform/device config starts clean
    import subprocess

    cmd = [sys.executable, "-m", "fandom_search.bench"]
    if args.quick:
        cmd.append("--quick")
    return subprocess.call(cmd)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fandomsearch",
        description="GPU text-reuse search (fandom-search capabilities)",
    )
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--version", action="version", version=_version())
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("scrape", help="download an AO3 tag's works")
    sp.add_argument("tag")
    sp.add_argument("-o", "--out", required=True)
    sp.add_argument("--start-page", type=int, default=1)
    sp.add_argument("--end-page", type=int, default=None)
    sp.add_argument("--delay", type=float, default=5.0)
    sp.set_defaults(fn=cmd_scrape)

    cp = sub.add_parser("clean", help="extract story text from scraped HTML")
    cp.add_argument("src")
    cp.add_argument("-o", "--out", required=True)
    cp.set_defaults(fn=cmd_clean)

    mp = sub.add_parser("getmeta", help="extract work metadata CSV")
    mp.add_argument("src")
    mp.add_argument("-o", "--out", required=True)
    mp.set_defaults(fn=cmd_getmeta)

    fp = sub.add_parser("format", help="parse a script into line records")
    fp.add_argument("script")
    fp.add_argument("-o", "--out", required=True)
    fp.set_defaults(fn=cmd_format)

    ip = sub.add_parser("index", help="build + persist the script index")
    ip.add_argument("script", nargs="+",
                    help="script file(s); several build one multi-script "
                         "index with per-script match attribution")
    ip.add_argument("-o", "--out", required=True)
    _add_search_flags(ip)
    ip.set_defaults(fn=cmd_index)

    qp = sub.add_parser("search", help="search the corpus for script quotes")
    qp.add_argument("fanworks", help="dir of cleaned .txt (or .html) works")
    qp.add_argument("script", nargs="*", default=None,
                    help="source script file(s) — several search one "
                         "multi-script index in one corpus pass (or "
                         "use --index)")
    qp.add_argument("-o", "--out", required=True)
    qp.add_argument("--parquet", action="store_true")
    qp.add_argument("--index", default=None,
                    help="persisted index dir (from `index`)")
    qp.add_argument("--resume-dir", default=None,
                    help="work-unit dir for resumable runs")
    qp.add_argument("--profile", default=None,
                    help="write a jax.profiler trace to this dir")
    qp.add_argument("--warm", action="store_true",
                    help="pre-compile the smallest and full-cap stream "
                         "buckets before the pass (compiles land in the "
                         "persistent jit cache for later runs)")
    _add_search_flags(qp)
    qp.set_defaults(fn=cmd_search)

    vp = sub.add_parser(
        "serve",
        help="persistent search service (resident index, warm engine)",
    )
    vp.add_argument("script", nargs="*", default=None,
                    help="source script file(s) (or use --index)")
    vp.add_argument("--index", default=None,
                    help="persisted index dir (from `index`)")
    vp.add_argument("--host", default="127.0.0.1",
                    help="bind address (default 127.0.0.1)")
    vp.add_argument("--port", type=int, default=8765)
    vp.add_argument("--no-warm", action="store_true",
                    help="skip the warmup search (first request compiles)")
    _add_search_flags(vp)
    vp.set_defaults(fn=cmd_serve)

    xp = sub.add_parser("matrix", help="per-line engagement aggregation")
    xp.add_argument("matches", help="matches CSV from `search`")
    xp.add_argument("-o", "--out", required=True)
    xp.add_argument("--script", nargs="+", default=None,
                    help="script file(s) for line text/speaker columns "
                         "(same order as the search)")
    xp.add_argument("--html", default=None, metavar="PATH",
                    help="also write a self-contained engagement heatmap "
                         "(the Fan Engagement Meter view)")
    xp.add_argument("--title", default="Fan engagement",
                    help="heatmap page title")
    xp.set_defaults(fn=cmd_matrix)

    bp = sub.add_parser("bench", help="run the standard benchmark")
    bp.add_argument("--quick", action="store_true",
                    help="kernel-only regression check vs bench_expected.json")
    bp.set_defaults(fn=cmd_bench)
    return p


def _version() -> str:
    try:
        from importlib.metadata import version

        return version("fandom-search")
    except Exception:  # noqa: BLE001 — uninstalled checkout
        try:
            import tomllib

            pyproject = (
                Path(__file__).resolve().parent.parent / "pyproject.toml"
            )
            with open(pyproject, "rb") as f:
                v = tomllib.load(f)["project"]["version"]
            return f"{v} (source checkout)"
        except Exception:  # noqa: BLE001
            return "unknown (source checkout)"


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(levelname)s %(name)s: %(message)s",
    )
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
