#!/usr/bin/env python
"""Standard benchmark — prints ONE JSON line.

Covers every BASELINE.json benchmark config (see README.md):

  #1 CPU oracle (the reference algorithm, NumPy) — the baseline timer
  #2 fused distance+top-k kernel — exact mode and engine mode
     (min_keep = candidate threshold; the configuration the product
     runs — sub-threshold rows skip the top-k merge)
  #3 Smith-Waterman verification rate
  #4 sharded path (1-device mesh; multi-device correctness is
     exercised on a virtual 8-device CPU mesh by tests, the driver's
     dryrun_multichip, and on four GPUs by chip_smoke.py --cards 4)
  #5 the sub-linear bucketed prefilter (uniform 2^20/2^22, zipf and
     english-like skew hybrids at 2^20, english at 2^22) and an
     end-to-end row-parity attestation of the bucketed engine path

plus recall@10 of the exact kernel vs the NumPy oracle (must be 1.0)
and an end-to-end corpus run (default 10k fanworks vs one script) with
an extrapolated CPU-oracle wall-clock for e2e_speedup_vs_cpu.

The bench runs on the GPU.  ``--cpu`` runs it on the CPU when asked
for (tests); with neither a GPU nor ``--cpu`` it stops with an error —
there is no fallback.  Kernels follow the platform (ops/backend.py).
A stage that fails ends the run with a non-zero exit and no JSON line.

BENCH_TIME_BUDGET_S (default 900 s, 0 disables) counts wall-clock from
the start: optional stages whose estimated cost would blow the budget
are skipped and listed in `stages_skipped_for_time`.  Per-stage wall
seconds land in `stage_seconds`.

The one stdout line reports shingle-pairs/sec through the engine-mode
kernel; everything else goes to stderr + bench_details.json.

Env knobs: BENCH_NQ, BENCH_NS, BENCH_CPU_NQ, BENCH_SW_B, BENCH_E2E_WORKS,
BENCH_CPU_E2E_WORKS, BENCH_SKIP_E2E=1, BENCH_BIG_NS, BENCH_HUGE_NS,
BENCH_ZIPF_NS (default 0 — the zipf-1.3 stress case runs only under
BENCH_FULL=1 or an explicit size), BENCH_ENGLISH_NS,
BENCH_ENGLISH_HUGE_NS,
BENCH_E2E_BIG_SHINGLES / BENCH_E2E_BIG_WORKS (flagship-scale bucketed
e2e parity stage; 0 skips) / BENCH_E2E_BIG_REPS (A/B timing reps, 1),
BENCH_SCALE_WORKS / BENCH_SCALE_REPS (1),
BENCH_TIME_BUDGET_S (wall-clock stage-skipping budget, 900; 0 off),
BENCH_FULL=1 (run every demoted stage),
BENCH_QUICK=1 (or --quick): kernel-only regression check against
bench_expected.json (fails the process if the rate drops below 80% of
the recorded rate, or if the record is from another device).
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

FINAL_NAME = "bench_details.json"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _sync(out):
    """Wait for the device to finish ``out`` (a pytree of arrays)."""
    import jax

    return jax.block_until_ready(out)


def _time(fn, iters=10, rounds=3):
    """Best-of-rounds mean seconds per call of ``fn``, after one
    compile-and-warm call; each round ends in block_until_ready, so the
    time covers the device work and not just the enqueue."""
    _sync(fn())  # compile + warm
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        out = None
        for _ in range(iters):
            out = fn()
        _sync(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def driver_line(metric, value, unit, vs_baseline, platform, device_kind):
    """The ONE stdout JSON line; it names the device it ran on
    (`backend`, `device_kind`)."""
    return {
        "metric": metric, "value": value, "unit": unit,
        "vs_baseline": vs_baseline,
        "backend": platform, "device_kind": device_kind,
    }


def _recall_by_score(want_vals, got_vals, dim, k):
    """recall@k counted by score MULTISET (ties make index sets
    ambiguous, but each tied oracle entry must be matched by its own
    kernel entry — set membership would mask lost duplicates)."""
    w = np.round(np.asarray(want_vals) * dim)
    g = np.round(np.asarray(got_vals) * dim)
    rec = 0.0
    for i in range(w.shape[0]):
        wv, wc = np.unique(w[i], return_counts=True)
        gv, gc = np.unique(g[i], return_counts=True)
        got_counts = dict(zip(gv.tolist(), gc.tolist()))
        hit = sum(
            min(int(c), got_counts.get(v, 0))
            for v, c in zip(wv.tolist(), wc.tolist())
        )
        rec += hit / k
    return rec / max(1, w.shape[0])


def skew_recall_accounting(
    evn, ein, got, q_wh, sw_h, *, stride, thr, dim, guarantee_min,
):
    """Thresholded + guaranteed-set recall of hybrid triples vs the
    exact kernel's above-threshold top-k entries, strided sample.

    ``got`` maps query index -> set of (script_idx, rounded score)
    IDENTITY pairs.  Matching by score multiset alone is wrong: the
    exact top-k's above-threshold tail carries <=1-match
    embedding-noise entries, and when one of those ties a guaranteed
    entry's score exactly (integer scores concentrate in a few dozen
    values, so collisions are routine) the noise twin would consume the
    hybrid's score first and the present guaranteed entry would be
    charged as a miss.  Matching on (si, score) identity removes the
    aliasing; score is a pure function of (query, si), so this is
    strictly more exact.
    """
    tot = hit = g_tot = g_hit = 0
    for i in range(0, evn.shape[0], stride):
        keepm = evn[i] >= thr
        if not keepm.any():
            continue
        have = got.get(i, set())
        for v, si in zip(
            np.round(evn[i][keepm] * dim), ein[i][keepm]
        ):
            guaranteed = (
                guarantee_min is not None
                and int((q_wh[i] == sw_h[si]).sum()) >= guarantee_min
            )
            tot += 1
            g_tot += guaranteed
            if (int(si), int(v)) in have:
                hit += 1
                g_hit += guaranteed
    return tot, hit, g_tot, g_hit


def make_e2e_world(rng, n_works: int):
    """The canonical e2e benchmark workload, shared with
    scripts/e2e_probe.py and scripts/kernel_ab.py so the probes always
    measure the same shape the bench records: 200-line script (6-14
    words/line), vocab 5000, 2000-word works with 3 planted quotes each.

    Returns (lines, index, works, cfg)."""
    from fandom_search.config import PipelineConfig
    from fandom_search.data.script_parser import parse_script
    from fandom_search.search.index import build_script_index
    from fandom_search.utils.synthetic import (
        make_corpus_with_quotes, make_script, make_vocab,
    )

    cfg = PipelineConfig()
    vocab = make_vocab(rng, 5000)
    script_text = make_script(rng, vocab, num_lines=200,
                              words_per_line=(6, 14))
    lines = parse_script(script_text)
    index = build_script_index(lines, cfg.shingle, cfg.search)
    works, _ = make_corpus_with_quotes(
        rng, [ln.text for ln in lines], num_works=n_works,
        words_per_work=2000, quotes_per_work=3, vocab=vocab,
    )
    return lines, index, works, cfg


class _StageRunner:
    """Runs the named stages in order, recording each one's wall seconds
    in ``stage_seconds``.  An optional stage whose estimated cost would
    carry the run past ``budget_s`` (counted from ``t0``) is skipped and
    recorded in ``stages_skipped_for_time``.  An exception in a stage
    propagates: the run fails."""

    def __init__(self, platform: str, *, budget_s: float = 0.0):
        self.details = {"stages_done": []}
        self.platform = platform
        self.t0 = time.time()
        self.budget_s = budget_s

    def run(self, name: str, fn, *, optional: bool = False,
            est_s: float = 0.0) -> bool:
        if optional and self.budget_s:
            elapsed = time.time() - self.t0
            if elapsed + est_s > self.budget_s:
                self.details.setdefault(
                    "stages_skipped_for_time", []).append(name)
                log(f"[budget] skipping optional stage {name}: "
                    f"{elapsed:.0f}s elapsed + ~{est_s:.0f}s estimated "
                    f"> {self.budget_s:.0f}s budget "
                    "(BENCH_TIME_BUDGET_S; 0 disables)")
                return False
        t_stage = time.perf_counter()
        fn()
        self.details.setdefault("stage_seconds", {})[name] = round(
            time.perf_counter() - t_stage, 3)
        self.details["stages_done"].append(name)
        return True


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    quick = "--quick" in argv or bool(os.environ.get("BENCH_QUICK"))

    import jax

    if "--cpu" in argv:
        jax.config.update("jax_platforms", "cpu")
    from fandom_search.ops.backend import (
        UnsupportedPlatformError, require_gpu, use_kernels,
    )

    try:
        platform = require_gpu(allow_cpu="--cpu" in argv)
    except UnsupportedPlatformError as e:
        raise SystemExit(f"error: {e}")
    kernels = use_kernels()

    from fandom_search.utils.jit_cache import enable_persistent_cache

    enable_persistent_cache()

    import jax.numpy as jnp

    from fandom_search.config import PipelineConfig
    from fandom_search.data.shingler import embed_shingles, embed_shingles_np
    from fandom_search.ops.distance_topk import pad_rows, topk_dot
    from fandom_search.search.oracle import topk_scores_np

    cfg = PipelineConfig()
    k, dim = cfg.search.k, cfg.shingle.dim
    thr = cfg.search.candidate_threshold
    device_kind = jax.devices()[0].device_kind
    log(f"benchmark on {jax.devices()[0]} (platform={platform}, "
        f"kind={device_kind}, kernels={kernels})")
    embed_jit = jax.jit(lambda t: embed_shingles(t, cfg.shingle))

    nq = int(os.environ.get("BENCH_NQ", 1 << 17))
    ns = int(os.environ.get("BENCH_NS", 8192))
    cpu_nq = int(os.environ.get("BENCH_CPU_NQ", 2048))

    rng = np.random.default_rng(0)
    log(f"building embeddings: {nq} query + {ns} script shingles")
    q_stream = rng.integers(
        0, 2**32, size=nq + cfg.shingle.n - 1, dtype=np.uint32)
    s_stream = rng.integers(
        0, 2**32, size=ns + cfg.shingle.n - 1, dtype=np.uint32)
    s_emb = embed_shingles_np(s_stream, cfg.shingle)  # host: oracle side
    # ~1% planted near-duplicates: realistic quote density so the
    # merge gate sees both regimes (pure noise would flatter the gate)
    n_plant = len(range(0, nq, 100))
    plant_idx = rng.integers(0, ns, size=n_plant)
    # embed the queries ON DEVICE from the uint32 stream (the stream is
    # 32x smaller than its embedding); the same parity-tested
    # multiply-shift the engine runs
    s_dev = jnp.asarray(s_emb)
    s_pad, ns_valid = pad_rows(s_dev, cfg.search.script_pad_multiple)
    log("script side on device "
        f"({float(jnp.sum(s_pad.astype(jnp.float32))):.0f} checksum)")
    # plants scattered on device
    q_dev = embed_jit(jnp.asarray(q_stream))
    q_dev = q_dev.at[::100].set(jnp.take(s_dev, plant_idx, axis=0))
    # setup sync + log: timestamps the setup/stage boundary
    log("query embeds on device "
        f"({float(jnp.sum(q_dev.astype(jnp.float32))):.0f} checksum)")
    # host embeds for the ORACLE sample only (cpu_nq rows)
    q_emb = embed_shingles_np(
        q_stream[: cpu_nq + cfg.shingle.n - 1], cfg.shingle)
    q_emb[::100] = s_emb[plant_idx[: len(q_emb[::100])]]

    cap = _StageRunner(
        platform, budget_s=float(os.environ.get("BENCH_TIME_BUDGET_S", 900)),
    )
    d = cap.details
    d.update(backend=platform, device_kind=device_kind,
             device=str(jax.devices()[0]), nq=nq, ns=ns)

    def run_kernel(min_keep):
        return topk_dot(
            q_dev, s_pad, ns_valid, k=k, dim=dim, kernels=kernels,
            min_keep=min_keep,
        )

    # Kernel-stage dispatch burst: _time averages over `iters`
    # back-to-back dispatches (the engine pipelines batches without
    # per-batch syncs).
    kernel_iters = int(os.environ.get("BENCH_KERNEL_ITERS", 40))

    _memo: dict = {}

    def get_ovals():
        """Oracle top-k on the shared noise corpus (memoized)."""
        if "ovals" not in _memo:
            _memo["ovals"] = topk_scores_np(q_emb[:cpu_nq], s_emb, k, dim)
        return _memo["ovals"]

    # ---- config #2: fused distance+top-k kernel -------------------------
    def stage_kernel_engine():
        dt = _time(lambda: run_kernel(thr), iters=kernel_iters)
        rate = nq * ns / dt
        log(f"kernel (engine mode, min_keep={thr}): "
            f"{dt*1e3:.3f} ms -> {rate/1e9:.2f} G pairs/s")
        d["kernel_engine_pairs_per_sec"] = rate

    cap.run("kernel_engine", stage_kernel_engine)
    rate_engine = d["kernel_engine_pairs_per_sec"]

    if quick:
        expected_path = Path(__file__).with_name("bench_expected.json")
        ok = True
        if expected_path.exists():
            exp = json.loads(expected_path.read_text())
            basis_iters = exp.get("basis_iters")
            if exp.get("device_kind") != device_kind:
                # a floor is only meaningful on the device it was
                # recorded on
                log(f"quick regression check: recorded floor is from "
                    f"{exp.get('device_kind')!r}, this run is on "
                    f"{device_kind!r} -> FAIL")
                ok = False
            elif basis_iters and basis_iters != kernel_iters:
                # a recorded floor is only meaningful on the timing
                # basis it was measured on; a mismatched basis is a
                # config error, not a pass
                log(f"quick regression check: recorded floor is on a "
                    f"{basis_iters}-dispatch burst basis but this run "
                    f"used {kernel_iters}; set BENCH_KERNEL_ITERS="
                    f"{basis_iters} for a valid compare -> FAIL")
                ok = False
            else:
                floor = exp["kernel_engine_pairs_per_sec"] * 0.80
                ok = rate_engine >= floor
                log(f"quick regression check: {rate_engine/1e9:.1f} G vs "
                    f"recorded "
                    f"{exp['kernel_engine_pairs_per_sec']/1e9:.1f} G "
                    f"(floor 80%) -> {'PASS' if ok else 'FAIL'}")
        else:
            log("no bench_expected.json; skipping regression compare")
        print(json.dumps(driver_line(
            "shingle_pairs_per_sec", round(rate_engine), "pairs/s", 0,
            platform, device_kind,
        )), flush=True)
        return 0 if ok else 1

    def stage_kernel_exact():
        dt = _time(lambda: run_kernel(-float("inf")), iters=kernel_iters)
        rate = nq * ns / dt
        log(f"kernel (exact top-k): {dt*1e3:.1f} ms "
            f"-> {rate/1e9:.2f} G pairs/s")
        d["kernel_exact_pairs_per_sec"] = rate

    cap.run("kernel_exact", stage_kernel_exact)

    # ---- config #1: CPU oracle (the reference algorithm) ----------------
    def stage_cpu_oracle():
        t0 = time.perf_counter()
        ovals, _ = get_ovals()
        cpu_dt = time.perf_counter() - t0
        cpu_rate = cpu_nq * ns / cpu_dt
        log(f"CPU oracle: {cpu_nq}x{ns} in {cpu_dt:.3f}s -> "
            f"{cpu_rate/1e6:.1f} M pairs/s")
        d["cpu_pairs_per_sec"] = cpu_rate
        d["speedup_kernel_vs_cpu"] = rate_engine / cpu_rate

        # recall@10 of the exact kernel vs the oracle (sanity: 1.0)
        kvals, _ = topk_dot(
            q_dev[:cpu_nq], s_pad, ns_valid, k=k, dim=dim, kernels=kernels,
        )
        d["kernel_recall_at_10_vs_oracle"] = _recall_by_score(
            ovals, kvals, dim, k
        )
        log(f"exact-kernel recall@10 vs oracle: "
            f"{d['kernel_recall_at_10_vs_oracle']:.4f}")

    cap.run("cpu_oracle", stage_cpu_oracle)

    # ---- config #3: Smith-Waterman verification rate --------------------
    def stage_sw():
        from fandom_search.ops.smith_waterman import sw_normalized

        r_sw = np.random.default_rng(5)
        B = int(os.environ.get("BENCH_SW_B", 8192))
        w = cfg.search.window_tokens
        mlt = cfg.search.max_line_tokens
        a = r_sw.integers(1, 1000, size=(B, w)).astype(np.uint32)
        b = r_sw.integers(1, 1000, size=(B, mlt)).astype(np.uint32)
        la = np.full(B, w, np.int32)
        lb = np.full(B, mlt, np.int32)
        ad, bd = jnp.asarray(a), jnp.asarray(b)
        # burst-averaged like the kernel stages (the engine dispatches
        # verify inside the fused call, no per-batch sync)
        dt_sw = _time(
            lambda: sw_normalized(ad, bd, la, lb, cfg.search,
                                  kernels=kernels),
            iters=int(os.environ.get("BENCH_SW_ITERS", 20)),
        )
        d["sw_pairs_per_sec"] = B / dt_sw
        d["sw_cells_per_sec"] = B * w * mlt / dt_sw
        log(f"SW verify: {dt_sw*1e3:.1f} ms for {B} pairs -> "
            f"{B/dt_sw:,.0f} pairs/s ({B*w*mlt/dt_sw/1e9:.2f} G cells/s)")

    cap.run("sw", stage_sw)

    # ---- config #4: sharded path (1-device mesh on this box) ------------
    def stage_sharded():
        from fandom_search.config import MeshConfig
        from fandom_search.parallel.mesh import make_mesh
        from fandom_search.parallel.sharded import sharded_topk

        mesh = make_mesh(MeshConfig(works=1, script=1))
        nsv_shards = jnp.asarray([int(ns_valid)], jnp.int32)
        # jit the wrapper: a bare sharded_topk call builds a fresh
        # shard_map closure per call and re-traces
        sharded_jit = jax.jit(
            lambda q_, s_, n_: sharded_topk(
                mesh, q_, s_, n_, k, dim, kernels=kernels, min_keep=thr,
            )
        )
        dt_sh = _time(lambda: sharded_jit(q_dev, s_pad, nsv_shards))
        d["sharded_pairs_per_sec"] = nq * ns / dt_sh
        d["sharded_note"] = (
            "1x1 mesh; works x script meshes are validated on a virtual "
            "8-device CPU mesh by tests/test_sharded.py and the driver's "
            "dryrun_multichip, and on four GPUs by chip_smoke.py --cards 4"
        )
        log(f"sharded (1x1 mesh): {dt_sh*1e3:.1f} ms -> "
            f"{nq*ns/dt_sh/1e9:.2f} G pairs/s")

    cap.run("sharded", stage_sharded)

    # ---- config #5b: SUB-LINEAR bucketed prefilter ----------------------
    # Small-index numbers first (where exact brute force should win),
    # then the large-index regimes (2^20 and 2^22 script shingles — a
    # whole-season index and beyond) where the bucketed path must beat
    # the exact kernel wall-clock at thresholded recall >= 0.99
    # (BASELINE.json:5 "sub-linear"; SURVEY.md §8.7).
    from fandom_search.data.shingler import shingle_hashes

    def measure_bucketed(ns_b, nq_b, tag):
        from fandom_search.ops.bucketed import (
            BucketedIndex, bucketed_candidates_flat,
        )

        r2 = np.random.default_rng(7)
        s_stream = r2.integers(
            0, 2**32, size=ns_b + cfg.shingle.n - 1, dtype=np.uint32
        )
        q_stream = r2.integers(
            0, 2**32, size=nq_b + cfg.shingle.n - 1, dtype=np.uint32
        )
        for qi in range(0, nq_b, 100):  # ~1% plants, 0-2 mutations
            si = int(r2.integers(0, ns_b))
            q_stream[qi : qi + cfg.shingle.n] = s_stream[
                si : si + cfg.shingle.n
            ]
            for p in r2.choice(
                cfg.shingle.n, size=int(r2.integers(0, 3)), replace=False
            ):
                q_stream[qi + p] = r2.integers(0, 2**32, dtype=np.uint32)
        windows = shingle_hashes(s_stream, cfg.shingle)
        # device-side embed from the streams (the stream is 32x smaller
        # than its embedding)
        t0 = time.perf_counter()
        bidx = BucketedIndex.build(windows, cfg.bucketed, cfg.shingle)
        d[f"{tag}_build_seconds"] = time.perf_counter() - t0
        d[f"{tag}_overflow_frac"] = bidx.overflow_frac
        sb_pad, nsv_b = pad_rows(embed_jit(jnp.asarray(s_stream)), 2048)
        qb_dev = embed_jit(jnp.asarray(q_stream))
        qs_dev = jnp.asarray(q_stream)
        smax = cfg.shingle.n * cfg.shingle.n * dim
        max_out = 1 << 16

        def run_exact():
            return topk_dot(
                qb_dev, sb_pad, nsv_b, k=k, dim=dim, kernels=kernels,
                min_keep=thr, max_abs_score=smax,
            )

        def run_bucketed():
            # the flat triple path — exactly what the engine runs
            return bucketed_candidates_flat(
                qs_dev, qb_dev, bidx.entries, bidx.offsets, sb_pad,
                n=cfg.shingle.n, cap=cfg.bucketed.cap,
                num_buckets=bidx.num_buckets, salts=bidx.salts,
                k=k, dim=dim, threshold=thr, max_out=max_out,
            )

        # interleaved A/B
        ev = run_exact()
        _sync(ev[0])
        bt = run_bucketed()
        _sync(bt[2])
        best_e = best_b = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            _sync(run_exact()[0])
            best_e = min(best_e, time.perf_counter() - t0)
            t0 = time.perf_counter()
            _sync(run_bucketed()[2])
            best_b = min(best_b, time.perf_counter() - t0)

        # thresholded recall vs the exact kernel's above-threshold
        # top-k triples, split into the GUARANTEED set (>= 3 true
        # matching positions — the pigeonhole bound) and all: entries
        # with fewer matches are hash noise riding the threshold,
        # which SW verification rejects downstream anyway
        q_windows = shingle_hashes(q_stream, cfg.shingle)
        evn, ein = np.asarray(ev[0]), np.asarray(ev[1])
        qpos_b, sid_b, sc_b = (np.asarray(x) for x in bt[:3])
        got = {}
        for q, s, v in zip(qpos_b, sid_b, sc_b):
            if q >= 0:
                got.setdefault(int(q), []).append(round(float(v) * dim))
        tot = hit = g_tot = g_hit = 0
        for i in range(nq_b):
            keepm = evn[i] >= thr
            if not keepm.any():
                continue
            have = got.get(i, [])
            for v, si in zip(
                np.round(evn[i][keepm] * dim), ein[i][keepm]
            ):
                guaranteed = (
                    int((q_windows[i] == windows[si]).sum()) >= 3
                )
                tot += 1
                g_tot += guaranteed
                if v in have:
                    have.remove(v)
                    hit += 1
                    g_hit += guaranteed
        assert int(np.asarray(bt[3])) <= max_out, "bench budget overflow"
        d[f"{tag}_exact_seconds"] = best_e
        d[f"{tag}_seconds"] = best_b
        d[f"{tag}_speedup_vs_exact"] = best_e / best_b
        d[f"{tag}_thresholded_recall"] = hit / max(1, tot)
        d[f"{tag}_guaranteed_recall"] = g_hit / max(1, g_tot)
        d[f"{tag}_pairs_per_sec_equiv"] = nq_b * ns_b / best_b
        # bucketed_small documents the crossover, it is not the pitch:
        # at small index sizes the exact kernel is expected to win; the
        # sub-linear win lives in the big/huge + skew-hybrid configs
        note = (
            " [expected: exact wins at small index sizes; the "
            "sub-linear configs are bucketed_big/huge/zipf/english]"
            if tag == "bucketed_small" and best_e < best_b else ""
        )
        log(f"bucketed [{tag}] ns={ns_b}: exact {best_e*1e3:.1f} ms vs "
            f"bucketed(flat) {best_b*1e3:.1f} ms (x{best_e/best_b:.2f}), "
            f"thresholded recall {hit/max(1, tot):.4f} "
            f"(guaranteed set {g_hit/max(1, g_tot):.4f}), "
            f"overflow {bidx.overflow_frac:.5f}{note}")

    cap.run("bucketed_small",
            lambda: measure_bucketed(ns, min(nq, 1 << 15), "bucketed_small"))
    big_ns = int(os.environ.get("BENCH_BIG_NS", 1 << 20))
    # the 2^22 regime is where sub-linearity should pay hardest
    huge_ns = int(os.environ.get("BENCH_HUGE_NS", 1 << 22))

    # ---- config #5c/#5d: HYBRID bucketed on skewed vocabularies ---------
    # Real text is Zipfian; hot word-pair buckets overflow cap and the
    # pure bucketed path loses its guarantee.  The hybrid reroutes
    # at-risk queries through the exact kernel; these configs attest
    # recall restoration, the rerouted fraction, and — on English-like
    # skew at 2^20+ — the sub-linear wall-clock win.
    #
    # Two distributions: zipf-1.3 % 50k (top word 29% of tokens, ~5x
    # real English — the adversarial stress case; DESIGN.md §4.4 shows
    # its hot-pair mass pins any 0.99-recall scheme near full reroute)
    # and zipf-1.01 over a 2^19 vocabulary (top word ~2.6% — English
    # prose is ~5-6% "the"; fanfic sits between).  pairs="all" on the
    # english configs makes the guarantee deterministic down to 2
    # matching positions, so the only unreachable exact-top-k entries
    # are pure embedding noise (<=1 true matching position — SW-
    # rejected downstream).
    def measure_skew(tag, *, ns_c, nq_c, zipf_a, vocab, pairs_mode,
                     plant_stride, guarantee_min, seed):
        import dataclasses as _dc

        from fandom_search.ops.bucketed import (
            BucketedIndex, drive_hybrid,
        )

        bcfg = (_dc.replace(cfg.bucketed, pairs=pairs_mode)
                if pairs_mode else cfg.bucketed)
        r = np.random.default_rng(seed)

        def words(count):
            # ranks -> word hashes: heavy head like stopwords.  Same
            # (zipf - 1) % size rank folding as utils/synthetic
            # _draw_idx — ONE skew definition across the repo.  The
            # +1 keeps every word hash NONZERO: hash 0 is the one
            # degenerate key of the multiply-shift sign embedding
            # (0 * m = 0 in every dim -> a constant ±1 vector), so a
            # 2.6%-frequency hash-0 head word floods the exact top-k
            # with non-lexical correlated-embedding noise no lexical
            # prefilter can see (measured: english thresholded recall
            # 0.99 -> 0.53).  Real tokenizer hashes hit 0 with
            # probability ~2^-32; synthetic corpora must not sit on
            # the scheme's single pathological point.
            return (
                (((r.zipf(zipf_a, size=count) - 1) % vocab) + 1)
                .astype(np.uint32) * np.uint32(0x9E3779B9)
            )

        s_stream = words(ns_c + cfg.shingle.n - 1)
        q_stream = words(nq_c + cfg.shingle.n - 1)
        for qi in range(0, nq_c, plant_stride):
            si = int(r.integers(0, ns_c))
            q_stream[qi : qi + cfg.shingle.n] = s_stream[
                si : si + cfg.shingle.n
            ]
        sw_h = shingle_hashes(s_stream, cfg.shingle)
        bidx = BucketedIndex.build(sw_h, bcfg, cfg.shingle)
        d[f"{tag}_overflow_frac"] = bidx.overflow_frac
        # device-side embed from the streams (see measure_bucketed)
        s_padz, nsz = pad_rows(embed_jit(jnp.asarray(s_stream)), 2048)
        q_devz = embed_jit(jnp.asarray(q_stream))
        qs_devz = jnp.asarray(q_stream)
        smax = cfg.shingle.n * cfg.shingle.n * dim
        max_out = 1 << 16
        risk_budget = 1 << 13

        def run_exact():
            return topk_dot(
                q_devz, s_padz, nsz, k=k, dim=dim, kernels=kernels,
                min_keep=thr, max_abs_score=smax,
            )

        def run_hybrid():
            nonlocal risk_budget, max_out
            out, rc, max_out, risk_budget = drive_hybrid(
                qs_devz, q_devz, bidx.entries, bidx.offsets, s_padz, nsz,
                n=cfg.shingle.n, cap=bcfg.cap,
                num_buckets=bidx.num_buckets, salts=bidx.salts,
                k=k, dim=dim, threshold=thr, pairs_mode=bcfg.pairs,
                max_out=max_out, risk_budget=risk_budget,
                kernels=kernels, max_abs_score=smax,
                grow_max_out=True,  # never truncate measured triples
            )
            return out, rc

        ev = run_exact()
        _sync(ev[0])
        (hqp, hsi, hsc, hcnt), rc_n = run_hybrid()
        _sync(hsc)
        best_e = best_h = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            _sync(run_exact()[0])
            best_e = min(best_e, time.perf_counter() - t0)
            t0 = time.perf_counter()
            _sync(run_hybrid()[0][2])
            best_h = min(best_h, time.perf_counter() - t0)

        # thresholded recall of the hybrid triples vs the exact
        # kernel's above-threshold entries, strided sample; split into
        # the guaranteed set when the config carries a pigeonhole bound
        q_wh = shingle_hashes(q_stream, cfg.shingle)
        evn, ein = np.asarray(ev[0]), np.asarray(ev[1])
        hcnt_i = int(np.asarray(hcnt))
        got = {}
        for q, s, v in zip(
            np.asarray(hqp)[:hcnt_i], np.asarray(hsi)[:hcnt_i],
            np.asarray(hsc)[:hcnt_i],
        ):
            if q >= 0:
                got.setdefault(int(q), set()).add(
                    (int(s), round(float(v) * dim))
                )
        tot, hit, g_tot, g_hit = skew_recall_accounting(
            evn, ein, got, q_wh, sw_h, stride=17, thr=thr, dim=dim,
            guarantee_min=guarantee_min,
        )
        d.update({
            f"{tag}_ns": ns_c,
            f"{tag}_risk_frac": rc_n / max(1, nq_c),
            f"{tag}_exact_seconds": best_e,
            f"{tag}_hybrid_seconds": best_h,
            f"{tag}_hybrid_vs_exact": best_e / best_h,
            f"{tag}_thresholded_recall": hit / max(1, tot),
        })
        gmsg = ""
        if guarantee_min is not None:
            d[f"{tag}_guaranteed_recall"] = g_hit / max(1, g_tot)
            gmsg = (f" (guaranteed >={guarantee_min}-match set "
                    f"{g_hit/max(1, g_tot):.4f})")
        log(f"bucketed hybrid [{tag}] ns={ns_c} pairs={bcfg.pairs}: "
            f"overflow {bidx.overflow_frac:.2%}, at-risk {rc_n}/{nq_c} "
            f"({rc_n/max(1,nq_c):.1%}); exact {best_e*1e3:.1f} ms vs "
            f"hybrid {best_h*1e3:.1f} ms (x{best_e/best_h:.2f}); "
            f"thresholded recall {hit/max(1,tot):.4f}{gmsg} "
            f"({tot} entries)")

    # zipf-1.3 is the settled-loss adversarial stress case (the hybrid
    # reroutes ~everything and loses wall-clock — DESIGN.md §4.4 shows
    # why any 0.99-recall scheme must); re-demonstrating it every round
    # burned budget the headline stages needed, so it runs only under
    # BENCH_FULL=1 or an explicit BENCH_ZIPF_NS.
    zipf_ns = int(os.environ.get(
        "BENCH_ZIPF_NS",
        0 if not os.environ.get("BENCH_FULL") else 1 << 20,
    ))
    eng_ns = int(os.environ.get(
        "BENCH_ENGLISH_NS", 1 << 20
    ))
    # The realistic-skew config: english-like skew at 2^22 script
    # shingles with the deterministic >=2-match guarantee.
    eng_huge_ns = int(os.environ.get("BENCH_ENGLISH_HUGE_NS", 1 << 22))

    def run_bucketed_scale_stages():
        """The sub-linear attestation stages, scheduled AFTER the
        headline e2e stages: when the time budget bites, the capture
        should be missing a 2^22 attestation, not the e2e speedup.
        ``est_s`` values are rough wall-second guesses; a capture's
        ``stage_seconds`` has the real ones."""
        if big_ns:
            cap.run("bucketed_big",
                    lambda: measure_bucketed(big_ns, nq, "bucketed_big"),
                    optional=True, est_s=40)
        if eng_ns:
            cap.run("bucketed_english", lambda: measure_skew(
                "bucketed_english", ns_c=eng_ns, nq_c=min(nq, 1 << 16),
                zipf_a=1.01, vocab=1 << 19, pairs_mode="all",
                plant_stride=20, guarantee_min=2, seed=13,
            ), optional=True, est_s=40)
        if huge_ns:
            cap.run("bucketed_huge",
                    lambda: measure_bucketed(huge_ns, nq, "bucketed_huge"),
                    optional=True, est_s=120)
        if eng_huge_ns:
            cap.run("bucketed_english_huge", lambda: measure_skew(
                "bucketed_english_huge", ns_c=eng_huge_ns,
                nq_c=min(nq, 1 << 17),
                zipf_a=1.01, vocab=1 << 19, pairs_mode="all",
                plant_stride=20, guarantee_min=2, seed=13,
            ), optional=True, est_s=150)
        if zipf_ns:
            cap.run("bucketed_zipf", lambda: measure_skew(
                "bucketed_zipf", ns_c=zipf_ns, nq_c=min(nq, 1 << 16),
                zipf_a=1.3, vocab=50000, pairs_mode=None,
                plant_stride=100, guarantee_min=None, seed=11,
            ), optional=True, est_s=40)

    # ---- end-to-end engine vs extrapolated CPU oracle --------------------
    n_works = int(os.environ.get("BENCH_E2E_WORKS", 10000))

    def get_e2e():
        """e2e world + warmed engine + the exact path's rows
        (memoized)."""
        if "e2e" not in _memo:
            from fandom_search.search.engine import SearchEngine

            r_e2e = np.random.default_rng(42)
            t0 = time.perf_counter()
            lines, index, works, _c = make_e2e_world(r_e2e, n_works)
            log(f"e2e corpus: {n_works} works built in "
                f"{time.perf_counter()-t0:.1f}s")
            eng = SearchEngine(index, cfg)
            # Warm with one FULL pass: compiles every stream bucket
            # the timed runs will use (full-cap batches + the final
            # partial bucket) and settles the sticky budgets.  Then
            # re-compile every seen variant at the SETTLED budgets —
            # budget growth mid-warm leaves early buckets stale, and
            # rep 0 would pay a recompile.
            rows0, _s0 = eng.search_works(works)
            t0 = time.perf_counter()
            nvar = eng.precompile_seen()
            log(f"precompiled {nvar} fused variant(s) at settled "
                f"budgets in {time.perf_counter()-t0:.1f}s")
            _memo["e2e"] = (lines, index, works, eng, rows0)
        return _memo["e2e"]

    if not os.environ.get("BENCH_SKIP_E2E"):
        def stage_e2e():
            from fandom_search.search.oracle import search_works_oracle

            _lines, index, works, eng, _rows0 = get_e2e()
            n_cpu_works = int(os.environ.get("BENCH_CPU_E2E_WORKS", 50))
            # time best-of-N full passes
            e2e_reps = int(os.environ.get("BENCH_E2E_REPS", 3))
            e2e_runs = []
            rows = stats = None
            for _ in range(e2e_reps):
                t0 = time.perf_counter()
                rows, stats = eng.search_works(works)
                e2e_runs.append(time.perf_counter() - t0)
            e2e_dt = min(e2e_runs)
            log(f"end-to-end: {n_works} works "
                f"({stats.num_query_shingles} shingles) vs "
                f"{index.num_shingles}-shingle script in {e2e_dt:.2f}s, "
                f"{len(rows)} match rows")

            # CPU baseline on a subsample, extrapolated by query-shingle
            # count: the vectorized NumPy oracle (best reasonable CPU
            # implementation of the algorithm).  The reference's own
            # stack (sklearn BallTree + python-Levenshtein,
            # `search --reference`) needs packages the GPU host lacks.
            sample = dict(list(works.items())[:n_cpu_works])
            t0 = time.perf_counter()
            orows, ostats = search_works_oracle(sample, index, cfg)
            cpu_sample_dt = time.perf_counter() - t0
            scale = (stats.num_query_shingles
                     / max(1, ostats.num_query_shingles))
            cpu_e2e_est = cpu_sample_dt * scale
            log(f"CPU oracle e2e: {cpu_sample_dt:.2f}s for "
                f"{n_cpu_works} works -> extrapolated {cpu_e2e_est:.1f}s "
                f"for {n_works} (x{scale:.1f} by shingle count)")

            # sample row parity: compare the engine's rows restricted
            # to the sampled works against
            # the oracle's rows on the same identity key the CLI
            # --selfcheck uses (scores differ in float detail between
            # the device and NumPy paths; span identity must not).
            sample_ids = set(sample)
            rkey = lambda r: (r.work_id, r.fan_token_start, r.line_no)  # noqa: E731
            eng_sample = {rkey(r) for r in rows if r.work_id in sample_ids}
            o_set = {rkey(r) for r in orows}
            d.update({
                "e2e_works": n_works,
                "e2e_seconds": e2e_dt,
                "e2e_seconds_runs": e2e_runs,
                "e2e_query_shingles": stats.num_query_shingles,
                "e2e_matches": len(rows),
                "e2e_pairs_per_sec": stats.shingle_pairs / e2e_dt,
                # fused engine: one device call per batch; "submit" is
                # the dispatch cost, everything else (device wait +
                # host work) lands in process_seconds
                "e2e_submit_seconds": stats.seconds_device_topk,
                "e2e_process_seconds": stats.seconds_host,
                "cpu_e2e_sample_works": n_cpu_works,
                "cpu_e2e_sample_seconds": cpu_sample_dt,
                "cpu_e2e_extrapolated_seconds": cpu_e2e_est,
                "e2e_speedup_vs_cpu": cpu_e2e_est / e2e_dt,
                "e2e_sample_match_parity": (
                    len(eng_sample & o_set) / max(1, len(o_set))),
                "e2e_sample_missing_rows": len(o_set - eng_sample),
                "e2e_sample_extra_rows": len(eng_sample - o_set),
            })
            log(f"e2e speedup vs CPU oracle: x{cpu_e2e_est/e2e_dt:.0f}; "
                f"sample row parity {d['e2e_sample_match_parity']:.4f} "
                f"({len(o_set)} oracle rows, "
                f"missing {d['e2e_sample_missing_rows']}, "
                f"extra {d['e2e_sample_extra_rows']})")

        # world build + warm + precompile + 3 reps + the CPU baseline
        cap.run("e2e", stage_e2e, optional=True, est_s=240)

        # ---- bucketed e2e row parity ------------------------------------
        # The recall attestation the probe tables can't give: run the
        # SAME corpus through the engine with the bucketed hybrid
        # prefilter attached and compare final MatchRow sets — misses
        # in the bucketed candidate stream must be SW-rejected noise,
        # so the row sets should be identical.
        def stage_bucketed_e2e():
            from fandom_search.ops.bucketed import (
                attach_bucketed_prefilter,
            )
            from fandom_search.search.engine import SearchEngine

            lines, index, works, _eng, rows_exact = get_e2e()
            eng_b = SearchEngine(index, cfg)
            attach_bucketed_prefilter(eng_b, cfg.bucketed)
            eng_b.search_works(works)  # warm/compile pass
            t0 = time.perf_counter()
            rows_b, stats_b = eng_b.search_works(works)
            dt_b = time.perf_counter() - t0
            exact_set, b_set = set(rows_exact), set(rows_b)
            inter = len(exact_set & b_set)
            d.update({
                "bucketed_e2e_works": n_works,
                "bucketed_e2e_seconds": dt_b,
                "bucketed_e2e_rows": len(rows_b),
                "bucketed_e2e_row_parity": inter / max(1, len(exact_set)),
                "bucketed_e2e_missing_rows": len(exact_set - b_set),
                "bucketed_e2e_extra_rows": len(b_set - exact_set),
                "bucketed_e2e_risk_frac": stats_b.extra.get(
                    "bucketed_risk_frac", 0.0),
            })
            ok = not (exact_set - b_set) and not (b_set - exact_set)
            d["bucketed_e2e_parity_ok"] = ok
            d["recall_gate_ok"] = bool(d.get("recall_gate_ok", True)) and ok
            if not ok:
                log("ALERT: bucketed e2e row parity BROKEN — the "
                    "recall gate fails")
            log(f"bucketed e2e parity: {len(rows_b)} rows vs "
                f"{len(exact_set)} exact in {dt_b:.2f}s -> parity "
                f"{inter/max(1,len(exact_set)):.4f} "
                f"(missing {len(exact_set-b_set)}, extra "
                f"{len(b_set-exact_set)}, risk_frac "
                f"{d['bucketed_e2e_risk_frac']:.3f}) "
                "[small script index: the bucketed path's value here "
                "is the parity attestation, not wall-clock]")

        cap.run("bucketed_e2e_parity", stage_bucketed_e2e,
                optional=True, est_s=40)

        # sub-linear attestations AFTER the headline e2e numbers: a
        # budget-squeezed capture drops a 2^22 attestation, not the
        # e2e speedup
        run_bucketed_scale_stages()

        # ---- bucketed e2e at FLAGSHIP index scale -----------------------
        # The small-script parity stage attests the engine wiring; this
        # one attests the headline claim where it actually lives: a
        # whole-franchise script index (2^20 shingles, English-like
        # Zipf skew) searched end-to-end with the hybrid `pairs="all"`
        # bucketed prefilter — final MatchRow set must equal the exact
        # fused path's (candidate misses are <=1-match embedding noise
        # that SW verification rejects downstream; DESIGN.md §4.4), and
        # at this index size the sub-linear path should also WIN
        # wall-clock end-to-end.
        big_e2e_shingles = int(os.environ.get(
            "BENCH_E2E_BIG_SHINGLES", 1 << 20))
        big_e2e_works = int(os.environ.get("BENCH_E2E_BIG_WORKS", 480))

        def stage_bucketed_e2e_big():
            import dataclasses as _dc

            from fandom_search.data.script_parser import parse_script
            from fandom_search.ops.bucketed import (
                attach_bucketed_prefilter,
            )
            from fandom_search.search.engine import SearchEngine
            from fandom_search.search.index import build_script_index
            from fandom_search.utils.synthetic import (
                make_corpus_with_quotes, make_script, make_vocab,
            )

            r_big = np.random.default_rng(23)
            t0 = time.perf_counter()
            # ~30k distinct words is a realistic fanfic-corpus
            # vocabulary; zipf_a=1.01 rank-folding is the same skew
            # recipe as the bucketed_english configs above
            vocab_b = make_vocab(r_big, 30000)
            n_lines = max(1, -(-big_e2e_shingles // 12))
            script_text = make_script(
                r_big, vocab_b, num_lines=n_lines,
                words_per_line=(8, 17), zipf_a=1.01,
            )
            lines_b = parse_script(script_text)
            index_b = build_script_index(lines_b, cfg.shingle, cfg.search)
            # num_edits=1: mutated plants yield 5-of-6-match shingles
            # alongside exact ones, so the parity set exercises the
            # guarantee boundary, not just 6-match slam dunks
            works_b, _pl = make_corpus_with_quotes(
                r_big, [ln.text for ln in lines_b],
                num_works=big_e2e_works, words_per_work=2000,
                quotes_per_work=3, num_edits=1, vocab=vocab_b,
                zipf_a=1.01,
            )
            log(f"big-script world: {index_b.num_shingles} script "
                f"shingles ({n_lines} lines), {big_e2e_works} works "
                f"built in {time.perf_counter()-t0:.1f}s")

            eng_x = SearchEngine(index_b, cfg)
            rows_x, _sx = eng_x.search_works(works_b)  # warm/compile
            eng_x.precompile_seen()  # settle budget-grown variants
            bcfg_b = _dc.replace(cfg.bucketed, pairs="all")
            eng_b2 = SearchEngine(index_b, cfg)
            attach_bucketed_prefilter(eng_b2, bcfg_b)
            rows_b2 = st_b2 = None
            eng_b2.search_works(works_b)               # warm/compile
            dt_x = dt_b2 = float("inf")
            # interleaved A/B; 1 rep by default (the stage's value is
            # the row-parity attestation; the speedup key is a single
            # shot)
            for _ in range(int(os.environ.get("BENCH_E2E_BIG_REPS", 1))):
                t0 = time.perf_counter()
                rows_x, _sx = eng_x.search_works(works_b)
                dt_x = min(dt_x, time.perf_counter() - t0)
                t0 = time.perf_counter()
                rows_b2, st_b2 = eng_b2.search_works(works_b)
                dt_b2 = min(dt_b2, time.perf_counter() - t0)
            ex_set, b_set = set(rows_x), set(rows_b2)
            inter = len(ex_set & b_set)
            d.update({
                "bucketed_e2e_big_script_shingles": index_b.num_shingles,
                "bucketed_e2e_big_works": big_e2e_works,
                "bucketed_e2e_big_overflow_frac":
                    eng_b2.bucketed.overflow_frac,
                "bucketed_e2e_big_exact_seconds": dt_x,
                "bucketed_e2e_big_seconds": dt_b2,
                "bucketed_e2e_big_speedup_vs_exact": dt_x / dt_b2,
                "bucketed_e2e_big_rows": len(rows_b2),
                "bucketed_e2e_big_row_parity":
                    inter / max(1, len(ex_set)),
                "bucketed_e2e_big_missing_rows": len(ex_set - b_set),
                "bucketed_e2e_big_extra_rows": len(b_set - ex_set),
                "bucketed_e2e_big_risk_frac": st_b2.extra.get(
                    "bucketed_risk_frac", 0.0),
            })
            ok = not (ex_set - b_set) and not (b_set - ex_set)
            d["bucketed_e2e_big_parity_ok"] = ok
            d["recall_gate_ok"] = bool(d.get("recall_gate_ok", True)) and ok
            if not ok:
                log("ALERT: bucketed e2e BIG row parity BROKEN — the "
                    "recall gate fails")
            log(f"bucketed e2e BIG ({index_b.num_shingles}-shingle "
                f"english-skew script): exact {dt_x:.2f}s vs hybrid "
                f"{dt_b2:.2f}s (x{dt_x/dt_b2:.2f} e2e); "
                f"{len(rows_b2)} rows vs {len(ex_set)} exact -> parity "
                f"{inter/max(1,len(ex_set)):.4f} (missing "
                f"{len(ex_set-b_set)}, extra {len(b_set-ex_set)}, "
                f"risk_frac {d['bucketed_e2e_big_risk_frac']:.3f})")

        if big_e2e_shingles:
            cap.run("bucketed_e2e_big", stage_bucketed_e2e_big,
                    optional=True, est_s=200)

        # ---- config #4 corpus scale: 100k+ works ----------------------
        scale_works = int(os.environ.get("BENCH_SCALE_WORKS", 100000))
        if scale_works > n_works:
            def stage_scale():
                from fandom_search.utils.synthetic import (
                    make_corpus_with_quotes, make_vocab,
                )

                lines, _index, _works, eng, _rows0 = get_e2e()
                r_sc = np.random.default_rng(43)
                t0 = time.perf_counter()
                works_big, _ = make_corpus_with_quotes(
                    r_sc, [ln.text for ln in lines],
                    num_works=scale_works, words_per_work=2000,
                    quotes_per_work=3, vocab=make_vocab(r_sc, 5000),
                )
                log(f"scale corpus: {scale_works} works built in "
                    f"{time.perf_counter()-t0:.1f}s")
                # 1 rep by default (scale_seconds_runs records how many
                # reps ran)
                scale_reps = int(os.environ.get("BENCH_SCALE_REPS", 1))
                scale_runs = []
                rows_big = stats_big = None
                for _ in range(scale_reps):
                    t0 = time.perf_counter()
                    rows_big, stats_big = eng.search_works(works_big)
                    scale_runs.append(time.perf_counter() - t0)
                dt_big = min(scale_runs)
                d.update({
                    "scale_works": scale_works,
                    "scale_seconds": dt_big,
                    "scale_seconds_runs": scale_runs,
                    "scale_query_shingles": stats_big.num_query_shingles,
                    "scale_matches": len(rows_big),
                    "scale_pairs_per_sec": (
                        stats_big.shingle_pairs / dt_big),
                })
                log(f"scale e2e: {scale_works} works "
                    f"({stats_big.num_query_shingles} shingles) in "
                    f"{dt_big:.1f}s, {len(rows_big)} rows")

            cap.run("scale", stage_scale, optional=True, est_s=250)
    else:
        # e2e explicitly skipped: the sub-linear attestations still run
        run_bucketed_scale_stages()

    Path(FINAL_NAME).write_text(json.dumps(d, indent=2))
    log(f"details -> {FINAL_NAME}")

    print(json.dumps(driver_line(
        "shingle_pairs_per_sec", round(rate_engine), "pairs/s",
        round(rate_engine / d["cpu_pairs_per_sec"], 2)
        if d.get("cpu_pairs_per_sec") else 0,
        platform, device_kind,
    )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
