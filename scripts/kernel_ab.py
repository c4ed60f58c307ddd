#!/usr/bin/env python
"""Each kernel against the plain XLA path, end to end through the fused
batch: the engine's one-call-per-batch program, timed on full 2^20-query
batches of a generated corpus, with the top-k stage and the
Smith-Waterman stage each switched between its kernel and its plain
path (both kernels / plain top-k / plain SW).  Every variant's rows
must equal the both-kernels rows.  Needs a GPU.

Usage: python scripts/kernel_ab.py [n_works] [reps]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from fandom_search.bench import make_e2e_world  # noqa: E402
from fandom_search.ops import distance_topk, smith_waterman  # noqa: E402
from fandom_search.ops.backend import require_gpu  # noqa: E402
from fandom_search.search import engine as E  # noqa: E402


def _plain(fn):
    def call(*a, kernels, **kw):
        return fn(*a, kernels=False, **kw)
    return call


VARIANTS = {
    "kernels": (distance_topk.topk_dot, smith_waterman.sw_normalized),
    "plain_topk": (_plain(distance_topk.topk_dot),
                   smith_waterman.sw_normalized),
    "plain_sw": (distance_topk.topk_dot,
                 _plain(smith_waterman.sw_normalized)),
}


def main():
    n_works = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    require_gpu()
    lines, index, works, cfg = make_e2e_world(np.random.default_rng(0),
                                              n_works)
    tokens = sum(len(t.split()) for t in works.values())
    print(f"{n_works} works, {tokens} tokens, script "
          f"{index.num_shingles} shingles", flush=True)
    want = None
    for rnd in range(2):  # two interleaved rounds: A B C A B C
        for name, (topk, sw) in VARIANTS.items():
            E.topk_dot, E.sw_normalized = topk, sw
            jax.clear_caches()
            eng = E.SearchEngine(index, cfg)
            rows, _ = eng.search_works(works)  # compile, settle budgets
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                rows, stats = eng.search_works(works)
                best = min(best, time.perf_counter() - t0)
            key = sorted(r.to_csv_row() for r in rows)
            if want is None:
                want = key
            print(f"round {rnd} {name}: best {best:.4f} s over {reps} "
                  f"passes ({stats.num_batches} batches, "
                  f"{stats.num_query_shingles / best / 1e6:.2f} M "
                  f"queries/s); rows equal: {key == want}", flush=True)
            if key != want:
                raise SystemExit(f"error: {name} rows differ")
    E.topk_dot, E.sw_normalized = VARIANTS["kernels"]


if __name__ == "__main__":
    main()
