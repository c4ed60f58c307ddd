"""Probe end-to-end wall-clock variance at the 10k-works bench config.

Runs the same search N times in one process, after a warm-up pass, to
separate code regressions from run-to-run noise.  The workload is
bench.py's canonical e2e world (make_e2e_world), so the probe always
measures exactly the shape the bench records.  Needs a GPU.

Usage: python scripts/e2e_probe.py [n_works] [reps]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fandom_search.bench import make_e2e_world
from fandom_search.ops.backend import require_gpu
from fandom_search.search.engine import SearchEngine


def main():
    n_works = int(sys.argv[1]) if len(sys.argv) > 1 else 10000
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    require_gpu()
    rng = np.random.default_rng(0)
    lines, index, works, cfg = make_e2e_world(rng, n_works)
    eng = SearchEngine(index, cfg)
    eng.search_works(works)  # warm: compiles every bucket + budgets
    for i in range(reps):
        t0 = time.perf_counter()
        rows, stats = eng.search_works(works)
        dt = time.perf_counter() - t0
        ex = stats.extra
        print(
            f"run {i}: {dt:.2f}s  submit={stats.seconds_device_topk:.2f} "
            f"process={stats.seconds_host:.2f} "
            f"batchgen={ex.get('s_batchgen', 0):.2f} "
            f"pull={ex.get('s_pull', 0):.2f} rows={len(rows)} "
            f"shingles={stats.num_query_shingles}"
        )


if __name__ == "__main__":
    main()
