#!/usr/bin/env python
"""Driver entry shim — the benchmark lives in fandom_search/bench.py

(packaged so `fandomsearch bench` works from an installed wheel; this
shim keeps the repo-root contract: `python bench.py` prints ONE JSON
line on stdout).
"""

import sys

from fandom_search.bench import main

if __name__ == "__main__":
    sys.exit(main())
