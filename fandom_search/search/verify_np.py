"""Host NumPy verification — the oracle twin of the Pallas SW kernel.

The reference verifies candidates with Levenshtein ratio / local
alignment on the underlying strings (SURVEY.md section 3 "Verifier").  The
device build verifies at the *word* level with Smith-Waterman local
alignment over token hashes (cheaper, and hash equality == word
equality up to 2^-32 collisions).  This module is the bit-exact NumPy
reference for the device kernels, plus the Levenshtein-ratio mode for
reference-flavor parity.
"""

from __future__ import annotations

import numpy as np

from fandom_search.config import SearchConfig


def sw_score_np(
    a: np.ndarray,
    b: np.ndarray,
    cfg: SearchConfig,
) -> float:
    """Smith-Waterman best local-alignment score of two token arrays."""
    la, lb = len(a), len(b)
    if la == 0 or lb == 0:
        return 0.0
    h = np.zeros((lb + 1,), dtype=np.float32)
    best = 0.0
    for i in range(la):
        diag_prev = 0.0  # H[i-1, j-1]
        for j in range(1, lb + 1):
            sub = cfg.sw_match if a[i] == b[j - 1] else cfg.sw_mismatch
            val = max(0.0, diag_prev + sub, h[j] + cfg.sw_gap, h[j - 1] + cfg.sw_gap)
            diag_prev = h[j]
            h[j] = val
            if val > best:
                best = val
    return float(best)


def sw_normalized_np(
    a: np.ndarray,
    b: np.ndarray,
    cfg: SearchConfig,
) -> float:
    """Score normalized so a full containment of the shorter side == 1.0."""
    la, lb = len(a), len(b)
    if la == 0 or lb == 0:
        return 0.0
    return sw_score_np(a, b, cfg) / (cfg.sw_match * min(la, lb))


def levenshtein_ratio(s1: str, s2: str) -> float:
    """The reference's verifier (python-Levenshtein ratio), for parity mode."""
    import Levenshtein

    return float(Levenshtein.ratio(s1, s2))
