"""fandom_search — an accelerator text-reuse search engine.

A brand-new JAX/XLA/Pallas framework with the capabilities of
``senderle/fandom-search`` (see SURVEY.md): find every quotation and
near-quotation of a source script inside a large fan-fiction corpus.

Pipeline (reference behavior, GPU realization):

  scrape (host)  ->  clean/extract (host)  ->  tokenize+hash (host/C++)
      ->  shingle-embed (device, signed random features)
      ->  fused distance + top-k (Pallas/Triton kernel, int8 tensor cores)
      ->  Smith-Waterman verification (Pallas/Triton kernel)
      ->  span chaining  ->  CSV / engagement matrix (host)

Reference parity map is documented per-module; the reference mount was
empty at survey time, so citations point at SURVEY.md sections instead
of reference file:line (see SURVEY.md section 0 for the evidence basis).
"""

__version__ = "0.3.0"  # keep in sync with pyproject.toml [project].version

from fandom_search.config import (  # noqa: F401
    ShingleConfig,
    SearchConfig,
    MeshConfig,
    PipelineConfig,
)
