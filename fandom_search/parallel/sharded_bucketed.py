"""Mesh-sharded bucketed prefilter (SURVEY.md §3 parallelism, §8.7).

The bucketed stage's natural parallel axis is QUERIES: per-query work
is O(P * cap) regardless of index size, and the inverted tables are
small (P*NS int32 entries) next to the embeddings, so the layout is

  * query token stream  -> sharded over the ``works`` axis (the same
    (n-1)-token ppermute halo exchange),
  * bucket tables + script embeddings -> replicated,
  * per-shard flat candidate triples -> all_gather over ``works`` +
    recompact (k-per-query triples are tiny),
  * at-risk rows (hybrid) -> all_gather of the per-shard masks; the
    exact-kernel rescue (stage 2) runs replicated — it is the
    exceptional path and its row count is small by construction.

On a works x script mesh the script-axis replicas compute identical
results (the tables are index-side and already sub-linear); sharding
the tables over ``script`` would force a cross-device candidate
exchange for no bandwidth win at these table sizes.  Script-heavy
meshes should prefer the exact sharded kernel (parallel/sharded.py).

Retry/merge semantics are the single-device contract, verbatim:
HybridSubmission (ops/bucketed.py) drives both, parametrized over this
module's sharded submit/exact callables.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from fandom_search.config import BucketedConfig
from fandom_search.data.shingler import embed_shingles
from fandom_search.ops.bucketed import (
    BucketedIndex,
    HybridSubmission,
    _flat_impl,
    exact_on_risk_rows,
    validate_and_place_bucketed,
)
from fandom_search.parallel.mesh import AXIS_WORKS


def attach_bucketed_prefilter_sharded(
    engine, cfg: BucketedConfig, bidx: BucketedIndex | None = None
) -> None:
    """Swap a ShardedSearchEngine's candidate stage for the
    query-sharded bucketed pipeline (the mesh analogue of
    ops/bucketed.attach_bucketed_prefilter — same validation, same
    retry/merge contract, same deferred-resolve pipelining)."""
    bidx = validate_and_place_bucketed(engine, cfg, bidx)
    engine.bucketed = bidx
    mesh = engine.mesh
    scfg = engine.cfg.shingle
    xcfg = engine.cfg.search
    s_emb_padded = engine._s_emb_padded   # replicated base-class copy
    interpret = bool(getattr(engine, "interpret", False))
    smax = scfg.n * scfg.n * scfg.dim
    works = mesh.shape[AXIS_WORKS]
    n = scfg.n

    hybrid = cfg.hybrid and bidx.overflow_frac > 0.0

    @functools.partial(
        jax.jit, static_argnames=("max_out", "risk_budget")
    )
    def parts_jit(stream, *, max_out, risk_budget):
        from fandom_search.search.engine import nonzero_compact

        rows = stream.shape[0] - n + 1
        main, tail = stream[:rows], stream[rows:]

        def local(main_l, tail_r):
            rows_l = main_l.shape[0]
            if works > 1:
                head = main_l[: n - 1]
                nxt = jax.lax.ppermute(
                    head, AXIS_WORKS,
                    perm=[(i, i - 1) for i in range(1, works)],
                )
                w_ix = jax.lax.axis_index(AXIS_WORKS)
                halo = jnp.where(w_ix == works - 1, tail_r, nxt)
            else:
                halo = tail_r
            stream_l = jnp.concatenate([main_l, halo])
            q_emb_l = embed_shingles(stream_l, scfg, mults=engine._mults)
            (qp, si, sc, cnt), at_risk = _flat_impl(
                stream_l, q_emb_l, bidx.entries, bidx.offsets,
                s_emb_padded,
                n=n, cap=cfg.cap, num_buckets=bidx.num_buckets,
                salts=bidx.salts, k=xcfg.k, dim=scfg.dim,
                threshold=xcfg.candidate_threshold, max_out=max_out,
                pairs_mode=cfg.pairs, drop_risk=hybrid,
            )
            w_ix = jax.lax.axis_index(AXIS_WORKS)
            qp = jnp.where(qp >= 0, qp + w_ix * rows_l, -1)
            all_qp = jax.lax.all_gather(qp, AXIS_WORKS)
            all_si = jax.lax.all_gather(si, AXIS_WORKS)
            all_sc = jax.lax.all_gather(sc, AXIS_WORKS)
            all_ct = jax.lax.all_gather(cnt, AXIS_WORKS)
            iota = jnp.arange(max_out, dtype=jnp.int32)[None, :]
            validm = (iota < all_ct[:, None]).ravel()
            pos = nonzero_compact(validm, max_out)
            safe = jnp.maximum(pos, 0)
            v = pos >= 0
            qpg = jnp.where(v, all_qp.ravel()[safe], -1)
            sig = jnp.where(v, all_si.ravel()[safe], 0)
            scg = all_sc.ravel()[safe]
            cntg = jnp.sum(all_ct)
            arg = jax.lax.all_gather(at_risk, AXIS_WORKS).ravel()
            risk_rows = nonzero_compact(arg, risk_budget)
            risk_count = jnp.sum(arg.astype(jnp.int32))
            return qpg, sig, scg, cntg, risk_rows, risk_count

        return jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(AXIS_WORKS), P(None)),
            # counts are rank-0 -> P() (replicated scalars)
            out_specs=(P(None), P(None), P(None), P(), P(None), P()),
            check_vma=False,
        )(main, tail)

    if not hybrid:
        # Pure sharded stage 1 (hybrid disabled, or zero overflow so no
        # query can be at risk): plain async 4-tuple, no deferred sync.
        engine._use_fused = False
        engine._candidates_fn = (
            lambda stream, _s, _n, mults, max_out:
                parts_jit(stream, max_out=max_out, risk_budget=1)[:4]
        )
        return

    embed_full = jax.jit(
        lambda stream: embed_shingles(stream, scfg, mults=engine._mults)
    )

    engine._bucketed_risk_budget = max(
        1024, getattr(engine, "_bucketed_risk_budget", 0)
    )
    engine._bucketed_risk_queries = 0
    engine._bucketed_total_queries = 0

    class _DeferredShardedHybrid:
        """Duck-typed deferred candidates (engine._process_batch calls
        ``resolve()``): stage 1 is dispatched at construction so the
        lookahead pipeline stays sync-free; the replicated exact-kernel
        rescue embeds the full stream lazily — only batches that
        actually contain at-risk queries pay for it."""

        def __init__(self, stream, max_out):
            self._stream = stream
            self._stream_len = int(stream.shape[0])

            def submit(mo, rb):
                return parts_jit(stream, max_out=mo, risk_budget=rb)

            def exact(risk_rows, mo):
                return exact_on_risk_rows(
                    embed_full(stream), risk_rows, s_emb_padded,
                    engine._ns_valid,
                    k=xcfg.k, dim=scfg.dim,
                    threshold=xcfg.candidate_threshold, max_out=mo,
                    kernels=engine.kernels, interpret=interpret,
                    max_abs_score=smax,
                )

            self._sub = HybridSubmission(
                submit, exact, max_out=max_out,
                risk_budget=engine._bucketed_risk_budget,
                grow_max_out=False,  # the engine owns the max_out retry
            )

        def resolve(self):
            out, rc, _, engine._bucketed_risk_budget = (
                self._sub.resolve()
            )
            engine._bucketed_risk_queries += rc
            engine._bucketed_total_queries += max(
                0, self._stream_len - n + 1
            )
            return out

    engine._use_fused = False
    engine._candidates_fn = (
        lambda stream, _s, _n, mults, max_out:
            _DeferredShardedHybrid(stream, max_out)
    )
