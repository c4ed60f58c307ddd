"""Corpus-sharded search over a device mesh (BASELINE.json:10).

Layout:

  * query (fanwork) shingles  -> sharded over the ``works`` axis,
  * script shingle matrix     -> sharded over the ``script`` axis,
  * each device runs the SAME fused distance+top-k kernel on its
    (query-shard x script-shard) block,
  * per-shard top-k results merge with an ``all_gather`` over the
    ``script`` axis followed by an exact re-top-k — exact because top-k
    of a union is top-k of the per-part top-k's.

The merge is tiny (k entries per query per shard); the heavy traffic
(the score matrix) never exists.  Identical code runs on a virtual CPU
mesh in tests and on the GPUs of one host, where every card reaches
every other at the same rate, so the mesh shape follows the algorithm
alone (SURVEY.md section 5).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from fandom_search.config import PipelineConfig
from fandom_search.data.shingler import embed_shingles
from fandom_search.ops.distance_topk import merge_topk, topk_dot
from fandom_search.ops.smith_waterman import sw_normalized
from fandom_search.parallel.mesh import AXIS_SCRIPT, AXIS_WORKS, make_mesh
from fandom_search.search.engine import SearchEngine, compact_candidates
from fandom_search.search.index import ScriptIndex


def sharded_topk(
    mesh,
    q_emb: jax.Array,       # int8 [NQ, D], NQ % works == 0
    s_emb: jax.Array,       # int8 [NS_pad, D], NS_pad % script == 0
    ns_valid_per_shard,     # int32 [script_shards]
    k: int,
    dim: int,
    *,
    kernels: bool,
    interpret: bool = False,
    min_keep: float = -float("inf"),
    max_abs_score: int = 4608,
) -> Tuple[jax.Array, jax.Array]:
    """Exact global top-k with a works x script sharded mesh."""
    script_shards = mesh.shape[AXIS_SCRIPT]
    ns_per_shard = s_emb.shape[0] // script_shards

    def local(q_l, s_l, nsv_l):
        vals, idx = topk_dot(
            q_l, s_l, nsv_l[0], k=k, dim=dim, kernels=kernels,
            interpret=interpret, min_keep=min_keep,
            max_abs_score=max_abs_score,
        )
        # local -> global script-shingle index
        shard = jax.lax.axis_index(AXIS_SCRIPT)
        idx = idx + shard * ns_per_shard
        # exact merge across the script axis: gather k per shard, then
        # re-rank with the lowest-index tie rule
        all_vals = jax.lax.all_gather(vals, AXIS_SCRIPT, axis=1, tiled=True)
        all_idx = jax.lax.all_gather(idx, AXIS_SCRIPT, axis=1, tiled=True)
        return merge_topk(all_vals, all_idx, k)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(AXIS_WORKS, None), P(AXIS_SCRIPT, None), P(AXIS_SCRIPT)),
        out_specs=(P(AXIS_WORKS, None), P(AXIS_WORKS, None)),
        check_vma=False,
    )
    return fn(q_emb, s_emb, ns_valid_per_shard)


class ShardedSearchEngine(SearchEngine):
    """SearchEngine whose device stages run SPMD over a mesh.

    Drop-in: same search_works() API and identical results; only the
    device execution is sharded.  The host side (batching, candidate
    dedup, chaining) is unchanged — it was never the bottleneck.
    """

    def __init__(
        self,
        index: ScriptIndex,
        cfg: PipelineConfig,
        *,
        mesh=None,
        interpret: bool = False,
    ):
        super().__init__(index, cfg, interpret=interpret)
        self.mesh = mesh if mesh is not None else make_mesh(cfg.mesh)
        scfg, xcfg = cfg.shingle, cfg.search
        works = self.mesh.shape[AXIS_WORKS]
        script = self.mesh.shape[AXIS_SCRIPT]

        if (xcfg.batch_queries % (works * 256)) != 0:
            raise ValueError(
                f"batch_queries ({xcfg.batch_queries}) must be divisible by "
                f"works_shards*256 ({works * 256})"
            )
        # Stream buckets (engine._batches) are granule * pow2, so a
        # granule that is a multiple of works*256 keeps every bucket's
        # query-row count works-shardable.
        unit = works * 256
        self._batch_granule = unit * max(1, self._batch_granule // unit)

        # Re-pad the script matrix so each script shard is tile-aligned.
        ns = index.num_shingles
        per = -(-max(ns, 1) // (script * xcfg.script_pad_multiple))
        per *= xcfg.script_pad_multiple
        s = np.zeros((per * script, scfg.dim), dtype=np.int8)
        s[:ns] = index.embeddings
        self._s_emb_sharded = jax.device_put(jnp.asarray(s))
        self._ns_valid_shards = jnp.clip(
            ns - jnp.arange(script, dtype=jnp.int32) * per, 0, per
        )

        mesh_ = self.mesh
        kern, ip = self.kernels, interpret

        ns_true = index.num_shingles

        @functools.partial(jax.jit, static_argnames=("max_out",))
        def candidates(stream, s_emb, ns_valid_shards, mults, *, max_out):
            q_emb = embed_shingles(stream, scfg, mults=mults)
            vals, idx = sharded_topk(
                mesh_, q_emb, s_emb, ns_valid_shards,
                xcfg.k, scfg.dim, kernels=kern, interpret=ip,
                min_keep=xcfg.candidate_threshold,
                max_abs_score=scfg.n * scfg.n * scfg.dim,
            )
            return compact_candidates(
                vals, idx, xcfg.candidate_threshold, ns_true,
                xcfg.k, max_out,
            )

        # Adapt to the base-class call signature (s_emb/ns_valid ignored
        # in favor of the sharded copies).
        self._candidates_fn = lambda stream, _s, _n, mults, max_out: candidates(
            stream, self._s_emb_sharded, self._ns_valid_shards, mults,
            max_out=max_out,
        )

        # per-shard verify batches stay a multiple of this
        tile_b = 256

        def verify_local(a, b, len_a, len_b):
            return sw_normalized(
                a, b, len_a, len_b, xcfg, kernels=kern, interpret=ip,
            ).reshape(-1, 1)

        verify_sharded = jax.shard_map(
            verify_local,
            mesh=mesh_,
            in_specs=(
                P(AXIS_WORKS, None),
                P(AXIS_WORKS, None),
                P(AXIS_WORKS, None),
                P(AXIS_WORKS, None),
            ),
            out_specs=P(AXIS_WORKS, None),
            check_vma=False,
        )

        def _pad_and_verify(a, b, len_a, len_b):
            """Pad the verify batch to works*tile_b (shard-aligned) and
            run the works-sharded SW; shared by the fused and two-stage
            paths so the padding logic cannot drift."""
            bsz = a.shape[0]
            unit = works * tile_b
            pad = (-bsz) % unit
            if pad:
                a = jnp.pad(a, ((0, pad), (0, 0)))
                b = jnp.pad(b, ((0, pad), (0, 0)))
                len_a = jnp.pad(len_a, (0, pad))
                len_b = jnp.pad(len_b, (0, pad))
            out = verify_sharded(
                a, b, len_a.reshape(-1, 1), len_b.reshape(-1, 1)
            )
            return out[:bsz, 0]


        # ---- fused single-call path over the mesh --------------------
        # Same structure as engine._fused_jit: sharded top-k (script
        # axis merged by a collective) feeds the shared dedup/window/
        # verify tail, with verification shard_mapped over the works
        # axis.
        eng_self = self

        @functools.partial(
            jax.jit,
            static_argnames=("cand_budget", "verify_budget", "nspans"),
        )
        def fused(stream_ext, *, cand_budget, verify_budget, nspans):
            from fandom_search.search.engine import fused_tail

            n = scfg.n
            t_pad = stream_ext.shape[0] - 2 * nspans
            stream = stream_ext[:t_pad]
            sp_start = stream_ext[t_pad : t_pad + nspans].astype(jnp.int32)
            sp_len = stream_ext[t_pad + nspans :].astype(jnp.int32)
            q_emb = embed_shingles(stream, scfg, mults=eng_self._mults)
            vals, idx = sharded_topk(
                mesh_, q_emb, eng_self._s_emb_sharded,
                eng_self._ns_valid_shards, xcfg.k, scfg.dim,
                kernels=kern, interpret=ip,
                min_keep=xcfg.candidate_threshold,
                max_abs_score=scfg.n * scfg.n * scfg.dim,
            )
            qpos, sidx, score, cand_count = compact_candidates(
                vals, idx, xcfg.candidate_threshold, ns_true,
                xcfg.k, cand_budget,
            )

            return fused_tail(
                stream, sp_start, sp_len, qpos, sidx, score, cand_count,
                eng_self._script_stream, eng_self._shingle_line_d,
                eng_self._shingle_anchor_d, eng_self._line_start_d,
                eng_self._line_len_d,
                n=n, dim=scfg.dim, search_cfg=xcfg,
                verify_budget=verify_budget,
                nspans=nspans, verify_impl=_pad_and_verify,
            )

        self._sharded_fused = fused

        @jax.jit
        def verify(stream, packed, script_stream):
            starts_a, len_a, starts_b, len_b = (
                packed[0], packed[1], packed[2], packed[3]
            )
            window = xcfg.window_tokens
            offs = jnp.arange(window, dtype=jnp.int32)[None, :]
            gather_idx = jnp.clip(
                starts_a[:, None] + offs, 0, stream.shape[0] - 1
            )
            a = jnp.take(stream, gather_idx)
            offs_b = jnp.arange(xcfg.max_line_tokens, dtype=jnp.int32)[None, :]
            gather_b = jnp.clip(
                starts_b[:, None] + offs_b, 0, script_stream.shape[0] - 1
            )
            b = jnp.take(script_stream, gather_b)
            return _pad_and_verify(a, b, len_a, len_b)

        self._verify_fn = verify

    def _fused_call(self, ext_dev, nspans, cand_budget, verify_budget):
        return self._sharded_fused(
            ext_dev, cand_budget=cand_budget, verify_budget=verify_budget,
            nspans=nspans,
        )

    def _fused_call_enc(
        self, c_dev, t_pad, p_pad, nspans, cand_budget, verify_budget
    ):
        # The sharded fused call shards its stream input; decode the
        # compressed upload in a standalone step rather than inlining
        # it into the shard_map (one extra dispatch per batch).
        from fandom_search.search.engine import _decode_stream_jit

        ext_dev = _decode_stream_jit(
            c_dev, self._vocab_table_dev(),
            t_pad=t_pad, p_pad=p_pad, nspans=nspans,
        )
        return self._fused_call(ext_dev, nspans, cand_budget, verify_budget)
