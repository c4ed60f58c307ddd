"""The search engine — reference `search` subcommand, device-first.

Where the reference fans a process pool over fanwork files and walks a
BallTree per shingle (SURVEY.md section 4.2), this engine:

  1. concatenates a *batch* of fanworks into one fixed-size token
     stream (static shapes; per-work offsets kept on host),
  2. embeds every stream position on device (data/shingler.py),
  3. runs the fused distance+top-k kernel against the device-resident
     script embeddings (ops/distance_topk.py),
  4. gathers verification windows on device and scores them with the
     Smith-Waterman kernel (ops/smith_waterman.py),
  5. chains surviving hits into spans on host (search/chain.py — the
     same code path the oracle uses, so outputs are comparable).

Shapes are bucketed so JIT compiles once per bucket, not per work
(SURVEY.md section 8 "Raggedness").
"""

from __future__ import annotations

import functools
import logging
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fandom_search.config import PipelineConfig
from fandom_search.data.hashing import derive_sign_mults
from fandom_search.data.shingler import embed_shingles
from fandom_search.data.tokenizer import Tokenized
from fandom_search.data.fast_tokenizer import tokenize_many
from fandom_search.ops.backend import use_kernels
from fandom_search.ops.distance_topk import pad_rows, topk_dot
from fandom_search.ops.smith_waterman import sw_normalized
from fandom_search.search.chain import chain_hits_arrays
from fandom_search.search.common import line_segment
from fandom_search.search.index import ScriptIndex
from fandom_search.search.types import MatchRow
from fandom_search.search.vocab_stream import StreamVocab

log = logging.getLogger(__name__)


@dataclass
class EngineStats:
    num_works: int = 0
    num_query_shingles: int = 0
    num_candidates: int = 0
    num_verified: int = 0
    num_batches: int = 0
    seconds_device_topk: float = 0.0
    seconds_device_verify: float = 0.0
    seconds_host: float = 0.0
    extra: Dict[str, float] = field(default_factory=dict)

    @property
    def shingle_pairs(self) -> int:
        """Query-shingle x script-shingle pairs scored (the BASELINE metric)."""
        return self.num_query_shingles * int(self.extra.get("ns", 0))


def _next_pow2(n: int, floor: int) -> int:
    v = floor
    while v < n:
        v *= 2
    return v


class _HitAccumulator:
    """Verified hits as struct-of-arrays, accumulated across batches.

    Work ids intern to integers once per SPAN (~1k strings/batch);
    every per-hit quantity stays a numpy array end-to-end.  The
    per-hit Python objects this replaces cost ~2s per 250k hits at
    the 10k-works benchmark.
    """

    def __init__(self, tokenized: Dict[str, Tokenized] | None = None):
        self.work_ids: List[str] = []
        self._map: Dict[str, int] = {}
        self._parts: List[Tuple[np.ndarray, ...]] = []
        # full-work token counts, for the split-chunk window filter
        # (split chunks only flush after _work_stream has tokenized
        # the whole work, so lookups always succeed).  Identity matters:
        # the engine MUTATES this dict as tokenization streams in, so
        # an initially-empty dict must not be replaced (`or {}` would).
        self._tokenized = tokenized if tokenized is not None else {}

    def span_tables(self, spans):
        """(work_idx, fold_offset, is_split, work_len) per span.

        Split-chunk span ids ("wid\\x00offset") fold back to the work
        here, so downstream arrays never see chunk ids.  work_len is
        the FULL work's token count for split spans (0 otherwise).
        """
        m = len(spans)
        widx = np.empty(m, np.int64)
        fold = np.zeros(m, np.int64)
        split = np.zeros(m, bool)
        wlen = np.zeros(m, np.int64)
        for j, (wid, _, _) in enumerate(spans):
            if "\x00" in wid:
                wid, off = wid.split("\x00")
                fold[j] = int(off)
                split[j] = True
                wlen[j] = len(self._tokenized[wid])
            ix = self._map.get(wid)
            if ix is None:
                ix = len(self.work_ids)
                self._map[wid] = ix
                self.work_ids.append(wid)
            widx[j] = ix
        return widx, fold, split, wlen

    @staticmethod
    def split_window_ok(local, span_of, fold, split, wlen, span_len,
                        window: int, lead: int):
        """Keep-mask for split-chunk hits: the chunk must fully contain
        the ORACLE's verification window for the shingle.

        The oracle centers a ``window``-token window on the shingle
        within the FULL work (clamped to work bounds).  A chunk that
        contains that exact span produces a bit-identical verification;
        a chunk that merely contains the shingle produces a
        boundary-shifted window whose score can differ (one-sidedly
        admitting hits the oracle rejects).  Chunks overlap by
        window-1 tokens, so exactly one chunk satisfies this per
        shingle — the filter both restores oracle parity and makes
        cross-chunk duplicates impossible.
        """
        o = fold[span_of]
        L = span_len[span_of]
        W = wlen[span_of]
        g = local + o
        a0w = np.clip(g - lead, 0, np.maximum(0, W - window))
        ok = (a0w >= o) & (a0w + window <= o + L)
        return np.where(split[span_of], ok, True)

    def add(self, widx, fpos, line, score, vscore, split):
        self._parts.append((widx, fpos, line, score, vscore, split))

    def finalize(self):
        """Concatenate, dedup split-chunk duplicates, return arrays.

        Only hits from split works can repeat (overlapping chunks
        verify the same shingle twice; on-device dedup already made
        (qpos, line) unique within a batch and whole works never span
        batches).  Dedup keeps the max verify score, first arrival on
        ties — same rule as the oracle.
        """
        if not self._parts:
            z = np.zeros(0, np.int64)
            return z, z, z, z.astype(np.float32), z.astype(np.float32)
        widx, fpos, line, sc, vs, split = (
            np.concatenate([p[i] for p in self._parts])
            for i in range(6)
        )
        if split.any():
            keep_plain = np.logical_not(split)
            sw, sf, sl = widx[split], fpos[split], line[split]
            ss, sv = sc[split], vs[split]
            arrival = np.arange(len(sw))
            order = np.lexsort((arrival, -sv, sl, sf, sw))
            sw, sf, sl, ss, sv = (
                sw[order], sf[order], sl[order], ss[order], sv[order]
            )
            first = np.ones(len(sw), bool)
            first[1:] = (
                (sw[1:] != sw[:-1]) | (sf[1:] != sf[:-1])
                | (sl[1:] != sl[:-1])
            )
            widx = np.concatenate([widx[keep_plain], sw[first]])
            fpos = np.concatenate([fpos[keep_plain], sf[first]])
            line = np.concatenate([line[keep_plain], sl[first]])
            sc = np.concatenate([sc[keep_plain], ss[first]])
            vs = np.concatenate([vs[keep_plain], sv[first]])
        return widx, fpos, line, sc, vs


class SearchEngine:
    """Index once, search many fanwork batches.

    The kernels follow the platform (ops/backend.py): the GPU kernels on
    a GPU, the plain path on the CPU.  ``interpret=True`` (tests) runs
    the GPU kernels through the Pallas interpreter instead."""

    def __init__(
        self,
        index: ScriptIndex,
        cfg: PipelineConfig,
        *,
        interpret: bool = False,
    ):
        self.index = index
        self.cfg = cfg
        self.interpret = interpret
        self.kernels = use_kernels(interpret)
        scfg, xcfg = cfg.shingle, cfg.search

        self._mults = jnp.asarray(
            derive_sign_mults(scfg.seed, scfg.n, scfg.dim)
        )
        # Padded script matrix stays host-side until first use: the
        # sharded subclass keeps its own re-padded device copy and
        # never reads this one (only the two-stage path does), so
        # materializing it eagerly would double the index's device
        # footprint under ShardedSearchEngine.
        self._s_emb_padded_host, self._ns_valid = pad_rows(
            np.asarray(index.embeddings), xcfg.script_pad_multiple
        )
        self._s_emb_dev = None
        # script token stream for line-side verify segments (padded so
        # the clip-gather always has one valid element)
        stream = index.stream_hashes
        if stream.shape[0] == 0:
            stream = np.zeros((1,), dtype=np.uint32)
        self._script_stream = jax.device_put(jnp.asarray(stream))

        # Minimum stream-bucket size (see _batches); subclasses raise it
        # to their shard-alignment requirement.
        self._batch_granule = 1 << 14

        # Candidate budget grows (pow2) whenever a batch overflows, so
        # no candidate is ever dropped; the budget is sticky across
        # batches to amortize the recompile.
        self._cand_budget = xcfg.max_candidates_per_batch
        # deduped-candidate budget scales with batch size (bigger
        # batches see proportionally more candidates; starting right
        # avoids a mid-run recompile)
        self._verify_budget = max(2048, xcfg.batch_queries // 64)

        # attribution tables on device for the fused batch path
        def _dev_i32(x):
            a = np.asarray(x, dtype=np.int32)
            if a.shape[0] == 0:
                a = np.zeros((1,), dtype=np.int32)
            return jax.device_put(jnp.asarray(a))

        self._shingle_line_d = _dev_i32(index.shingle_line)
        self._shingle_anchor_d = _dev_i32(index.shingle_anchor)
        self._line_start_d = _dev_i32(index.line_start)
        self._line_len_d = _dev_i32(index.line_lengths)

        # u16 stream compression (search/vocab_stream.py): lossless
        # halving of the fused path's upload payload.
        # Batch 1 always goes raw and frequency-seeds the table.
        self._venc = StreamVocab() if xcfg.stream_compress else None
        self._vtab_dev = None
        self._vtab_ver = -1

        # The fused path runs candidate gen + dedup + window building +
        # verification as ONE jit call per batch: one upload (stream +
        # span table) and one ~320KB pull (verified hits + counts) per
        # batch.  The two-stage path below remains for the bucketed
        # prefilter, which swaps the candidate stage.
        self._use_fused = True

        # Fused-call variants seen so far: (kind, t_pad, p_pad, nspans).
        # A variant's compiled executable is ALSO keyed on the sticky
        # budgets, which grow mid-run on a fresh corpus — buckets that
        # ran before the last growth are stale compiles, and the next
        # pass pays a full recompile for them.  precompile_seen()
        # closes the gap.
        self._seen_variants: dict = {}

        self._candidates_fn = functools.partial(
            _candidates_jit,
            k=xcfg.k,
            dim=scfg.dim,
            shingle_cfg=scfg,
            kernels=self.kernels,
            interpret=interpret,
            threshold=xcfg.candidate_threshold,
        )
        self._verify_fn = functools.partial(
            _verify_jit,
            window=xcfg.window_tokens,
            max_lt=xcfg.max_line_tokens,
            search_cfg=xcfg,
            kernels=self.kernels,
            interpret=interpret,
        )

    @property
    def _s_emb_padded(self):
        """Device copy of the padded script matrix, materialized lazily.

        Never caches a tracer: if the first access happens inside a jit
        trace, the value is returned as a (constant) traced array but
        NOT stored — caching it would permanently poison the engine
        with an escaped tracer.
        """
        if self._s_emb_dev is None:
            dev = jax.device_put(jnp.asarray(self._s_emb_padded_host))
            if isinstance(dev, jax.core.Tracer):
                return dev
            self._s_emb_dev = dev
        return self._s_emb_dev

    # -- batching ----------------------------------------------------------

    def _batches(
        self, items: Iterable[Tuple[str, Tokenized]]
    ) -> Iterable[
        Tuple[List[str], np.ndarray, List[Tuple[str, int, int]], int]
    ]:
        """Pack works into bucketed token streams.

        ``items`` yields (work_id, Tokenized) in stable (sorted) order —
        a dict's sorted items or the overlapped tokenizer stream.
        Yields (work_ids, stream uint32 [T_bucket], spans, fresh) where
        spans is [(work_id, stream_offset, num_tokens)] and fresh is
        the number of not-previously-counted query shingles (split
        chunks exclude their leading overlap).
        """
        cap = self.cfg.search.batch_queries
        n = self.cfg.shingle.n
        # Stream length is bucketed (granule * pow2, clamped to cap) so
        # a short corpus or the run's final partial batch uploads a
        # small buffer instead of the full cap.  Each bucket is one jit
        # shape; the granule*pow2 ladder bounds the variant count at
        # log2(cap/granule)+1.  Bucket sizes stay multiples of the
        # granule, which the sharded engine raises to its works-axis
        # alignment requirement.
        g = min(self._batch_granule, cap)

        def t_pad_for(tokens: int) -> int:
            b = g
            while b < min(tokens, cap):
                b *= 2
            return min(b, cap) + n - 1

        t_pad = t_pad_for

        cur: List[Tuple[str, Tokenized, int]] = []
        cur_len = 0
        for wid, tk in items:
            need = len(tk)
            if need == 0:
                continue
            if need > cap:
                # Pathological work: split into overlapping chunks.
                # Overlap window_tokens-1 (not just n-1) so every
                # shingle sees its FULL verification window inside at
                # least one chunk — chunk starts are cap-ov apart and
                # each chunk fully covers windows starting in its first
                # cap-w+1 positions, so ov >= w-1 guarantees coverage.
                # Duplicated hits in the overlap dedup later by
                # (work, fan_pos, line) keeping the max verify score.
                ov = min(
                    max(n - 1, self.cfg.search.window_tokens - 1), cap - 1
                )
                pos = 0
                while pos < need:
                    end = min(need, pos + cap)
                    piece = Tokenized(
                        text=tk.text,
                        offsets=tk.offsets[pos:end],
                        hashes=tk.hashes[pos:end],
                    )
                    # fresh shingles exclude those already counted in
                    # the previous chunk's overlap (stats exactness)
                    fresh = (
                        end - pos - n + 1 if pos == 0
                        else end - pos - ov
                    )
                    yield from self._flush(
                        [(f"{wid}\x00{pos}", piece, max(0, fresh))], t_pad
                    )
                    if end == need:
                        break
                    pos = end - ov
                continue
            if cur_len + need > cap and cur:
                yield from self._flush(cur, t_pad)
                cur, cur_len = [], 0
            cur.append((wid, tk, need - n + 1))
            cur_len += need
        if cur:
            yield from self._flush(cur, t_pad)

    def _flush(self, items, t_pad_for):
        """One batch: the device upload buffer is built HERE, once.

        Raw layout: u32 [stream tokens (t_pad) | span starts (nspans) |
        span lens (nspans)] — the exact ext array the fused call
        uploads, so _submit_fused never re-copies the 4MB stream.
        When the vocab encoder is warm and the batch's out-of-table
        tokens fit the patch budget, _encode_payload swaps the stream
        section for [packed u16 ids | patch pos | patch hash] and the
        device reconstructs the exact stream (_decode_stream_jit) —
        ~0.56-0.63x the wire bytes.  Unused span slots hold a large
        sentinel start (keeps the device-side searchsorted monotone)
        and zero length.
        """
        tokens = sum(len(tk) for _, tk, _ in items)
        t_pad = t_pad_for(tokens)
        # span-table floor 512: batch-to-batch span counts straddling a
        # pow2 boundary would compile a second fused variant mid-run;
        # 512 covers works >= ~512 tokens at any batch size and costs
        # only 4KB of upload
        nspans = _next_pow2(len(items), 512)
        # ONE allocation holds [stream | span table]: the raw payload
        # is this very array, so no per-batch concatenate/copy later
        ext = np.zeros((t_pad + 2 * nspans,), dtype=np.uint32)
        stream = ext[:t_pad]
        sp = ext[t_pad:]
        sp[:nspans] = 1 << 30
        spans = []
        off = 0
        fresh_total = 0
        for j, (wid, tk, fresh) in enumerate(items):
            m = len(tk)
            stream[off : off + m] = tk.hashes
            sp[j] = off
            sp[nspans + j] = m
            spans.append((wid, off, m))
            off += m
            fresh_total += max(0, fresh)
        payload = self._encode_payload(ext, off, t_pad, nspans)
        yield [w for w, _, _ in spans], payload, spans, fresh_total

    def _encode_payload(self, ext, valid, t_pad, nspans):
        """("enc", c_ext, t_pad, p_pad, nspans) | ("raw", ext, t_pad, nspans).

        The compressed layout (all u32): [packed u16 ids (ceil(t_pad/2))
        | patch positions (p_pad, padded with t_pad so the decode
        scatter drops them) | patch hashes (p_pad) | span table
        (2*nspans)].  Only the fused path decodes, so the two-stage
        path (bucketed prefilter) always gets raw.
        """
        stream = ext[:t_pad]
        sp = ext[t_pad:]
        venc = self._venc
        if venc is not None and self._use_fused:
            if venc.ready:
                p_pad = max(
                    4096, t_pad >> self.cfg.search.stream_patch_shift
                )
                ids, mpos, mhash, total = venc.encode(
                    stream, miss_cap=p_pad
                )
                if total <= p_pad:
                    # admit this batch's misses for FUTURE batches (the
                    # current one patches them regardless)
                    venc.admit(mhash)
                    h = (t_pad + 1) // 2
                    if t_pad % 2:
                        ids = np.concatenate(
                            [ids, np.zeros(1, np.uint16)]
                        )
                    c_ext = np.empty(
                        (h + 2 * p_pad + 2 * nspans,), np.uint32
                    )
                    c_ext[:h] = ids.view(np.uint32)
                    c_ext[h : h + p_pad] = t_pad
                    c_ext[h : h + mpos.size] = mpos
                    c_ext[h + p_pad : h + 2 * p_pad] = 0
                    c_ext[h + p_pad : h + p_pad + mhash.size] = mhash
                    c_ext[h + 2 * p_pad :] = sp
                    return ("enc", c_ext, t_pad, p_pad, nspans)
                # heavy-miss batch: upload raw, learn its frequencies
                venc.admit_counted(stream[:valid])
            else:
                venc.bootstrap(stream[:valid])
        return ("raw", ext, t_pad, nspans)

    def _vocab_table_dev(self):
        """Device copy of the vocab gather table, re-uploaded (256KB)
        only when the table grew since the last upload."""
        if self._vtab_dev is None or self._vtab_ver != self._venc.version:
            self._vtab_dev = jax.device_put(jnp.asarray(self._venc.table()))
            self._vtab_ver = self._venc.version
        return self._vtab_dev

    # -- search ------------------------------------------------------------

    def search_works(
        self,
        works: Dict[str, str] | Dict[str, Tokenized],
    ) -> Tuple[List[MatchRow], EngineStats]:
        stats = EngineStats()
        scfg, xcfg = self.cfg.shingle, self.cfg.search
        if getattr(self, "_bucketed_total_queries", 0):
            # per-search counters (a resident `serve` engine would
            # otherwise blend corpora into one lifetime fraction)
            self._bucketed_risk_queries = 0
            self._bucketed_total_queries = 0
        raw = {w: t for w, t in works.items() if not isinstance(t, Tokenized)}
        tokenized: Dict[str, Tokenized] = {
            wid: t for wid, t in works.items() if isinstance(t, Tokenized)
        }
        stats.num_works = len(works)
        stats.extra["ns"] = float(self.index.num_shingles)
        if self.index.num_shingles == 0:
            return [], stats

        # Tokenization overlaps device work: raw works tokenize in
        # chunks on a worker thread (the C++ tokenizer drops the GIL,
        # and the main thread spends its time blocked on device syncs),
        # one chunk ahead of consumption.  Results accumulate into
        # `tokenized` as they stream past — chaining needs them later.
        items = self._work_stream(raw, tokenized)

        # Pipelined execution: submit batch N+1's device work BEFORE
        # syncing batch N's results, so the device runs ahead while the
        # host processes the previous batch (jax dispatch is async;
        # the device executes in order).  One batch of lookahead keeps
        # at most two streams + outputs in flight.
        acc = _HitAccumulator(tokenized)
        pending: List[Tuple] = []
        # default one batch of lookahead (SearchConfig.lookahead_batches)
        lookahead = max(1, xcfg.lookahead_batches)
        # stage timers (stats.extra): s_batchgen = tokenize+pack wait,
        # s_pull/s_host split inside _process_fused — the three numbers
        # that localize a host-vs-device bottleneck (SURVEY.md §6
        # observability)
        gen = self._batches(items)
        while True:
            t_g = time.perf_counter()
            nxt = next(gen, None)
            stats.extra["s_batchgen"] = (
                stats.extra.get("s_batchgen", 0.0)
                + time.perf_counter() - t_g
            )
            if nxt is None:
                break
            wids, payload, spans, fresh = nxt
            stats.num_batches += 1
            stats.num_query_shingles += fresh
            if self._use_fused:
                pending.append(self._submit_fused(payload, spans, stats))
                if len(pending) > lookahead:
                    self._process_fused(*pending.pop(0), stats, acc)
                continue
            t0 = time.perf_counter()
            ext, t_pad = payload[1], payload[2]   # always "raw" here
            stream_dev = jnp.asarray(ext[:t_pad])
            out = self._candidates_fn(
                stream_dev, self._s_emb_padded, self._ns_valid, self._mults,
                max_out=self._cand_budget,
            )
            stats.seconds_device_topk += time.perf_counter() - t0
            pending.append((stream_dev, spans, self._cand_budget, out))
            if len(pending) > lookahead:
                self._process_batch(*pending.pop(0), stats, acc)
        while pending:
            if self._use_fused:
                self._process_fused(*pending.pop(0), stats, acc)
            else:
                self._process_batch(*pending.pop(0), stats, acc)

        t0 = time.perf_counter()
        widx, fpos, line, sc, vs = acc.finalize()
        rows = chain_hits_arrays(
            widx, fpos, line, sc, vs, acc.work_ids, tokenized,
            self.index, scfg, xcfg,
        )
        stats.seconds_host += time.perf_counter() - t0
        # hybrid bucketed prefilter observability (ops/bucketed.py):
        # ~fraction of stream positions rerouted through the exact
        # kernel (approximate: counted per candidate-fn invocation over
        # padded streams — see the counter definition in bucketed.py)
        if getattr(self, "_bucketed_total_queries", 0):
            stats.extra["bucketed_risk_frac"] = (
                self._bucketed_risk_queries / self._bucketed_total_queries
            )
        return rows, stats

    @staticmethod
    def _work_stream(
        raw: Dict[str, str], tokenized: Dict[str, Tokenized],
        chunk: int = 1024,
    ) -> Iterable[Tuple[str, Tokenized]]:
        """All works in sorted id order; raw text tokenizes one chunk
        ahead on a worker thread and lands in ``tokenized``."""
        import heapq

        pre = iter(sorted(tokenized.items()))
        if not raw:
            yield from pre
            return

        def tokenized_chunks():
            from collections import deque
            from concurrent.futures import ThreadPoolExecutor

            ids = sorted(raw)
            spans = [
                ids[i : i + chunk] for i in range(0, len(ids), chunk)
            ]
            # 3 chunks in flight on 2 pool workers: tokenize_many fans
            # each chunk over its own GIL-free thread pool, so two
            # concurrent chunks saturate host cores while the main
            # thread blocks on device syncs; deeper lookahead only
            # costs memory already owed (`tokenized` keeps every work
            # for chaining).  The single-worker/1-chunk version left
            # the tokenizer idle whenever a device wait outlasted one
            # chunk (round-1 review Weak #2).
            with ThreadPoolExecutor(max_workers=2) as ex:
                pending = deque(
                    ex.submit(tokenize_many, {w: raw[w] for w in sp})
                    for sp in spans[:3]
                )
                nxt = 3
                while pending:
                    done = pending.popleft().result()
                    if nxt < len(spans):
                        pending.append(ex.submit(
                            tokenize_many,
                            {w: raw[w] for w in spans[nxt]},
                        ))
                        nxt += 1
                    tokenized.update(done)
                    yield from sorted(done.items())

        yield from heapq.merge(pre, tokenized_chunks())

    # -- fused batch path ----------------------------------------------------

    def _fused_args(self):
        return (
            self._s_emb_padded, self._ns_valid, self._mults,
            self._script_stream, self._shingle_line_d,
            self._shingle_anchor_d, self._line_start_d, self._line_len_d,
        )

    def _fused_statics(self):
        scfg, xcfg = self.cfg.shingle, self.cfg.search
        return dict(
            k=xcfg.k, dim=scfg.dim, shingle_cfg=scfg, search_cfg=xcfg,
            kernels=self.kernels, interpret=self.interpret,
        )

    def precompile_seen(self) -> int:
        """Compile every fused-call variant seen so far at the CURRENT
        sticky budgets, on synthetic no-match streams.

        Call after a first full pass: budget growth during that pass
        leaves earlier stream buckets compiled at stale budgets, and
        the next pass would pay a fresh XLA compile for each on its
        timed path.  The synthetic stream is a distinct-token iota
        pattern — no candidates, so budgets cannot bump — and the
        compiles land in the persistent jit cache for future processes.
        Returns the number of variants invoked."""
        n = self.cfg.shingle.n
        count = 0
        for kind, t_pad, p_pad, nspans in list(self._seen_variants):
            if kind == "raw":
                ext = np.zeros((t_pad + 2 * nspans,), dtype=np.uint32)
                ext[:t_pad] = (
                    np.arange(t_pad, dtype=np.uint64) * 2654435761
                ).astype(np.uint32)
                sp = ext[t_pad:]
                sp[:nspans] = 1 << 30
                sp[0] = 0
                sp[nspans] = t_pad - (n - 1)
                out = self._fused_call(
                    jnp.asarray(ext), nspans,
                    self._cand_budget, self._verify_budget,
                )
            else:
                # enc layout (see _encode_payload): [packed u16 ids |
                # patch pos (t_pad = dropped by the decode scatter) |
                # patch hash | span table]; zero ids decode to one
                # repeated table word — nonsense, no candidates
                h = (t_pad + 1) // 2
                c_ext = np.zeros(
                    (h + 2 * p_pad + 2 * nspans,), dtype=np.uint32
                )
                c_ext[h : h + p_pad] = t_pad
                sp = c_ext[h + 2 * p_pad :]
                sp[:nspans] = 1 << 30
                sp[0] = 0
                sp[nspans] = t_pad - (n - 1)
                out = self._fused_call_enc(
                    jnp.asarray(c_ext), t_pad, p_pad, nspans,
                    self._cand_budget, self._verify_budget,
                )
            np.asarray(out)  # sync so the compile happens HERE
            count += 1
        return count

    def warm_buckets(self, max_queries: int | None = None) -> int:
        """Pre-compile the smallest and largest-needed stream buckets
        at the current (default) budgets before a first search — the
        batch-CLI `--warm`.

        ``max_queries`` (an estimate of the corpus's total query
        tokens) caps the largest bucket warmed: without it the
        full-cap (2^20-token) fused variant compiles, which is pure
        waste for a small corpus.  Best-effort either way: the
        span-table width of a real batch depends on work sizes (nspans
        floor 512, doubles for small-work corpora), and a quote-dense
        corpus may still grow the budgets mid-run; with the persistent
        jit cache both residuals are one-time costs per corpus shape.

        No-op (returns 0) when a prefilter path is attached
        (``--bucketed`` sets ``_use_fused = False``): those runs dispatch ``_candidates_fn``, and warming fused variants
        they never call would burn the very compile minutes ``--warm``
        exists to save."""
        if not self._use_fused:
            return 0
        cap = self.cfg.search.batch_queries
        n = self.cfg.shingle.n
        g = min(self._batch_granule, cap)
        big = g
        while big < min(max_queries or cap, cap):
            big *= 2
        big = min(big, cap)
        for bucket in {g, big}:
            key = ("raw", bucket + n - 1, 0, 512)
            self._seen_variants.setdefault(key, True)
        return self.precompile_seen()

    def _submit_fused(self, payload, spans, stats: EngineStats):
        t0 = time.perf_counter()
        if payload[0] == "enc":
            _, c_ext, t_pad, p_pad, nspans = payload
            # ONE compressed upload AND one dispatch per batch: the
            # decode is inlined into the fused call (_fused_enc_jit);
            # `call` re-invokes it for budget-overflow retries.
            c_dev = jnp.asarray(c_ext)
            call = functools.partial(
                self._fused_call_enc, c_dev, t_pad, p_pad, nspans
            )
            self._seen_variants[("enc", t_pad, p_pad, nspans)] = True
        else:
            _, ext, t_pad, nspans = payload
            ext_dev = jnp.asarray(ext)  # ONE upload per batch
            call = functools.partial(self._fused_call, ext_dev, nspans)
            self._seen_variants[("raw", t_pad, 0, nspans)] = True
        out = call(self._cand_budget, self._verify_budget)
        stats.seconds_device_topk += time.perf_counter() - t0
        return call, spans, nspans, self._cand_budget, self._verify_budget, out

    def _fused_call(self, ext_dev, nspans, cand_budget, verify_budget):
        return _fused_jit(
            ext_dev, *self._fused_args(),
            cand_budget=cand_budget, verify_budget=verify_budget,
            nspans=nspans, **self._fused_statics(),
        )

    def _fused_call_enc(
        self, c_dev, t_pad, p_pad, nspans, cand_budget, verify_budget
    ):
        return _fused_enc_jit(
            c_dev, self._vocab_table_dev(), *self._fused_args(),
            cand_budget=cand_budget, verify_budget=verify_budget,
            nspans=nspans, t_pad=t_pad, p_pad=p_pad,
            **self._fused_statics(),
        )

    def _process_fused(
        self, call, spans, nspans, cand_budget, verify_budget, out,
        stats: EngineStats, acc: _HitAccumulator,
    ) -> None:
        scfg = self.cfg.shingle
        t0 = time.perf_counter()
        while True:
            t_p = time.perf_counter()
            host = np.asarray(out)  # ONE pull per batch (5 x verify_budget f32)
            stats.extra["s_pull"] = (
                stats.extra.get("s_pull", 0.0) + time.perf_counter() - t_p
            )
            cand_count = int(host[4, 0])
            uniq_count = int(host[4, 1])
            retry = False
            if cand_count > cand_budget:
                cand_budget = _next_pow2(cand_count, cand_budget * 2)
                self._cand_budget = max(self._cand_budget, cand_budget)
                retry = True
            if uniq_count > verify_budget:
                verify_budget = _next_pow2(uniq_count, verify_budget * 2)
                self._verify_budget = max(self._verify_budget, verify_budget)
                retry = True
            if not retry:
                break
            log.info(
                "budget exceeded (cand=%d uniq=%d); retrying batch with "
                "budgets %d/%d", cand_count, uniq_count,
                cand_budget, verify_budget,
            )
            out = call(cand_budget, verify_budget)
        ver_count = int(host[4, 2])
        stats.num_candidates += uniq_count

        starts = np.array([off for _, off, _ in spans], dtype=np.int64)
        # (num_query_shingles counted at batch creation, overlap-exact)

        qpos = host[0, :ver_count].astype(np.int64)
        line = host[1, :ver_count].astype(np.int64)
        score = host[2, :ver_count]
        vscore = host[3, :ver_count]
        span_of = np.searchsorted(starts, qpos, side="right") - 1
        local = qpos - starts[span_of]
        span_widx, span_fold, span_split, span_wlen = acc.span_tables(spans)
        xcfg = self.cfg.search
        span_len = np.array([m for _, _, m in spans], dtype=np.int64)
        keep = acc.split_window_ok(
            local, span_of, span_fold, span_split, span_wlen, span_len,
            xcfg.window_tokens, (xcfg.window_tokens - scfg.n) // 2,
        )
        sp_k = span_of[keep]
        # count AFTER the split-window filter so both engine paths
        # report post-filter verified hits (the two-stage path does)
        stats.num_verified += int(keep.sum())
        acc.add(
            span_widx[sp_k], local[keep] + span_fold[sp_k], line[keep],
            score[keep], vscore[keep], span_split[sp_k],
        )
        stats.seconds_host += time.perf_counter() - t0

    # -- two-stage batch path (bucketed prefilter) --------------------------

    def _process_batch(
        self,
        stream_dev,
        spans: Sequence[Tuple[str, int, int]],
        budget: int,
        out: Tuple,
        stats: EngineStats,
        acc: _HitAccumulator,
    ) -> None:
        scfg, xcfg = self.cfg.shingle, self.cfg.search

        t0 = time.perf_counter()
        # Deferred candidates (e.g. the bucketed hybrid) postpone their
        # data-dependent host sync to HERE — after later batches' device
        # work is already queued — so the lookahead pipeline survives.
        if hasattr(out, "resolve"):
            out = out.resolve()
        qpos_d, sidx_d, score_d, count_d = out
        while True:
            # only the compacted candidate triples cross device->host
            count = int(np.asarray(count_d))
            if count <= budget:
                break
            # Overflow: rerun the batch with a bigger (pow2) budget so
            # nothing is dropped.  The budget is sticky, so a quote-
            # dense corpus pays the recompile once, not per batch.
            budget = _next_pow2(count, budget * 2)
            log.info(
                "candidate budget exceeded (%d); retrying batch with "
                "budget %d", count, budget,
            )
            self._cand_budget = max(self._cand_budget, budget)
            out = self._candidates_fn(
                stream_dev, self._s_emb_padded, self._ns_valid, self._mults,
                max_out=budget,
            )
            if hasattr(out, "resolve"):
                out = out.resolve()
            qpos_d, sidx_d, score_d, count_d = out
        n_kept = count
        # Slice the compacted outputs to a pow2 bucket of the true
        # count before pulling (24KB instead of 768KB per batch).
        pull = min(budget, _next_pow2(max(n_kept, 1), 2048))
        qpos = np.asarray(qpos_d[:pull])[:n_kept].astype(np.int64)
        sidx = np.asarray(sidx_d[:pull])[:n_kept]
        score = np.asarray(score_d[:pull])[:n_kept]
        stats.seconds_device_topk += time.perf_counter() - t0

        t0 = time.perf_counter()

        starts = np.array([off for _, off, _ in spans], dtype=np.int64)
        lens = np.array([m for _, _, m in spans], dtype=np.int64)
        # (num_query_shingles counted at batch creation, overlap-exact)

        if n_kept == 0:
            stats.seconds_host += time.perf_counter() - t0
            return
        # Valid query positions: inside one work's token range. Fully
        # vectorized dedup of (work, fan_pos, line) keeping the max score.
        span_of = np.searchsorted(starts, qpos, side="right") - 1
        ok = (span_of >= 0) & (qpos <= starts[span_of] + lens[span_of] - scfg.n)
        qpos, sidx, score, span_of = qpos[ok], sidx[ok], score[ok], span_of[ok]
        if len(qpos) == 0:
            stats.seconds_host += time.perf_counter() - t0
            return

        local_pos = (qpos - starts[span_of]).astype(np.int64)
        line = self.index.shingle_line[sidx].astype(np.int64)
        # dedup on (span, pos, line) keeping max score: sort by key then
        # score descending, keep first of each key group (stable, so
        # score ties keep the earliest flat candidate — same winner as
        # the oracle's strictly-greater rule)
        order = np.lexsort((-score, line, local_pos, span_of))
        sp_s, pos_s, ln_s, sc_s, si_s = (
            span_of[order], local_pos[order], line[order], score[order],
            sidx[order],
        )
        first = np.ones(len(sp_s), dtype=bool)
        first[1:] = (
            (sp_s[1:] != sp_s[:-1])
            | (pos_s[1:] != pos_s[:-1])
            | (ln_s[1:] != ln_s[:-1])
        )
        sp_u, pos_u, ln_u, sc_u, si_u = (
            sp_s[first], pos_s[first], ln_s[first], sc_s[first], si_s[first]
        )
        ncand = len(sp_u)
        stats.num_candidates += ncand
        stats.seconds_host += time.perf_counter() - t0

        # ---- verification batch (device) --------------------------------
        t0 = time.perf_counter()
        w = xcfg.window_tokens
        lead = (w - scfg.n) // 2
        span_lens = lens[sp_u]
        a0 = np.minimum(
            np.maximum(0, pos_u - lead), np.maximum(0, span_lens - w)
        )
        a1 = np.minimum(span_lens, a0 + w)
        starts_a = (starts[sp_u] + a0).astype(np.int32)
        len_a = (a1 - a0).astype(np.int32)

        # line-side segment anchored at the matched script shingle
        # (full coverage of arbitrarily long lines; common.line_segment)
        anchor = self.index.shingle_anchor[si_u]
        llen = self.index.line_lengths[ln_u]
        b0, len_b = line_segment(anchor, llen, scfg, xcfg)
        starts_b = (self.index.line_start[ln_u] + b0).astype(np.int32)
        len_b = len_b.astype(np.int32)

        # Bucket floor 2048 on the GPU: one steady compile variant
        # instead of one per pow2 size; small floor on the CPU and in
        # interpret mode, where big buckets are slow.
        floor = 2048 if (self.kernels and not self.interpret) else 256
        bucket = _next_pow2(ncand, floor)
        # one packed upload instead of four
        packed = np.zeros((4, bucket), dtype=np.int32)
        packed[0, :ncand] = starts_a
        packed[1, :ncand] = len_a
        packed[2, :ncand] = starts_b
        packed[3, :ncand] = len_b
        scores = self._verify_fn(
            stream_dev, jnp.asarray(packed), self._script_stream
        )
        scores = np.asarray(jax.block_until_ready(scores))[:ncand]
        stats.seconds_device_verify += time.perf_counter() - t0

        t0 = time.perf_counter()
        keep = scores >= xcfg.verify_threshold
        span_widx, span_fold, span_split, span_wlen = acc.span_tables(spans)
        keep &= acc.split_window_ok(
            pos_u, sp_u, span_fold, span_split, span_wlen, lens,
            xcfg.window_tokens, (xcfg.window_tokens - scfg.n) // 2,
        )
        sp_k = sp_u[keep]
        acc.add(
            span_widx[sp_k], pos_u[keep] + span_fold[sp_k],
            ln_u[keep], sc_u[keep], scores[keep], span_split[sp_k],
        )
        stats.num_verified += int(keep.sum())
        stats.seconds_host += time.perf_counter() - t0


# ---------------------------------------------------------------------------
# jitted device functions (module-level so the cache is shared)
# ---------------------------------------------------------------------------


def _decode_stream(c_ext, table, *, t_pad, p_pad, nspans):
    """Reconstruct the raw u32 [t_pad + 2*nspans] stream_ext from a
    compressed upload (SearchEngine._encode_payload): unpack the
    little-endian-packed u16 ids, gather the vocab table, scatter the
    out-of-table patches (pad slots target index t_pad, which
    mode="drop" discards), and re-append the span table verbatim.
    Bit-exact by construction — every id either hits the table entry
    holding its original hash or is overwritten by its patch.
    Inlined into _fused_enc_jit on the hot path; the standalone
    ``_decode_stream_jit`` serves the sharded engine and tests."""
    h = (t_pad + 1) // 2
    v = c_ext[:h]
    ids = jnp.stack([v & 0xFFFF, v >> 16], axis=1).reshape(-1)[:t_pad]
    toks = table[ids]
    ppos = c_ext[h : h + p_pad].astype(jnp.int32)
    phash = c_ext[h + p_pad : h + 2 * p_pad]
    toks = toks.at[ppos].set(phash, mode="drop")
    return jnp.concatenate([toks, c_ext[h + 2 * p_pad :]])


_decode_stream_jit = functools.partial(
    jax.jit, static_argnames=("t_pad", "p_pad", "nspans")
)(_decode_stream)


def nonzero_compact(mask, size: int):
    """Ascending indices of True entries, -1 padded — like
    ``jnp.nonzero(mask, size=size, fill_value=-1)`` but via cumsum +
    unique-scatter.  Entries past ``size`` drop (the callers detect
    overflow via a separate count).
    """
    m = mask.ravel()
    csum = jnp.cumsum(m.astype(jnp.int32))
    src = jnp.arange(m.shape[0], dtype=jnp.int32)
    # Selected slots within budget target csum-1 (unique, in bounds);
    # every other slot targets size+src — unique AND out of bounds, so
    # it drops.  All destinations are globally distinct, which makes
    # the unique_indices promise hold unconditionally (a bare `size`
    # for every dropped slot would be a technical violation of the
    # contract even though OOB writes never land).
    sel = jnp.logical_and(m, csum <= size)
    dest = jnp.where(sel, csum - 1, size + src)
    out = jnp.full((size,), -1, jnp.int32)
    return out.at[dest].set(src, mode="drop", unique_indices=True)


def compact_candidates(vals, idx, threshold, ns, k: int, max_out: int):
    """Threshold-compact the [NQ, k] top-k ON DEVICE.

    Only candidate hits cross the device->host boundary: returns
    (qpos i32 [max_out] with -1 padding, script_idx i32, score f32,
    true_count).  true_count can exceed max_out — the engine detects
    that and reruns the batch with a doubled (pow2) budget, so no
    candidate is ever dropped.
    """
    ok = jnp.logical_and(vals >= threshold, idx < ns)     # [NQ, k]
    count = jnp.sum(ok.astype(jnp.int32))
    # Two-level compaction: rather than a flat nonzero over all NQ*k
    # slots, compact ROWS first (rows with any hit <= true candidate
    # count <= max_out, else the caller retries anyway), which shrinks
    # the expensive scan by k and the second scan to max_out*k elements.  Ordering is preserved: rows ascend,
    # then top-k rank ascends within a row — exactly the flat order.
    row_any = jnp.any(ok, axis=1)                          # [NQ]
    row_budget = min(max_out, ok.shape[0])
    rows = nonzero_compact(row_any, row_budget)
    rsafe = jnp.maximum(rows, 0)
    ok_r = jnp.logical_and(ok[rsafe], (rows >= 0)[:, None])  # [RB, k]
    pos = nonzero_compact(ok_r, max_out)
    safe = jnp.maximum(pos, 0)
    qpos = rsafe[safe // k].astype(jnp.int32)
    score = vals[rsafe].ravel()[safe]
    sidx = idx[rsafe].ravel()[safe]
    valid = pos >= 0
    return (
        jnp.where(valid, qpos, -1),
        jnp.where(valid, sidx, 0),
        score,
        count,
    )


def _candidate_stage(stream, s_emb_padded, ns_valid, mults, *, k, dim,
                     shingle_cfg, kernels, interpret, threshold):
    """Embed the stream and produce thresholded top-k (vals, idx).

    Shared by the two-stage candidates call and the fused batch call so
    the two paths cannot drift.  min_keep = the compaction threshold,
    so sub-threshold rows skip the kernel's top-k merge (the engine
    never reads them)."""
    q_emb = embed_shingles(stream, shingle_cfg, mults=mults)
    return topk_dot(
        q_emb, s_emb_padded, ns_valid, k=k, dim=dim, kernels=kernels,
        interpret=interpret, min_keep=threshold,
        max_abs_score=shingle_cfg.n * shingle_cfg.n * dim,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "dim", "shingle_cfg", "kernels", "interpret",
        "threshold", "max_out",
    ),
)
def _candidates_jit(stream, s_emb_padded, ns_valid, mults, *, k, dim,
                    shingle_cfg, kernels, interpret, threshold, max_out):
    vals, idx = _candidate_stage(
        stream, s_emb_padded, ns_valid, mults, k=k, dim=dim,
        shingle_cfg=shingle_cfg, kernels=kernels,
        interpret=interpret, threshold=threshold,
    )
    return compact_candidates(vals, idx, threshold, ns_valid, k, max_out)


def _fused_impl(
    stream_ext,      # uint32 [T_pad + 2*nspans]: stream | starts | lens
    s_emb_padded, ns_valid, mults,
    script_stream, shingle_line, shingle_anchor, line_start, line_len,
    *, k, dim, shingle_cfg, search_cfg, kernels, interpret,
    cand_budget, verify_budget, nspans,
):
    """One device call per batch: candidates -> dedup -> windows -> SW.

    Returns f32 [5, verify_budget]: rows 0-3 are (qpos, line, score,
    verify_score) of the verified hits; row 4 holds the counts
    (candidates, deduped, verified) in its first three slots.  qpos
    and line are exact in f32 (both far below 2^24).  Dedup keeps the
    max-score candidate per (qpos, line) with stable order on ties —
    the same winner as the oracle's first-strictly-greater rule — and
    its script-shingle index anchors the line-side verify segment.
    """
    n = shingle_cfg.n
    t_pad = stream_ext.shape[0] - 2 * nspans
    stream = stream_ext[:t_pad]
    sp_start = stream_ext[t_pad : t_pad + nspans].astype(jnp.int32)
    sp_len = stream_ext[t_pad + nspans :].astype(jnp.int32)

    # ---- candidates (embed -> fused top-k -> threshold compact) ------
    threshold = search_cfg.candidate_threshold
    vals, idx = _candidate_stage(
        stream, s_emb_padded, ns_valid, mults, k=k, dim=dim,
        shingle_cfg=shingle_cfg, kernels=kernels,
        interpret=interpret, threshold=threshold,
    )
    qpos, sidx, score, cand_count = compact_candidates(
        vals, idx, threshold, ns_valid, k, cand_budget
    )

    def verify_impl(a, b, len_a, len_b):
        return sw_normalized(
            a, b, len_a, len_b, search_cfg, kernels=kernels,
            interpret=interpret,
        )

    return fused_tail(
        stream, sp_start, sp_len, qpos, sidx, score, cand_count,
        script_stream, shingle_line, shingle_anchor, line_start, line_len,
        n=n, dim=dim, search_cfg=search_cfg, verify_budget=verify_budget,
        nspans=nspans, verify_impl=verify_impl,
    )


_fused_jit = functools.partial(
    jax.jit,
    static_argnames=(
        "k", "dim", "shingle_cfg", "search_cfg", "kernels", "interpret",
        "cand_budget", "verify_budget", "nspans",
    ),
)(_fused_impl)


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "dim", "shingle_cfg", "search_cfg", "kernels", "interpret",
        "cand_budget", "verify_budget", "nspans", "t_pad", "p_pad",
    ),
)
def _fused_enc_jit(
    c_ext,           # compressed upload (engine._encode_payload layout)
    table,           # uint32 [65536] vocab gather table
    s_emb_padded, ns_valid, mults,
    script_stream, shingle_line, shingle_anchor, line_start, line_len,
    *, k, dim, shingle_cfg, search_cfg, kernels, interpret,
    cand_budget, verify_budget, nspans, t_pad, p_pad,
):
    """Compressed-upload fused batch: reconstruct the u32 stream_ext
    on device, then run the identical fused pipeline — ONE dispatch
    per batch (a separate decode call would cost an extra dispatch per
    batch)."""
    stream_ext = _decode_stream(
        c_ext, table, t_pad=t_pad, p_pad=p_pad, nspans=nspans
    )
    return _fused_impl(
        stream_ext, s_emb_padded, ns_valid, mults,
        script_stream, shingle_line, shingle_anchor, line_start, line_len,
        k=k, dim=dim, shingle_cfg=shingle_cfg, search_cfg=search_cfg,
        kernels=kernels, interpret=interpret,
        cand_budget=cand_budget, verify_budget=verify_budget, nspans=nspans,
    )


def fused_tail(
    stream, sp_start, sp_len, qpos, sidx, score, cand_count,
    script_stream, shingle_line, shingle_anchor, line_start, line_len,
    *, n, dim, search_cfg, verify_budget, nspans, verify_impl,
):
    """Dedup -> windows -> verification -> verified-hit compaction.

    Shared by the single-device fused call and the sharded engine's
    fused call (which supplies a shard_map-wrapped verify_impl).
    """
    t_pad = stream.shape[0]

    # ---- dedup per (qpos, line), max score, stable ties ---------------
    ok = qpos >= 0
    span_of = jnp.clip(
        jnp.searchsorted(sp_start, qpos, side="right") - 1, 0, nspans - 1
    )
    st = sp_start[span_of]
    ln = sp_len[span_of]
    ok = jnp.logical_and(ok, jnp.logical_and(qpos >= st, qpos <= st + ln - n))
    line = shingle_line[jnp.clip(sidx, 0, shingle_line.shape[0] - 1)]
    bad = jnp.logical_not(ok).astype(jnp.int32)
    # Sort keys packed 4 -> 2 when ranges allow (always, for default
    # configs): k1 = bad<<30 | qpos, k2 = line*width + (smax - score·dim)
    # — the sort is over [cand_budget] and its cost scales with the
    # operand count, so 4 arrays / 2 keys instead of 7 / 4 nearly
    # halves it.  score·dim is an exact integer in [-smax, smax]
    # (int8 embeddings), so the packed value reconstructs score
    # exactly; bad entries pack zeros (their payload is never read).
    # |score * dim| <= n^2 * dim: embedding entries lie in [-n, n]
    # (repeated words stack), so a dot can reach n^2 * dim — same
    # bound the distance kernel's packed selection uses.
    smax = n * n * dim
    width = 1
    while width < 2 * smax + 2:
        width *= 2
    packable = (
        t_pad < (1 << 21)
        and line_start.shape[0] * width < (1 << 30)
    )
    if packable:
        score_i = jnp.where(
            ok, jnp.round(score * dim).astype(jnp.int32), 0
        )
        k1 = (bad << 30) | jnp.maximum(qpos, 0)
        k2 = jnp.where(ok, line, 0) * width + (smax - score_i)
        k1_s, k2_s, sidx_s, spanof_s = jax.lax.sort(
            (k1, k2, sidx, span_of), num_keys=2, is_stable=True,
        )
        bad_s = k1_s >> 30
        qpos_s = k1_s & ((1 << 30) - 1)
        line_s = k2_s // width
        score_s = (smax - k2_s % width).astype(jnp.float32) / dim
    else:
        bad_s, qpos_s, line_s, _, sidx_s, score_s, spanof_s = jax.lax.sort(
            (bad, qpos, line, -score, sidx, score, span_of),
            num_keys=4, is_stable=True,
        )
    first = jnp.logical_and(
        bad_s == 0,
        jnp.concatenate([
            jnp.ones((1,), bool),
            jnp.logical_or(
                qpos_s[1:] != qpos_s[:-1], line_s[1:] != line_s[:-1]
            ),
        ]),
    )
    uniq_count = jnp.sum(first.astype(jnp.int32))
    upos = nonzero_compact(first, verify_budget)
    safe = jnp.maximum(upos, 0)
    uvalid = upos >= 0
    q_u = qpos_s[safe]
    line_u = jnp.clip(line_s[safe], 0, line_start.shape[0] - 1)
    sidx_u = jnp.clip(sidx_s[safe], 0, shingle_anchor.shape[0] - 1)
    sc_u = score_s[safe]
    sp_u = spanof_s[safe]

    # ---- verification windows (fan side + line-side segment) ----------
    w = search_cfg.window_tokens
    lead = (w - n) // 2
    st_u = sp_start[sp_u]
    ln_u = sp_len[sp_u]
    local = q_u - st_u
    a0 = jnp.minimum(jnp.maximum(0, local - lead), jnp.maximum(0, ln_u - w))
    starts_a = st_u + a0
    len_a = jnp.where(uvalid, jnp.minimum(ln_u - a0, w), 0)
    mlt = search_cfg.max_line_tokens
    lead_b = (mlt - n) // 2
    anchor = shingle_anchor[sidx_u]
    llen = line_len[line_u]
    b0 = jnp.minimum(jnp.maximum(0, anchor - lead_b),
                     jnp.maximum(0, llen - mlt))
    starts_b = line_start[line_u] + b0
    len_b = jnp.minimum(llen - b0, mlt)

    # ---- length-sort the verify batch ---------------------------------
    # The SW kernel runs each block of pairs to its longest script
    # segment, so one long pair pins a whole block.  Sorting by
    # len_a+len_b descending makes blocks length-homogeneous (padding
    # rows sort last, into all-empty blocks).  One [VB] sort + gathers
    # + a scatter to restore order; exact (pairs score independently).
    vb = starts_a.shape[0]
    iota_v = jnp.arange(vb, dtype=jnp.int32)
    _, perm = jax.lax.sort(
        (-(len_a + len_b), iota_v), num_keys=1, is_stable=True
    )
    offs = jnp.arange(w, dtype=jnp.int32)[None, :]
    a = jnp.take(
        stream, jnp.clip(starts_a[perm][:, None] + offs, 0, t_pad - 1)
    )
    offs_b = jnp.arange(mlt, dtype=jnp.int32)[None, :]
    b = jnp.take(
        script_stream,
        jnp.clip(
            starts_b[perm][:, None] + offs_b,
            0, script_stream.shape[0] - 1,
        ),
    )
    vscore_p = verify_impl(a, b, len_a[perm], len_b[perm])
    vscore = jnp.zeros((vb,), vscore_p.dtype).at[perm].set(vscore_p)

    # ---- final compact: only verified hits leave the device -----------
    keep = jnp.logical_and(uvalid, vscore >= search_cfg.verify_threshold)
    ver_count = jnp.sum(keep.astype(jnp.int32))
    vpos = nonzero_compact(keep, verify_budget)
    vsafe = jnp.maximum(vpos, 0)
    counts = (
        jnp.zeros((verify_budget,), jnp.float32)
        .at[0].set(cand_count.astype(jnp.float32))
        .at[1].set(uniq_count.astype(jnp.float32))
        .at[2].set(ver_count.astype(jnp.float32))
    )
    return jnp.stack([
        q_u[vsafe].astype(jnp.float32),
        line_u[vsafe].astype(jnp.float32),
        sc_u[vsafe],
        vscore[vsafe],
        counts,
    ])


@functools.partial(
    jax.jit,
    static_argnames=("window", "max_lt", "search_cfg", "kernels",
                     "interpret"),
)
def _verify_jit(stream, packed, script_stream,
                *, window, max_lt, search_cfg, kernels, interpret):
    # packed int32 [4, C]: starts_a, len_a, starts_b, len_b (one upload)
    starts_a, len_a, starts_b, len_b = (
        packed[0], packed[1], packed[2], packed[3]
    )
    # length-sort so SW blocks are length-homogeneous (same rationale
    # as fused_tail: the kernel's trip count is per block)
    c = starts_a.shape[0]
    _, perm = jax.lax.sort(
        (-(len_a + len_b), jnp.arange(c, dtype=jnp.int32)),
        num_keys=1, is_stable=True,
    )
    starts_a, len_a = starts_a[perm], len_a[perm]
    starts_b, len_b = starts_b[perm], len_b[perm]
    offs = jnp.arange(window, dtype=jnp.int32)[None, :]
    gather_idx = jnp.clip(starts_a[:, None] + offs, 0, stream.shape[0] - 1)
    a = jnp.take(stream, gather_idx)                      # [C, window]
    offs_b = jnp.arange(max_lt, dtype=jnp.int32)[None, :]
    gather_b = jnp.clip(
        starts_b[:, None] + offs_b, 0, script_stream.shape[0] - 1
    )
    b = jnp.take(script_stream, gather_b)                 # [C, max_lt]
    vscore = sw_normalized(
        a, b, len_a, len_b, search_cfg, kernels=kernels, interpret=interpret,
    )
    return jnp.zeros((c,), vscore.dtype).at[perm].set(vscore)
