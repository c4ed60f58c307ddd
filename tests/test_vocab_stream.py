"""u16 stream compression: StreamVocab + device decode bit-parity.

The encoding must be LOSSLESS under table growth: a payload encoded at
table version V is decoded on device against version >= V (the engine
admits each batch's misses before the batch's table upload), so ids
must be stable across admissions (vocab_stream.py append-only
contract).
"""

import numpy as np
import pytest

from fandom_search.search.vocab_stream import CAPACITY, SENTINEL, StreamVocab


def _roundtrip(vocab, stream):
    """Host-side reconstruction mirroring engine._decode_stream_jit."""
    ids, mpos, mhash, _ = vocab.encode(stream)
    table = vocab.table()
    out = table[ids.astype(np.int64)]
    out[mpos] = mhash
    return out, ids, mpos


def test_bootstrap_then_roundtrip():
    rng = np.random.default_rng(0)
    v = StreamVocab()
    assert not v.ready
    first = rng.integers(1, 2**32, 5000, dtype=np.uint32)
    v.bootstrap(first)
    assert v.ready
    out, ids, mpos = _roundtrip(v, first)
    np.testing.assert_array_equal(out, first)
    assert mpos.size == 0  # everything admitted at bootstrap
    assert not np.any(ids == SENTINEL)


def test_misses_patch_and_roundtrip():
    rng = np.random.default_rng(1)
    v = StreamVocab()
    v.bootstrap(rng.integers(1, 2**20, 1000, dtype=np.uint32))
    # stream with ~half out-of-table hashes (different range)
    stream = np.concatenate(
        [
            rng.integers(1, 2**20, 500, dtype=np.uint32),
            rng.integers(2**24, 2**32, 500, dtype=np.uint32),
        ]
    )
    rng.shuffle(stream)
    out, ids, mpos = _roundtrip(v, stream)
    np.testing.assert_array_equal(out, stream)
    assert mpos.size > 0
    assert np.all(ids[mpos] == SENTINEL)


def test_ids_stable_across_admission():
    """Append-only contract: admitting new hashes must not move ids of
    existing entries — in-flight payloads decode against newer tables."""
    rng = np.random.default_rng(2)
    v = StreamVocab()
    base = rng.integers(1, 2**31, 3000, dtype=np.uint32)
    v.bootstrap(base)
    ids_before, _, _, _ = v.encode(base)
    table_before = v.table()
    # admit hashes that would sort BEFORE and AFTER the existing ones
    v.admit(np.array([1, 2, 3, 2**32 - 5, 2**32 - 4], dtype=np.uint32))
    ids_after, _, _, _ = v.encode(base)
    np.testing.assert_array_equal(ids_before, ids_after)
    # old table slots unchanged; only appended slots differ
    table_after = v.table()
    np.testing.assert_array_equal(
        table_before[: v.size - 5], table_after[: v.size - 5]
    )
    # and a payload encoded pre-admission decodes against the NEW table
    out = table_after[ids_before.astype(np.int64)]
    np.testing.assert_array_equal(out, base)


def test_capacity_and_priority():
    """At capacity, frequency-seeded admission keeps the heaviest words."""
    v = StreamVocab()
    rng = np.random.default_rng(3)
    uniq = rng.permutation(np.arange(1, CAPACITY + 2000, dtype=np.uint32))
    heavy = uniq[:100]
    stream = np.concatenate([np.repeat(heavy, 50), uniq])
    rng.shuffle(stream)
    v.bootstrap(stream)
    assert v.size == CAPACITY
    ids, mpos, _, _ = v.encode(heavy)
    assert mpos.size == 0  # every heavy word made the table
    assert not np.any(ids == SENTINEL)
    # further admission is a no-op at capacity
    ver = v.version
    v.admit(np.array([2**32 - 1], dtype=np.uint32))
    assert v.version == ver


def test_zero_pad_tail_is_free():
    """Hash 0 is pre-seeded so zero-padded stream tails never patch."""
    v = StreamVocab()
    v.bootstrap(np.array([7, 9, 11], dtype=np.uint32))
    tail = np.zeros(64, np.uint32)
    _, mpos, _, nmiss = v.encode(tail)
    assert mpos.size == 0 and nmiss == 0


def test_native_numpy_encode_parity_and_miss_cap(monkeypatch):
    """fs_encode_stream (C probe table) and the searchsorted fallback
    produce identical encodings, and miss_cap truncates the patch
    arrays while the returned total stays exact on both paths."""
    from fandom_search.data import fast_tokenizer

    if fast_tokenizer.get_lib() is None:
        pytest.skip("native fastingest unavailable")
    rng = np.random.default_rng(5)
    v = StreamVocab()
    pool = rng.integers(1, 2**26, 3000, dtype=np.uint32)
    v.bootstrap(pool)
    stream = np.concatenate(
        [
            rng.choice(pool, 2000).astype(np.uint32),
            rng.integers(2**28, 2**32, 300, dtype=np.uint32),
        ]
    )
    rng.shuffle(stream)
    nat = v.encode(stream)
    monkeypatch.setattr(fast_tokenizer, "get_lib", lambda: None)
    ref = v.encode(stream)
    for a, b in zip(nat[:3], ref[:3]):
        np.testing.assert_array_equal(a, b)
    assert nat[3] == ref[3] > 0
    monkeypatch.undo()
    cap = nat[3] // 2
    for use_native in (True, False):
        if not use_native:
            monkeypatch.setattr(fast_tokenizer, "get_lib", lambda: None)
        ids_c, mpos_c, mhash_c, total_c = v.encode(stream, miss_cap=cap)
        np.testing.assert_array_equal(ids_c, nat[0])
        np.testing.assert_array_equal(mpos_c, nat[1][:cap])
        np.testing.assert_array_equal(mhash_c, nat[2][:cap])
        assert total_c == nat[3]


def test_device_decode_bit_parity():
    """engine._decode_stream_jit reconstructs the exact u32 stream_ext."""
    import jax.numpy as jnp

    from fandom_search.search.engine import _decode_stream_jit

    rng = np.random.default_rng(4)
    v = StreamVocab()
    pool = np.unique(rng.integers(1, 2**28, 4000, dtype=np.uint32))
    v.bootstrap(pool)
    t_pad, nspans, p_pad = 1024, 8, 64
    stream = np.zeros(t_pad, np.uint32)
    valid = 900
    stream[:valid] = np.concatenate(
        [
            rng.choice(pool, valid - 20).astype(np.uint32),
            rng.integers(2**30, 2**32, 20, dtype=np.uint32),  # misses
        ]
    )
    rng.shuffle(stream[:valid])
    sp = rng.integers(0, 2**20, 2 * nspans, dtype=np.uint32)
    ids, mpos, mhash, _ = v.encode(stream)
    assert 0 < mpos.size <= p_pad
    h = (t_pad + 1) // 2
    c_ext = np.empty(h + 2 * p_pad + 2 * nspans, np.uint32)
    c_ext[:h] = ids.view(np.uint32)
    c_ext[h : h + p_pad] = t_pad  # pad patch slots -> dropped by scatter
    c_ext[h : h + mpos.size] = mpos
    c_ext[h + p_pad : h + 2 * p_pad] = 0
    c_ext[h + p_pad : h + p_pad + mhash.size] = mhash
    c_ext[h + 2 * p_pad :] = sp
    out = np.asarray(
        _decode_stream_jit(
            jnp.asarray(c_ext), jnp.asarray(v.table()),
            t_pad=t_pad, p_pad=p_pad, nspans=nspans,
        )
    )
    np.testing.assert_array_equal(out[:t_pad], stream)
    np.testing.assert_array_equal(out[t_pad:], sp)


@pytest.mark.parametrize("compress", [True, False])
def test_engine_rows_identical_with_and_without_compression(world2, compress):
    """The compressed upload path is invisible to results: identical
    MatchRows with stream_compress on and off across multiple batches
    (batch 1 bootstraps raw; later batches ride the encoded path)."""
    import dataclasses

    works, index, cfg = world2
    from fandom_search.search.engine import SearchEngine

    scfg = dataclasses.replace(
        cfg.search, stream_compress=compress, batch_queries=512
    )
    eng = SearchEngine(index, dataclasses.replace(cfg, search=scfg))
    rows, stats = eng.search_works(works)
    assert stats.num_batches > 1  # encoded path exercised past bootstrap
    keyed = sorted(
        (r.work_id, r.fan_token_start, r.fan_token_end, r.line_no,
         round(r.score, 4), round(r.verify_score, 4))
        for r in rows
    )
    # store on the module so both parametrizations compare
    ref = _ROWS.setdefault("rows_ref", keyed)
    assert keyed == ref
    if compress:
        assert eng._venc is not None and eng._venc.ready
    else:
        assert eng._venc is None


_ROWS: dict = {}


@pytest.fixture(scope="module")
def world2():
    from fandom_search.config import PipelineConfig
    from fandom_search.data.script_parser import parse_script
    from fandom_search.search.index import build_script_index
    from fandom_search.utils.synthetic import (
        make_corpus_with_quotes,
        make_script,
        make_vocab,
    )

    cfg = PipelineConfig()
    rng = np.random.default_rng(21)
    vocab = make_vocab(rng, 1200)
    script_text = make_script(rng, vocab, num_lines=20, words_per_line=(7, 12))
    lines = parse_script(script_text)
    index = build_script_index(lines, cfg.shingle, cfg.search)
    works, _ = make_corpus_with_quotes(
        rng, [ln.text for ln in lines], num_works=10, words_per_work=400,
        quotes_per_work=2, num_edits=1, vocab=vocab,
    )
    return works, index, cfg
