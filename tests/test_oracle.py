import numpy as np
import pytest

from fandom_search.config import PipelineConfig
from fandom_search.data.script_parser import parse_script
from fandom_search.data.tokenizer import tokenize
from fandom_search.search.index import build_script_index
from fandom_search.search.oracle import search_works_oracle, topk_scores_np
from fandom_search.search.verify_np import sw_normalized_np, sw_score_np
from fandom_search.utils.synthetic import (
    make_corpus_with_quotes,
    make_script,
    make_vocab,
)

CFG = PipelineConfig()


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(7)
    vocab = make_vocab(rng, 2000)
    script_text = make_script(rng, vocab, num_lines=30, words_per_line=(7, 14))
    lines = parse_script(script_text)
    index = build_script_index(lines, CFG.shingle, CFG.search)
    return rng, vocab, lines, index


def test_sw_exact_containment():
    a = np.array([1, 2, 3, 4, 5, 6, 7, 8], dtype=np.uint32)
    b = np.array([3, 4, 5, 6], dtype=np.uint32)
    assert sw_normalized_np(a, b, CFG.search) == 1.0


def test_sw_no_overlap():
    a = np.array([1, 2, 3, 4], dtype=np.uint32)
    b = np.array([9, 10, 11, 12], dtype=np.uint32)
    assert sw_normalized_np(a, b, CFG.search) == 0.0


def test_sw_single_substitution():
    a = np.array([1, 2, 99, 4, 5, 6], dtype=np.uint32)
    b = np.array([1, 2, 3, 4, 5, 6], dtype=np.uint32)
    s = sw_score_np(a, b, CFG.search)
    # Best path: 5 matches + 1 mismatch = 5*2 - 1 = 9
    assert s == pytest.approx(9.0)


def test_topk_scores_exact(rng):
    q = rng.integers(-6, 7, size=(50, 128)).astype(np.int8)
    s = rng.integers(-6, 7, size=(200, 128)).astype(np.int8)
    vals, idxs = topk_scores_np(q, s, 10, 128)
    full = q.astype(np.int32) @ s.astype(np.int32).T / 128
    for i in range(50):
        expect = np.sort(full[i])[::-1][:10]
        assert np.allclose(np.sort(vals[i])[::-1], expect)


def test_planted_exact_quotes_all_found(world):
    rng, vocab, lines, index = world
    dialogue = [ln.text for ln in lines]
    works, planted = make_corpus_with_quotes(
        rng, dialogue, num_works=6, words_per_work=200,
        quotes_per_work=2, num_edits=0, vocab=vocab,
    )
    rows, stats = search_works_oracle(works, index, CFG)
    found = {(r.work_id, r.line_no) for r in rows}
    missed = [p for p in planted if (p.work_id, p.line_no) not in found]
    assert not missed, f"missed planted quotes: {missed}"
    # exact quotes must verify at 1.0
    best = {}
    for r in rows:
        key = (r.work_id, r.line_no)
        best[key] = max(best.get(key, 0.0), r.verify_score)
    for p in planted:
        assert best[(p.work_id, p.line_no)] == pytest.approx(1.0)


def test_planted_mutated_quotes_found(world):
    rng, vocab, lines, index = world
    dialogue = [ln.text for ln in lines]
    works, planted = make_corpus_with_quotes(
        rng, dialogue, num_works=6, words_per_work=200,
        quotes_per_work=1, num_edits=1, vocab=vocab,
    )
    rows, _ = search_works_oracle(works, index, CFG)
    found = {(r.work_id, r.line_no) for r in rows}
    hit_rate = sum((p.work_id, p.line_no) in found for p in planted) / len(planted)
    assert hit_rate >= 0.9


def test_random_text_no_matches(world):
    rng, vocab, lines, index = world
    works = {"noise0": " ".join(vocab[i] for i in rng.integers(0, len(vocab), 300))}
    rows, _ = search_works_oracle(works, index, CFG)
    assert rows == []


def test_chaining_merges_adjacent_hits(world):
    rng, vocab, lines, index = world
    # One long quote -> many overlapping shingle hits -> ONE span row.
    line_no = max(range(len(lines)), key=lambda i: len(lines[i].text.split()))
    quote = lines[line_no].text
    noise = " ".join(vocab[i] for i in rng.integers(0, len(vocab), 50))
    works = {"w": f"{noise} {quote} {noise}"}
    rows, _ = search_works_oracle(works, index, CFG)
    same_line = [r for r in rows if r.line_no == line_no]
    assert len(same_line) == 1
    assert same_line[0].num_shingles > 1
    # The reported fan span should contain the quote text (lowercased match)
    assert quote.lower().split()[0] in same_line[0].fan_text.lower()
