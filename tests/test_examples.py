"""The shipped examples/ corpus must keep doing what its README says:
both fanworks quote MARA's lines and the engine attributes them.

Pins the quickstart against example rot (script format drift, engine
behavior changes) — the docs point new users here first.
"""

from pathlib import Path

from fandom_search.config import PipelineConfig
from fandom_search.data.script_parser import parse_script
from fandom_search.search.engine import SearchEngine
from fandom_search.search.index import build_script_index
from fandom_search.search.oracle import search_works_oracle

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def test_examples_quickstart_matches():
    cfg = PipelineConfig()
    lines = parse_script((EXAMPLES / "script.txt").read_text())
    assert any(ln.speaker == "MARA" for ln in lines)  # screenplay cues
    index = build_script_index(lines, cfg.shingle, cfg.search)
    works = {
        p.stem: p.read_text()
        for p in sorted((EXAMPLES / "fanworks").glob("*.txt"))
    }
    assert len(works) == 2
    eng = SearchEngine(index, cfg, interpret=True)
    rows, stats = eng.search_works(works)

    # every fanwork quotes the script; MARA gets attributed
    assert {r.work_id for r in rows} == set(works)
    assert any(r.speaker == "MARA" for r in rows)

    # and the golden oracle agrees row-for-row (the README's
    # --selfcheck promise, asserted directly)
    orows, _ = search_works_oracle(works, index, cfg)
    key = lambda r: (r.work_id, r.fan_token_start, r.line_no)  # noqa: E731
    assert {key(r) for r in rows} == {key(r) for r in orows}
