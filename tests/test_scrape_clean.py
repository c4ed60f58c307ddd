
from fandom_search.scrape.ao3 import (
    ScrapeConfig,
    parse_work_ids,
    scrape_tag,
    tag_search_url,
    work_url,
)
from fandom_search.scrape.clean import (
    clean_corpus,
    extract_meta,
    extract_text,
    load_works_dir,
    write_metadata_csv,
)

from fixtures import broken_page, listing_page, work_page


def test_extract_text_strips_chrome():
    html = work_page("1", "My Title", "auth", ["First para.", "Second para."])
    text = extract_text(html)
    assert "First para." in text and "Second para." in text
    assert "Summary text" not in text
    assert "Chapter Text" not in text
    assert "My Title" not in text


def test_extract_text_broken_returns_none():
    assert extract_text(broken_page()) is None


def test_extract_meta():
    html = work_page("7", "T", "alice_fan", ["one two three"])
    meta = extract_meta(html, work_id="7")
    assert meta["work_id"] == "7"
    assert meta["title"] == "T"
    assert meta["author"] == "alice_fan"
    assert meta["fandoms"] == "Test Fandom"
    assert meta["characters"] == "Alice; Bob"
    assert meta["kudos"] == "42"


def test_clean_corpus_and_metadata(tmp_path):
    src = tmp_path / "raw"
    src.mkdir()
    (src / "1.html").write_text(
        work_page("1", "A", "x", ["word " * 30]), encoding="utf-8"
    )
    (src / "2.html").write_text(broken_page(), encoding="utf-8")
    (src / "3.html").write_text(
        work_page("3", "B", "y", ["too short"]), encoding="utf-8"
    )
    out = tmp_path / "clean"
    kept = clean_corpus(src, out, min_words=10)
    assert kept == ["1"]
    assert (out / "1.txt").exists()

    meta_csv = tmp_path / "meta.csv"
    n = write_metadata_csv(src, meta_csv)
    assert n == 2  # broken page skipped
    assert "alice" not in meta_csv.read_text()  # sanity

    works = load_works_dir(out)
    assert set(works) == {"1"}


def test_parse_work_ids():
    ids = parse_work_ids(listing_page(["11", "22", "33"]))
    assert ids == ["11", "22", "33"]


def test_urls():
    assert tag_search_url("My Tag", 2).endswith("/tags/My%20Tag/works?page=2")
    assert work_url("99").endswith("/works/99?view_full_work=true&view_adult=true")


def test_scrape_tag_resumable(tmp_path):
    pages = {1: ["101", "102"], 2: ["103"], 3: []}
    fetched = []

    def fetch(url):
        fetched.append(url)
        if "/tags/" in url:
            page = int(url.rsplit("page=", 1)[1])
            return listing_page(pages[page])
        wid = url.split("/works/")[1].split("?")[0]
        return work_page(wid, f"W{wid}", "a", ["text " * 20])

    cfg = ScrapeConfig(tag="t", out_dir=tmp_path / "dl", delay_seconds=0)
    got = list(scrape_tag(cfg, fetch=fetch, sleep=lambda s: None))
    assert [p.name for p in got] == ["101.html", "102.html", "103.html"]

    # resume: nothing re-downloaded
    fetched.clear()
    got2 = list(scrape_tag(cfg, fetch=fetch, sleep=lambda s: None))
    assert got2 == []
    assert all("/tags/" in u for u in fetched)  # only listings refetched


def test_scrape_skips_failed_work(tmp_path):
    def fetch(url):
        if "/tags/" in url:
            page = int(url.rsplit("page=", 1)[1])
            return listing_page(["201", "202"]) if page == 1 else listing_page([])
        if "201" in url:
            raise RuntimeError("boom")
        wid = url.split("/works/")[1].split("?")[0]
        return work_page(wid, "W", "a", ["text " * 20])

    cfg = ScrapeConfig(
        tag="t", out_dir=tmp_path / "dl", delay_seconds=0, max_retries=1
    )
    got = list(scrape_tag(cfg, fetch=fetch, sleep=lambda s: None))
    assert [p.name for p in got] == ["202.html"]
