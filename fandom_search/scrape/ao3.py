"""AO3 scraper — reference layer L1 (SURVEY.md sections 2, 4.1).

Walks an Archive of Our Own tag's works listing and downloads each work
as one HTML file.  This is deliberately host-side, I/O-bound code —
"scraping is I/O, not device work" (SURVEY.md section 3) — with the reference's
operational behavior preserved:

  * politeness: a mandatory multi-second sleep between requests, and an
    exponential backoff on HTTP 429 ("Retry-After" honored when given);
  * resumability: page range is settable, already-downloaded works are
    skipped, so a crashed run re-run with the same args just continues
    (SURVEY.md section 6 "Failure detection");
  * one file per work: ``<outdir>/<work_id>.html``.

Network access is injected (``fetch``), so tests run on recorded HTML
fixtures with zero live traffic (SURVEY.md section 5 "Scraper tests").
"""

from __future__ import annotations

import logging
import re
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterator, Optional
from urllib.parse import quote

log = logging.getLogger(__name__)

AO3_BASE = "https://archiveofourown.org"
_WORK_HREF_RE = re.compile(r"^/works/(\d+)$")


@dataclass
class ScrapeConfig:
    tag: str
    out_dir: Path
    start_page: int = 1
    end_page: Optional[int] = None     # None: until an empty page
    delay_seconds: float = 5.0
    max_retries: int = 3
    backoff_seconds: float = 60.0


FetchFn = Callable[[str], str]  # url -> html (raises on HTTP error)


def _parse_retry_after(value: str) -> float:
    """Retry-After per RFC 7231: delta-seconds OR an HTTP-date."""
    try:
        return max(0.0, float(value))
    except ValueError:
        pass
    try:
        from email.utils import parsedate_to_datetime

        dt = parsedate_to_datetime(value)
        return max(0.0, dt.timestamp() - time.time())
    except Exception:  # noqa: BLE001 — malformed header: default backoff
        return 60.0


def default_fetch(url: str) -> str:
    import requests

    resp = requests.get(
        url,
        headers={"User-Agent": "fandom-search (research; polite bot)"},
        timeout=60,
    )
    if resp.status_code == 429:
        retry = _parse_retry_after(resp.headers.get("Retry-After", "60"))
        raise RateLimited(retry)
    resp.raise_for_status()
    return resp.text


class RateLimited(Exception):
    def __init__(self, retry_after: float):
        super().__init__(f"rate limited; retry after {retry_after}s")
        self.retry_after = retry_after


def tag_search_url(tag: str, page: int) -> str:
    return f"{AO3_BASE}/tags/{quote(tag, safe='')}/works?page={page}"


def work_url(work_id: str) -> str:
    return f"{AO3_BASE}/works/{work_id}?view_full_work=true&view_adult=true"


def parse_work_ids(listing_html: str) -> list[str]:
    """Work ids linked from a tag-search results page."""
    from bs4 import BeautifulSoup

    soup = BeautifulSoup(listing_html, "html.parser")
    ids = []
    for li in soup.select("li.work"):
        for a in li.select("h4 a[href]"):
            m = _WORK_HREF_RE.match(a["href"])
            if m:
                ids.append(m.group(1))
                break
    if ids:
        return ids
    # fallback: any /works/<id> link (AO3 markup drift)
    seen = []
    for a in soup.find_all("a", href=True):
        m = _WORK_HREF_RE.match(a["href"])
        if m and m.group(1) not in seen:
            seen.append(m.group(1))
    return seen


def _fetch_with_retries(
    fetch: FetchFn,
    url: str,
    cfg: ScrapeConfig,
    sleep: Callable[[float], None] = time.sleep,
) -> Optional[str]:
    # ``sleep`` is injected all the way down (not just in scrape_tag)
    # so fixture-driven tests of the retry/backoff paths never really
    # sleep, honoring the module's zero-live-traffic test contract.
    for attempt in range(cfg.max_retries):
        try:
            return fetch(url)
        except RateLimited as e:
            wait = max(e.retry_after, cfg.backoff_seconds * (attempt + 1))
            log.warning("429 on %s; sleeping %.0fs", url, wait)
            sleep(wait)
        except Exception as e:  # noqa: BLE001 — skip-and-continue by design
            log.warning("fetch failed (%s) on %s [attempt %d]", e, url, attempt + 1)
            sleep(cfg.delay_seconds * (attempt + 1))
    return None


def scrape_tag(
    cfg: ScrapeConfig,
    fetch: FetchFn = default_fetch,
    sleep: Callable[[float], None] = time.sleep,
) -> Iterator[Path]:
    """Download all works of a tag; yields the path of each saved work."""
    cfg.out_dir.mkdir(parents=True, exist_ok=True)
    page = cfg.start_page
    while cfg.end_page is None or page <= cfg.end_page:
        listing = _fetch_with_retries(
            fetch, tag_search_url(cfg.tag, page), cfg, sleep
        )
        if listing is None:
            log.error("giving up on page %d", page)
            break
        ids = parse_work_ids(listing)
        if not ids:
            log.info("page %d empty; done", page)
            break
        for wid in ids:
            out = cfg.out_dir / f"{wid}.html"
            if out.exists():
                log.debug("skip existing %s", wid)
                continue
            sleep(cfg.delay_seconds)
            html = _fetch_with_retries(fetch, work_url(wid), cfg, sleep)
            if html is None:
                continue
            tmp = out.with_suffix(".html.tmp")
            tmp.write_text(html, encoding="utf-8")
            tmp.rename(out)  # atomic: no truncated works on crash
            yield out
        page += 1
        sleep(cfg.delay_seconds)
