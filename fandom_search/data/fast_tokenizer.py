"""ctypes binding for the native fast-ingest tokenizer (native/fastingest.cpp).

Builds the shared library on first use (g++ is in the image; pybind11 is
not, so the binding is a plain C ABI).  Falls back to the pure-Python
tokenizer transparently when no compiler is available — the two are
byte-for-byte equivalent (tests/test_fast_tokenizer.py fuzzes this).

``tokenize_many`` fans documents over a thread pool; the C call drops
the GIL, so ingestion scales with host cores (the reference used a
process pool for the whole search — here only ingestion needs host
parallelism, SURVEY.md section 3 "Parallel fan-out").
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from fandom_search.data.tokenizer import Tokenized, tokenize

log = logging.getLogger(__name__)

_ABI_VERSION = 4
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _native_dir() -> Path:
    return Path(__file__).resolve().parent.parent / "native"


def _build_dir() -> Optional[Path]:
    """Build output dir: next to the source if writable, else a cache.

    The fallback is PER-USER and mode-0700-owned: a fixed world-
    writable /tmp path would let another local user pre-plant a
    malicious .so that ctypes would happily load.  If a non-owned
    directory squats the path, give up (Python tokenizer fallback)
    rather than load anything from it.
    """
    build = _native_dir() / "build"
    try:
        build.mkdir(exist_ok=True)
        return build
    except OSError:  # installed read-only (site-packages)
        import tempfile

        uid = os.getuid() if hasattr(os, "getuid") else 0
        build = Path(tempfile.gettempdir()) / f"fandom_search_native_{uid}"
        build.mkdir(parents=True, exist_ok=True, mode=0o700)
        st = build.stat()
        if hasattr(os, "getuid") and st.st_uid != os.getuid():
            log.warning(
                "native build cache %s is not owned by this user; "
                "using Python tokenizer", build,
            )
            return None
        return build


def _build_and_load() -> Optional[ctypes.CDLL]:
    src = _native_dir() / "fastingest.cpp"
    if not src.exists():
        return None
    build = _build_dir()
    if build is None:
        return None
    so = build / f"libfastingest_v{_ABI_VERSION}.so"
    if not so.exists():
        # unique temp name: concurrent first-use builds from several
        # processes must not interleave writes into one .tmp — each
        # compiles to its own file and the atomic replace races benignly
        tmp = build / f".libfastingest_v{_ABI_VERSION}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
               "-o", str(tmp), str(src)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        except Exception as e:  # noqa: BLE001 — fall back to Python
            log.warning("native build failed (%s); using Python tokenizer", e)
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        log.warning("native load failed (%s); using Python tokenizer", e)
        return None
    lib.fs_tokenize.restype = ctypes.c_int64
    lib.fs_tokenize.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.fs_encode_stream.restype = ctypes.c_int64
    lib.fs_encode_stream.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_int64,
    ]
    lib.fs_bucketed_table.restype = ctypes.c_int64
    lib.fs_bucketed_table.argtypes = [
        ctypes.POINTER(ctypes.c_uint32),  # wa
        ctypes.POINTER(ctypes.c_uint32),  # wb
        ctypes.c_int64,                   # ns
        ctypes.c_uint32,                  # salt
        ctypes.c_uint32,                  # mask
        ctypes.c_int32,                   # cap
        ctypes.POINTER(ctypes.c_uint32),  # keys scratch
        ctypes.POINTER(ctypes.c_int32),   # entries out
        ctypes.POINTER(ctypes.c_int32),   # offsets out
    ]
    lib.fs_abi_version.restype = ctypes.c_int32
    if lib.fs_abi_version() != _ABI_VERSION:
        log.warning("native ABI mismatch; using Python tokenizer")
        return None
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is None and not _lib_failed:
            _lib = _build_and_load()
            _lib_failed = _lib is None
    return _lib


def native_available() -> bool:
    return get_lib() is not None


def fast_tokenize(text: str) -> Tokenized:
    """Native-if-possible tokenization; identical output to tokenize()."""
    lib = get_lib()
    if lib is None:
        return tokenize(text)
    try:
        data = text.encode("utf-8")
    except UnicodeEncodeError:
        # lone surrogates (e.g. files read with errors='surrogateescape')
        # can't round-trip through the C ABI; the Python path handles them
        return tokenize(text)
    cap = max(1, len(text))
    hashes = np.empty(cap, dtype=np.uint32)
    starts = np.empty(cap, dtype=np.int64)
    ends = np.empty(cap, dtype=np.int64)
    n = lib.fs_tokenize(
        data, len(data),
        hashes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    # int32 offsets match tokenize() (texts are far below 2 GB; the
    # corpus-wide cache is offset-dominated at 100k-work scale)
    offsets = np.stack([starts[:n], ends[:n]], axis=1).astype(np.int32)
    # token strings are lazy (Tokenized.tokens) — search never needs them
    return Tokenized(text=text, offsets=offsets, hashes=hashes[:n].copy())


def tokenize_many(
    texts: Dict[str, str], *, threads: int | None = None
) -> Dict[str, Tokenized]:
    """Parallel corpus ingestion (GIL-free native calls on a thread pool)."""
    if get_lib() is None or len(texts) < 4:
        return {k: fast_tokenize(v) for k, v in texts.items()}
    threads = threads or min(16, os.cpu_count() or 4)
    keys = list(texts)
    with ThreadPoolExecutor(max_workers=threads) as ex:
        results = list(ex.map(lambda k: fast_tokenize(texts[k]), keys))
    return dict(zip(keys, results))
