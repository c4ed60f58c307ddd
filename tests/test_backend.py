"""Kernel choice follows the platform; no run falls back silently.

The platform chooser (ops/backend.py), the CLI's refusal to run without
a GPU unless ``--cpu`` asks for the CPU, the removed flags, the compile
cache rule (utils/jit_cache.py), and chip_smoke.py's refusal to report
anything from a CPU.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from fandom_search import cli
from fandom_search.ops import backend
from fandom_search.utils import jit_cache

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize(
    "plat,want", [("gpu", True), ("cpu", False)]
)
def test_use_kernels_by_platform(plat, want):
    assert backend.use_kernels(plat=plat) is want


@pytest.mark.parametrize("plat", ["rocm", "METAL", "neuron"])
def test_other_platforms_raise(plat):
    with pytest.raises(backend.UnsupportedPlatformError, match=plat):
        backend.use_kernels(plat=plat)


def test_interpret_runs_the_kernels_anywhere():
    assert backend.use_kernels(interpret=True) is True
    assert backend.use_kernels(interpret=True, plat="cpu") is True


def test_require_gpu_refuses_cpu_unless_asked():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(backend.UnsupportedPlatformError, match="--cpu"):
        backend.require_gpu()
    assert backend.require_gpu(allow_cpu=True) == "cpu"


def test_engine_refuses_unknown_platform(monkeypatch):
    from fandom_search.config import PipelineConfig
    from fandom_search.search.engine import SearchEngine
    from fandom_search.search.index import build_script_index
    from fandom_search.data.script_parser import parse_script

    cfg = PipelineConfig()
    index = build_script_index(
        parse_script("ALICE: one two three four five six seven"),
        cfg.shingle, cfg.search,
    )
    monkeypatch.setattr(backend, "platform", lambda: "rocm")
    with pytest.raises(backend.UnsupportedPlatformError):
        SearchEngine(index, cfg)
    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    assert SearchEngine(index, cfg).kernels is True


def _tiny_corpus(tmp_path):
    script = tmp_path / "script.txt"
    script.write_text(
        "ALICE: the quick brown fox jumps over the lazy dog today\n"
        "BOB: a stitch in time saves nine they always say\n"
    )
    works = tmp_path / "works"
    works.mkdir()
    (works / "w1.txt").write_text(
        "once upon a time the quick brown fox jumps over the lazy dog "
        "today and then some more words follow here"
    )
    return script, works


def test_cli_search_without_gpu_exits_nonzero(tmp_path, capsys):
    script, works = _tiny_corpus(tmp_path)
    with pytest.raises(SystemExit) as e:
        cli.main([
            "search", str(works), str(script), "-o", str(tmp_path / "m.csv"),
        ])
    assert e.value.code not in (0, None)
    assert "no GPU" in str(e.value.code)
    assert not (tmp_path / "m.csv").exists()


def test_cli_search_with_cpu_runs_plain_path(tmp_path, capsys):
    script, works = _tiny_corpus(tmp_path)
    rc = cli.main([
        "search", str(works), str(script), "-o", str(tmp_path / "m.csv"),
        "--cpu",
    ])
    assert rc == 0
    manifest = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert manifest["matches"] >= 1


@pytest.mark.parametrize(
    "flag", [["--no-pallas"], ["--interpret"], ["--sw-variant", "wide"],
             ["--lsh"]]
)
def test_removed_flags_are_rejected(tmp_path, flag):
    with pytest.raises(SystemExit) as e:
        cli.build_parser().parse_args(
            ["search", str(tmp_path), "s.txt", "-o", "m.csv", *flag]
        )
    assert e.value.code == 2


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: JAX reads it; the code sets
    nothing."""
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert jit_cache.enable_persistent_cache() == tmp_path / "c"
    assert calls == []


def test_compile_cache_default_is_checkout_dir(monkeypatch):
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    got = jit_cache.enable_persistent_cache()
    assert got == REPO / ".jax_cache"
    assert calls == [("jax_compilation_cache_dir", str(REPO / ".jax_cache"))]
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_chip_smoke_refuses_cpu(tmp_path):
    """No GPU: non-zero exit and no result line."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO)}
    r = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
