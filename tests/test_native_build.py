"""The native library is built from the committed sources on first use:
once across concurrent processes, again when a source changes, and a load
failure falls back to the Python paths instead of raising."""

import ctypes
import multiprocessing
import os
import shutil
import time
from pathlib import Path

import pytest

from voicebridge_tpu import native

SRC = 'extern "C" int vb_answer() { return %d; }\n'


@pytest.fixture
def native_dir(tmp_path):
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    shutil.copy(native.NATIVE_DIR / "Makefile", tmp_path / "Makefile")
    (tmp_path / "answer.cpp").write_text(SRC % 42)
    return tmp_path


def _answer(lib_path) -> int:
    return ctypes.CDLL(str(lib_path)).vb_answer()


def _build_in_child(path: str, q) -> None:
    q.put(str(native.build(Path(path))))


def test_concurrent_builds_produce_one_library(native_dir):
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_build_in_child, args=(str(native_dir), q))
             for _ in range(6)]
    for p in procs:
        p.start()
    paths = [q.get(timeout=120) for _ in procs]
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    assert len(set(paths)) == 1
    assert _answer(paths[0]) == 42
    leftovers = [p.name for p in native_dir.iterdir()
                 if p.name.endswith(".tmp")]
    assert leftovers == []


def test_rebuilds_when_a_source_is_newer(native_dir):
    lib = native.build(native_dir)
    assert not native.is_stale(native_dir)
    src = native_dir / "answer.cpp"
    src.write_text(SRC % 7)
    past = src.stat().st_mtime - 10  # the library predates the edit
    os.utime(lib, (past, past))
    assert native.is_stale(native_dir)
    lib = native.build(native_dir)
    assert not native.is_stale(native_dir)
    # a fresh name: the old mapping of the same path stays cached by dlopen
    copy = native_dir / f"copy{time.monotonic_ns()}.so"
    shutil.copy(lib, copy)
    assert _answer(copy) == 7


def test_load_failure_falls_back(monkeypatch, caplog):
    def broken(*_a, **_k):
        raise OSError("cannot load")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native.ctypes, "CDLL", broken)
    with caplog.at_level("WARNING"):
        assert native.load_library() is None
    assert "Python paths" in caplog.text
    # decided once per process: no second attempt
    monkeypatch.setattr(native.ctypes, "CDLL", lambda *_a: pytest.fail())
    assert native.load_library() is None
