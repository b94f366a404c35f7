"""Build and load the native host library (``wfst.cpp``, ``pitch.cpp``).

The shared library is never committed.  It is built from the sources in this
directory on first use, and again whenever a source is newer than it.  The
build writes a temporary file and renames it into place under an exclusive
file lock, so processes that start together (test workers, for one) build
it once and never load a half-written file.

If the build or the load fails, :func:`load_library` logs why and returns
None; callers then take their pure-Python paths.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from pathlib import Path

from ..utils.logging import get_logger

log = get_logger()

NATIVE_DIR = Path(__file__).resolve().parent
LIB_NAME = "libvbwfst.so"

_lock = threading.Lock()
_lib = None
_tried = False


def is_stale(native_dir: Path) -> bool:
    """True when the library is missing or older than any source."""
    lib = native_dir / LIB_NAME
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any(src.stat().st_mtime > built
               for src in native_dir.glob("*.cpp"))


def build(native_dir: Path = NATIVE_DIR, timeout: float = 300.0) -> Path:
    """Build ``native_dir/libvbwfst.so`` if it is stale; return its path.
    Raises ``OSError`` or ``subprocess.SubprocessError`` on failure."""
    lib = native_dir / LIB_NAME
    tmp_name = f".{LIB_NAME}.tmp"
    with open(native_dir / f".{LIB_NAME}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not is_stale(native_dir):  # another process built it meanwhile
            return lib
        (native_dir / tmp_name).unlink(missing_ok=True)
        subprocess.run(["make", "-s", "-C", str(native_dir),
                        f"LIB={tmp_name}"],
                       check=True, capture_output=True, timeout=timeout)
        os.replace(native_dir / tmp_name, lib)
    return lib


def load_library():
    """The package's native library as a ``ctypes.CDLL``, or None when it
    cannot be built or loaded here.  Built and loaded once per process."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            _lib = ctypes.CDLL(str(build()))
        except (OSError, subprocess.SubprocessError) as e:
            log.warning("native library unavailable (%s); graph builds and "
                        "pitch use the Python paths", e)
            _lib = None
        return _lib
