"""Loader for the native helper library (tools/libsaltnative.so).

The library holds the SA-IS suffix sorter (index build) and the
bit-faithful scalar SSW (PE rescue / -X 1 winner verification).  It is
auto-built with g++ on first use — round-3 shipped without it, which
silently dropped the SSW path to the pure-numpy lane emulation at
~250ms per call and made PE rescue the dominant cost (639 pairs/s).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

_LIB = None
_TRIED = False


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def load_native():
    """Returns the ctypes.CDLL for libsaltnative.so, building it with
    g++ if absent (one-time, ~10s).  Returns None when no compiler is
    available — callers fall back to their pure-python paths."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    tools = os.path.join(_repo_root(), "tools")
    so = os.path.join(tools, "libsaltnative.so")
    srcs = [os.path.join(tools, "sais.cpp"),
            os.path.join(tools, "ssw_native.cpp")]
    if not os.path.exists(so) or any(
        os.path.exists(s) and os.path.getmtime(s) > os.path.getmtime(so)
        for s in srcs
    ):
        srcs = [s for s in srcs if os.path.exists(s)]
        if not srcs:
            return None
        # build under a per-process name, then rename into place:
        # concurrent first users (test workers, pipelined jobs) each
        # see either no library or a complete one, never a partial file
        tmp = f"{so}.{os.getpid()}.tmp"
        try:
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 "-o", tmp] + srcs,
                check=True, capture_output=True, text=True, timeout=300,
            )
            os.replace(tmp, so)
            sys.stderr.write(f"[native] built {so}\n")
        except (OSError, subprocess.SubprocessError) as e:
            # no g++ / compile error: python fallback
            detail = getattr(e, "stderr", None) or ""
            sys.stderr.write(f"[native] build failed ({e}); using python "
                             f"fallbacks\n{detail}")
            if os.path.exists(tmp):
                os.remove(tmp)
            return None
    try:
        _LIB = ctypes.CDLL(so)
    except OSError as e:
        sys.stderr.write(f"[native] load failed ({e}); using python "
                         f"fallbacks\n")
        _LIB = None
    return _LIB
