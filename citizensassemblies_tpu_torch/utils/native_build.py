"""Build a shared library from sources in the repository, safely under
concurrency.

The library's file name carries a hash of its sources and of the compile
command, so a stale build is never loaded. Each build compiles into a
temporary file beside the target and ``os.replace``s it into place: several
processes (pytest-xdist workers) may build the same library at once, and
each of them then loads a complete file.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from typing import Sequence, Tuple

PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PKG_ROOT)
BUILD_DIR = os.path.join(PKG_ROOT, "_build")


def library_path(name: str, sources: Sequence[str], cmd: Sequence[str]) -> str:
    """Target path of library ``name`` built from ``sources`` by ``cmd``
    (``cmd`` without the sources and the output flag)."""
    h = hashlib.sha256(" ".join(cmd).encode())
    for src in sources:
        with open(src, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def start_build(
    name: str, sources: Sequence[str], cmd: Sequence[str],
    deps: Sequence[str] = (),
):
    """Start compiling library ``name``; returns ``(path, process)`` with
    ``process`` None when the library is already built. ``deps`` are
    headers the sources include: they enter the hash, not the command."""
    path = library_path(name, list(sources) + list(deps), cmd)
    if os.path.exists(path):
        return path, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".lib{name}-", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(
        list(cmd) + ["-o", tmp] + list(sources),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    )
    proc.tmp_path = tmp  # type: ignore[attr-defined]
    return path, proc


def finish_build(path: str, proc) -> Tuple[str, str]:
    """Wait for a build started by :func:`start_build` and move its output
    into place. Returns ``(path, compiler output)``; raises RuntimeError
    with the compiler's output on failure."""
    if proc is None:
        return path, ""
    out, err = proc.communicate()
    tmp = proc.tmp_path
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(
            f"build of {os.path.basename(path)} failed (exit {proc.returncode}):\n"
            + (out + err).decode("utf-8", "replace")
        )
    os.replace(tmp, path)
    return path, (out + err).decode("utf-8", "replace")


def build(name: str, sources: Sequence[str], cmd: Sequence[str], deps: Sequence[str] = ()) -> str:
    """Build (if needed) and return the library path."""
    path, proc = start_build(name, sources, cmd, deps)
    return finish_build(path, proc)[0]
