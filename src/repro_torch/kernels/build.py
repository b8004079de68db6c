"""Build the port's CUDA kernels with ``nvcc`` at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` holds ``extern "C"`` launchers and compiles on its own
into ``build/repro_torch_kernels/<name>-<digest>.so`` at the repository root
(gitignored).  The digest covers the source, every ``csrc/`` header it
includes (``#include "..."``, followed through headers), and the compiler
flags, so an edited source or header rebuilds and an unchanged one is loaded
as it is.  A failed compile raises with the compiler's output; there is no
other route to a kernel.  ``build_all`` starts one ``nvcc`` per source at
once and waits for all of them.

Nothing here runs at import: the kernel modules import this one on hosts
with no ``nvcc``, and ``nvcc`` is only sought when a CUDA tensor asks for a
kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "NVCC_FLAGS", "build_all", "library", "ptxas_log"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("char_kernels", "moo_kernels", "app_kernels", "axo_matmul", "flash_attention",
           "ssd_scan")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources_of(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every ``csrc/`` header it includes, transitively."""
    seen: list[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            todo.append(CSRC / inc.decode())
    return seen


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources_of(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[Path, subprocess.Popen | None]:
    out = _target(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, proc


def _finish(name: str, out: Path, proc: subprocess.Popen | None) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    tmp = Path(proc.args[proc.args.index("-o") + 1])
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every named source that is not built yet, all in parallel."""
    started = {name: _start(name) for name in names}
    errors = []
    for name, (out, proc) in started.items():
        try:
            _finish(name, out, proc)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: out for name, (out, _) in started.items()}


def ptxas_log(name: str) -> str:
    """The ``-Xptxas -v`` report (registers, shared memory, spills) of a build."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built on first use;
    its first load in the process counts ``jit.retrace.build.<name>``."""
    from ..obs.telemetry import note_trace

    path = build_all((name,))[name]
    note_trace(f"build.{name}")
    return ctypes.CDLL(str(path))
