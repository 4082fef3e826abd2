"""Build the CUDA sources under ``csrc/`` with nvcc; bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers,
so a build takes seconds) and compiles to one shared library,
``build/kernels/<name>-<hash>.so`` at the root of the checkout, where
``<hash>`` covers the source, the ``csrc/`` headers it includes and the
flags: an edited source or header builds anew, an unchanged one is
reused.  The build happens at first use (or all at once through
``build``, one ``nvcc`` per source started together) and only on a
machine with ``nvcc``; nothing here runs at import time.  Every failure raises: a wrapper handed a CUDA tensor
launches its kernel or raises, it never falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_INCLUDE = re.compile(r'^\s*#include\s+"([^"]+)"', re.M)


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``) or ``PATH``."""
    cand = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") / "bin" \
        / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels build on a machine with the CUDA "
            "toolkit")
    return found


def local_headers(name: str) -> List[Path]:
    """The ``csrc/`` headers that ``csrc/<name>.cu`` includes by quotes."""
    text = (CSRC / f"{name}.cu").read_text()
    return [CSRC / h for h in _INCLUDE.findall(text)]


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in local_headers(name):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> None:
    """Compile every named source whose library is missing, in parallel."""
    pending = [(n, library_path(n)) for n in names]
    pending = [(n, out) for n, out in pending if not out.exists()]
    if not pending:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for name, out in pending:
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v`` resource summary) for ``name``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (building it if needed)."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def check(err: int, kernel: str, lib: ctypes.CDLL) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if err:
        name = lib.cuda_error_string
        name.argtypes, name.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{kernel}: CUDA launch failed: "
                           f"{name(err).decode()} (cudaError_t {err})")
