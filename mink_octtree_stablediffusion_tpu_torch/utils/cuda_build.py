"""Build the port's CUDA sources (`csrc/*.cu`) into shared libraries.

Each source has a plain C interface and is compiled by ``nvcc`` for
``sm_90a`` into ``_build/lib<name>_<hash>.so`` inside the package (a
directory that git ignores), then loaded with ``ctypes``.  The file name
carries a hash of the source and of the shared headers, so an edited
source or header is rebuilt.  ``build``
starts one ``nvcc`` per source, all together, and waits for all of them.
Nothing is built when a module is imported: only the first launch on a
CUDA tensor (or an explicit ``build``) compiles.  ``bind`` gives a
source's kernel entry and error-string function with their ctypes
signatures.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_BOUND: Dict[Tuple[str, str], tuple] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(source: str) -> Path:
    """Where ``source`` builds to; the name hashes the source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    src = CSRC_DIR / source
    h = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def all_sources() -> Tuple[str, ...]:
    """Every kernel source of the port (``csrc/*.cu``)."""
    return tuple(sorted(p.name for p in CSRC_DIR.glob("*.cu")))


def build(sources: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every source (default: all of them) not built yet, one
    ``nvcc`` each, in parallel.  Returns the compiler output (``-Xptxas
    -v``: registers, shared memory, spills) per source built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = all_sources() if sources is None else sources
    jobs = []
    for source in sources:
        out = library_path(source)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / source)]
        jobs.append((source, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs = {}
    for source, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{log}")
        os.replace(tmp, out)
        logs[source] = log
    return logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built at first use."""
    lib = _LIBS.get(source)
    if lib is None:
        build([source])
        lib = ctypes.CDLL(str(library_path(source)))
        _LIBS[source] = lib
    return lib


def bind(source: str, fn_name: str, argtypes: Sequence, err_name: str):
    """(kernel entry, error-string function) of ``csrc/<source>``, built
    and loaded at first use; the entry returns a CUDA error code (int)."""
    key = (source, fn_name)
    if key not in _BOUND:
        lib = load(source)
        fn, err = getattr(lib, fn_name), getattr(lib, err_name)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        _BOUND[key] = (fn, err)
    return _BOUND[key]
