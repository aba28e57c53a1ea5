"""Build the native host library ``voxelize.cpp`` with the host's C++
compiler: ``python -m mink_octtree_stablediffusion_tpu_torch.native.build``.

The library goes to the package's git-ignored ``_build/`` as
``libvoxelize_<hash>.so``; the hash covers the source, the compiler
flags and the host CPU's model and feature flags (``-march=native`` code
runs only where it was built), so an edited source or another host
builds anew.  The compiler writes to a
temporary file that is renamed into place, so that processes building at
once never load half a library.
"""

from __future__ import annotations

import hashlib
import os
import platform
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "voxelize.cpp"
BUILD_DIR = HERE.parent / "_build"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]


def _cpu_id() -> str:
    """The host CPU's model name and feature flags (what ``-march=native``
    compiles for)."""
    found = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags") and key not in found:
                    found[key] = line.split(":", 1)[1].strip()
    except OSError:
        pass
    return " ".join(found.values()) or platform.processor()


def compiler() -> Optional[str]:
    """The host's C++ compiler (``$CXX``, else ``g++``), or None."""
    return shutil.which(os.environ.get("CXX", "g++"))


def library_path() -> Path:
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    h.update(f"{platform.machine()} {_cpu_id()}".encode())
    return BUILD_DIR / f"libvoxelize_{h.hexdigest()[:12]}.so"


def build(verbose: bool = False) -> Optional[Path]:
    """The built library's path (built now if it is missing), or None
    where the host has no compiler.  A compiler that fails raises with
    its output."""
    out = library_path()
    if out.exists():
        return out
    cxx = compiler()
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [cxx, *FLAGS, str(SOURCE), "-o", str(tmp)]
    if verbose:
        print(" ".join(cmd))
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout}")
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    path = build(verbose=True)
    print("built", path)
    sys.exit(0 if path is not None else 1)
