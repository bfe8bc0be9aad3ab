"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/*.cu`` source (with the ``csrc/*.cuh`` headers it includes)
compiles into its own shared library with a plain C interface (no PyTorch headers, so a build takes seconds). All
sources are compiled together, one nvcc process each, the first time any
kernel is needed; a library is rebuilt only when its source changes (the
file name carries a hash of the source). The build directory is
``build/kernels`` at the repository root (listed in .gitignore).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
REPO_ROOT = CSRC.parents[1]
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return REPO_ROOT / "build" / "kernels"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "on a machine with the CUDA toolkit")


def _lib_path(src: Path) -> Path:
    # the shared headers are part of every source's content
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return build_dir() / f"lib{src.stem}_{digest}.so"


def build_all(verbose: bool = False) -> Dict[str, Path]:
    """Compile every source under csrc/ that is not built yet, all nvcc
    processes started together. Returns {source stem: library path}."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    todo = [(s, _lib_path(s)) for s in sources if not _lib_path(s).exists()]
    procs = []
    for src, lib in todo:
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
               str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs = [proc.communicate()[0] for *_, proc in procs]
    for (src, lib, tmp, proc), log in zip(procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        if verbose:
            print(f"[build] {src.name}:\n{log.strip()}")
        os.replace(tmp, lib)
    return {s.stem: _lib_path(s) for s in sources}


def load(stem: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<stem>.cu, building at first use."""
    if stem not in _LIBS:
        libs = build_all()
        if stem not in libs:
            raise RuntimeError(f"no CUDA source csrc/{stem}.cu")
        _LIBS[stem] = ctypes.CDLL(str(libs[stem]))
    return _LIBS[stem]
