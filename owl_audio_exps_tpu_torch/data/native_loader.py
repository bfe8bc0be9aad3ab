"""ctypes binding of the native batch gather (the port's counterpart of
owl_audio_exps_tpu/data/native_loader.py), whose source is the port's own
copy, ``csrc/owl_loader.cpp``.

The library is built with g++ at first use into the port's build
directory (``ops/_build.py`` ``build_dir()``, under the gitignored
``build/``; its file name carries a hash of the source, so a changed
source is rebuilt). The build writes a temporary file and renames it into
place, so a process that loads the library never sees it half written.
A failed build or load raises: the port does not fall back to another
read path behind the caller's back. ``gather_windows_plain`` (numpy
positioned reads, the JAX package's fallback) is the plain version the
native gather is held against; it runs only when asked for with
``impl="plain"``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List

import numpy as np

from ..ops._build import CSRC, build_dir

SOURCE = CSRC / "owl_loader.cpp"

_lib = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return build_dir() / f"libowl_loader_{digest}.so"


def build_library() -> Path:
    """Compile csrc/owl_loader.cpp unless it is built already; returns the
    library's path. Raises RuntimeError when g++ fails."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        res = subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
             str(SOURCE), "-o", str(tmp)], capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"g++ could not run to build {SOURCE}: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{res.stderr}")
    os.replace(tmp, lib)
    return lib


def load_library() -> ctypes.CDLL:
    """The native gather's ctypes handle, built and loaded once."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            lib.owl_gather_windows.restype = ctypes.c_int
            lib.owl_gather_windows.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_longlong),
                ctypes.c_int, ctypes.c_longlong,
                ctypes.c_char_p, ctypes.c_int,
            ]
            _lib = lib
    return _lib


def npy_data_offset(path: str):
    """(data_byte_offset, dtype, shape) of an .npy file without reading
    the payload (numpy's public header readers: version 1.0, and the
    4-byte header length of 2.0 and 3.0). Raises on a Fortran-ordered
    array, whose rows are not contiguous."""
    fmt = np.lib.format
    with open(path, "rb") as f:
        version = fmt.read_magic(f)
        read = (fmt.read_array_header_1_0 if version == (1, 0)
                else fmt.read_array_header_2_0)
        shape, fortran, dtype = read(f)
        if fortran and len(shape) > 1:
            raise ValueError(f"{path}: a Fortran-ordered array")
        return f.tell(), dtype, shape


def gather_windows_plain(paths: List[str], row_starts: List[int],
                         window: int, row_bytes: int,
                         header_offsets: List[int]) -> np.ndarray:
    """The plain version: one positioned read per item with numpy.
    Returns the batch's bytes, uint8 [n * window * row_bytes]."""
    bytes_per_item = window * row_bytes
    out = np.empty(len(paths) * bytes_per_item, dtype=np.uint8)
    for i, p in enumerate(paths):
        with open(p, "rb") as f:
            f.seek(header_offsets[i] + row_starts[i] * row_bytes)
            buf = f.read(bytes_per_item)
        if len(buf) != bytes_per_item:
            raise IOError(f"short read of item {i}: {p}")
        out[i * bytes_per_item:(i + 1) * bytes_per_item] = \
            np.frombuffer(buf, dtype=np.uint8)
    return out


def gather_windows(paths: List[str], row_starts: List[int],
                   window: int, row_bytes: int, header_offsets: List[int],
                   dtype, trailing_shape, n_threads: int = 4,
                   impl: str = "native") -> np.ndarray:
    """Assemble a batch of [window, *trailing_shape] row slices, one per
    item, reading window * row_bytes from each file at its computed
    offset, through the native gather (``impl="native"``) or the plain
    version (``impl="plain"``)."""
    n = len(paths)
    bytes_per_item = window * row_bytes
    if impl == "plain":
        out = gather_windows_plain(paths, row_starts, window, row_bytes,
                                   header_offsets)
    elif impl == "native":
        lib = load_library()
        out = np.empty(n * bytes_per_item, dtype=np.uint8)
        c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        offs = (ctypes.c_longlong * n)(
            *[header_offsets[i] + row_starts[i] * row_bytes
              for i in range(n)])
        rc = lib.owl_gather_windows(
            c_paths, offs, n, bytes_per_item,
            out.ctypes.data_as(ctypes.c_char_p), n_threads)
        if rc != 0:
            raise IOError(f"native gather failed on item {-rc - 1}: "
                          f"{paths[-rc - 1]}")
    else:
        raise ValueError(f"impl {impl!r}: 'native' or 'plain'")
    return out.view(dtype).reshape((n, window) + tuple(trailing_shape))
