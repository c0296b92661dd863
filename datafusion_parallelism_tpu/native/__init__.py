"""Native (C++) runtime components, loaded via ctypes.

The reference's native layer is its Rust runtime; here the host-side
data-loading hot path is C++ (the device compute path is XLA — kernels do
not belong here). Libraries compile on demand with g++ into
native/_build/ and load via ctypes; callers must handle ImportError and fall
back to pure-Python paths (tests run everywhere).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sysconfig
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_DIR, "_build")
_LIBS = {}


def _compile(src: str, out: str) -> None:
    os.makedirs(_BUILD, exist_ok=True)
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           src, "-o", out, "-pthread"]
    subprocess.run(cmd, check=True, capture_output=True, text=True)


def load_library(name: str) -> ctypes.CDLL:
    """Load lib<name>.so, compiling <name>.cpp if needed/stale."""
    if name in _LIBS:
        return _LIBS[name]
    src = os.path.join(_DIR, f"{name}.cpp")
    out = os.path.join(_BUILD, f"lib{name}.so")
    if not os.path.exists(out) or os.path.getmtime(out) < os.path.getmtime(src):
        _compile(src, out)
    lib = ctypes.CDLL(out)
    _LIBS[name] = lib
    return lib


def tbl_library() -> Optional[ctypes.CDLL]:
    """The .tbl parser library, or None when no toolchain is available."""
    try:
        lib = load_library("tbl_parser")
    except (OSError, subprocess.CalledProcessError, FileNotFoundError):
        return None
    lib.tbl_count_rows.restype = ctypes.c_int64
    lib.tbl_count_rows.argtypes = [ctypes.c_char_p]
    lib.tbl_parse.restype = ctypes.c_void_p
    lib.tbl_parse.argtypes = [ctypes.c_char_p, ctypes.c_int32,
                              ctypes.POINTER(ctypes.c_int32),
                              ctypes.POINTER(ctypes.c_void_p),
                              ctypes.c_int64]
    lib.tbl_dict_size.restype = ctypes.c_int64
    lib.tbl_dict_size.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.tbl_dict_bytes.restype = ctypes.c_int64
    lib.tbl_dict_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.tbl_dict_fetch.restype = None
    lib.tbl_dict_fetch.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                   ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int64)]
    lib.tbl_free.restype = None
    lib.tbl_free.argtypes = [ctypes.c_void_p]
    return lib
