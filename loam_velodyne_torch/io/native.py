"""ctypes bindings for the native I/O runtime (native/loamio.cc).

The port's copy of ``loam_velodyne_tpu/io/native.py``. It builds the
same source, unchanged, with g++ into ``build/torch_native/`` at the
repository root (its own directory, apart from the JAX package's
``native/build/``); plain C ABI + ctypes. All call sites degrade to the
pure-Python readers if a compiler is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "loamio.cc")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "torch_native")
_LIB = os.path.join(_BUILD_DIR, "libloamio.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _try_build() -> Optional[str]:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    base = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
            "-o", _LIB, _SRC]
    for cmd in (base + ["-lbz2"], base):
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=120)
        except (OSError, subprocess.TimeoutExpired):
            return None
        if r.returncode == 0:
            return _LIB
    return None


def load() -> Optional[ctypes.CDLL]:
    """Returns the loaded native library, building it if necessary;
    None if the toolchain is unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        path = _LIB
        if not os.path.exists(path) or (
                os.path.exists(_SRC)
                and os.path.getmtime(_SRC) > os.path.getmtime(path)):
            path = _try_build()
        if path is None or not os.path.exists(path):
            _build_failed = True
            return None
        lib = ctypes.CDLL(path)
        lib.loam_bag_open.restype = ctypes.c_void_p
        lib.loam_bag_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                      ctypes.c_char_p]
        lib.loam_bag_next.restype = ctypes.c_int
        lib.loam_bag_next.argtypes = [ctypes.c_void_p]
        lib.loam_bag_stamp.restype = ctypes.c_double
        lib.loam_bag_stamp.argtypes = [ctypes.c_void_p]
        lib.loam_bag_cloud.restype = ctypes.c_long
        lib.loam_bag_cloud.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_float),
                                       ctypes.c_long]
        lib.loam_bag_imu.restype = None
        lib.loam_bag_imu.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_double)]
        lib.loam_bag_error.restype = ctypes.c_char_p
        lib.loam_bag_error.argtypes = [ctypes.c_void_p]
        lib.loam_bag_close.restype = None
        lib.loam_bag_close.argtypes = [ctypes.c_void_p]
        lib.loam_pcap_open.restype = ctypes.c_void_p
        lib.loam_pcap_open.argtypes = [ctypes.c_char_p]
        lib.loam_pcap_next_sweep.restype = ctypes.c_long
        lib.loam_pcap_next_sweep.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_long]
        lib.loam_pcap_close.restype = None
        lib.loam_pcap_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib
