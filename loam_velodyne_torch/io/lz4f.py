"""LZ4 frame (de)compression via ctypes on the system liblz4.

The port's copy of ``loam_velodyne_tpu/io/lz4f.py``.

rosbag's lz4 chunk compression (roslz4) writes standard LZ4 frames
(magic 0x184D2204). This environment ships the shared library
(liblz4.so.1) but no dev headers and no python-lz4 package, so the
frame API is bound directly with ctypes. All call sites degrade
gracefully when the library is unavailable.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
from typing import Optional

_LZ4F_VERSION = 100

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _load_failed:
            return None
        for name in ("liblz4.so.1", ctypes.util.find_library("lz4"),
                     "liblz4.so"):
            if not name:
                continue
            try:
                lib = ctypes.CDLL(name)
            except OSError:
                continue
            try:
                lib.LZ4F_isError.restype = ctypes.c_uint
                lib.LZ4F_isError.argtypes = [ctypes.c_size_t]
                lib.LZ4F_createDecompressionContext.restype = ctypes.c_size_t
                lib.LZ4F_createDecompressionContext.argtypes = [
                    ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint]
                lib.LZ4F_freeDecompressionContext.restype = ctypes.c_size_t
                lib.LZ4F_freeDecompressionContext.argtypes = [ctypes.c_void_p]
                lib.LZ4F_decompress.restype = ctypes.c_size_t
                lib.LZ4F_decompress.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_size_t), ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_size_t), ctypes.c_void_p]
                lib.LZ4F_compressFrameBound.restype = ctypes.c_size_t
                lib.LZ4F_compressFrameBound.argtypes = [ctypes.c_size_t,
                                                        ctypes.c_void_p]
                lib.LZ4F_compressFrame.restype = ctypes.c_size_t
                lib.LZ4F_compressFrame.argtypes = [
                    ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                    ctypes.c_size_t, ctypes.c_void_p]
            except AttributeError:
                continue
            _lib = lib
            return _lib
        _load_failed = True
        return None


def available() -> bool:
    return _load() is not None


def decompress(data: bytes, expected_size: int = 0) -> bytes:
    """Decompress one LZ4 frame."""
    lib = _load()
    if lib is None:
        raise RuntimeError("liblz4 unavailable; cannot read lz4 bag chunks")
    ctx = ctypes.c_void_p()
    rc = lib.LZ4F_createDecompressionContext(ctypes.byref(ctx),
                                             _LZ4F_VERSION)
    if lib.LZ4F_isError(rc):
        raise RuntimeError("LZ4F context creation failed")
    try:
        out = bytearray()
        src = (ctypes.c_char * len(data)).from_buffer_copy(data)
        src_off = 0
        dst_cap = max(64 * 1024, expected_size)
        dst = ctypes.create_string_buffer(dst_cap)
        while src_off < len(data):
            src_size = ctypes.c_size_t(len(data) - src_off)
            dst_size = ctypes.c_size_t(dst_cap)
            hint = lib.LZ4F_decompress(
                ctx, dst, ctypes.byref(dst_size),
                ctypes.byref(src, src_off), ctypes.byref(src_size), None)
            if lib.LZ4F_isError(hint):
                raise RuntimeError("LZ4 frame decompression failed")
            out += dst.raw[:dst_size.value]
            src_off += src_size.value
            if hint == 0 and src_size.value == 0:
                break
        return bytes(out)
    finally:
        lib.LZ4F_freeDecompressionContext(ctx)


def compress(data: bytes) -> bytes:
    """Compress into one LZ4 frame (default frame parameters)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("liblz4 unavailable; cannot write lz4 bag chunks")
    bound = lib.LZ4F_compressFrameBound(len(data), None)
    dst = ctypes.create_string_buffer(bound)
    src = (ctypes.c_char * len(data)).from_buffer_copy(data)
    n = lib.LZ4F_compressFrame(dst, bound, src, len(data), None)
    if lib.LZ4F_isError(n):
        raise RuntimeError("LZ4 frame compression failed")
    return dst.raw[:n]
