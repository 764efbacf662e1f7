"""Minimal zstd decompression over the system libzstd via ctypes.

The reference ingests .zst/.zstd-compressed structure files through its
vendored zstd (reference: src/strucclustutils/GemmiWrapper.cpp load() gz/zstd
branch, lib/zstd). No python zstandard module is assumed; libzstd.so is
loaded lazily and absence degrades to a clear error at use time.
"""
from __future__ import annotations

import ctypes
import ctypes.util

_lib = None
_checked = False


def _load():
    global _lib, _checked
    if _checked:
        return _lib
    _checked = True
    name = ctypes.util.find_library("zstd")
    if not name:
        return None
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        return None
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
    lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.ZSTD_decompress.restype = ctypes.c_size_t
    lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                    ctypes.c_void_p, ctypes.c_size_t]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def compress(data: bytes, level: int = 3) -> bytes:
    lib = _load()
    if lib is None:
        raise RuntimeError("libzstd not available on this system")
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    lib.ZSTD_compress.restype = ctypes.c_size_t
    lib.ZSTD_compress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                  ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
    bound = lib.ZSTD_compressBound(len(data))
    buf = ctypes.create_string_buffer(bound)
    n = lib.ZSTD_compress(buf, bound, data, len(data), level)
    if lib.ZSTD_isError(n):
        raise ValueError("zstd compression failed")
    return buf.raw[:n]


_CONTENTSIZE_UNKNOWN = 2**64 - 1
_CONTENTSIZE_ERROR = 2**64 - 2


def decompress(data: bytes) -> bytes:
    lib = _load()
    if lib is None:
        raise RuntimeError("libzstd not available on this system")
    size = lib.ZSTD_getFrameContentSize(data, len(data))
    if size == _CONTENTSIZE_ERROR:
        raise ValueError("not a zstd frame")
    if size == _CONTENTSIZE_UNKNOWN:
        # streaming frame without a size header: grow-and-retry
        size = max(4 * len(data), 1 << 20)
        while True:
            buf = ctypes.create_string_buffer(size)
            n = lib.ZSTD_decompress(buf, size, data, len(data))
            if not lib.ZSTD_isError(n):
                return buf.raw[:n]
            if size > (1 << 31):
                raise ValueError("zstd decompression failed")
            size *= 4
    buf = ctypes.create_string_buffer(int(size) if size else 1)
    n = lib.ZSTD_decompress(buf, int(size) if size else 1, data, len(data))
    if lib.ZSTD_isError(n):
        raise ValueError("zstd decompression failed")
    return buf.raw[:n]
