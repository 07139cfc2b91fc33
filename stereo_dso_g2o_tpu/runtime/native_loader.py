"""ctypes binding for the native C++ stereo loader (native/loader.cpp).

The reference's data path is native C++ (util/DatasetReader.h getImage
:200-226, IOWrapper OpenCV PNG read, Undistort remap); this module builds and
binds the runtime equivalent: a worker-threaded PNG/JPEG decoder with
geometric remap + photometric correction and a bounded in-order prefetch
queue, so host image I/O overlaps the device pipeline.

The shared library compiles on first use into `.cache/` (g++, links libpng/
libjpeg); `available()` reports whether that worked, and callers (io/dataset
StereoDataset.prefetch) fall back to the PIL path when it did not.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_REPO, "native", "loader.cpp")
_LIB_DIR = os.path.join(os.path.dirname(_REPO), ".cache")
_LIB = os.path.join(_LIB_DIR, "libsdso_loader.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_err: Optional[str] = None


def _build() -> Optional[str]:
    os.makedirs(_LIB_DIR, exist_ok=True)
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC,
        "-o", _LIB, "-lpng", "-ljpeg", "-lz", "-lpthread",
    ]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=180)
    except Exception as e:  # g++ missing, timeout, ...
        return str(e)
    if r.returncode != 0:
        return r.stderr[-2000:]
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_err
    with _lock:
        if _lib is not None or _build_err is not None:
            return _lib
        if not os.path.exists(_LIB) or (
            os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
        ):
            _build_err = _build()
            if _build_err is not None:
                return None
        lib = ctypes.CDLL(_LIB)
        fp = ctypes.POINTER(ctypes.c_float)
        lib.sdso_decode_gray.restype = ctypes.c_int
        lib.sdso_decode_gray.argtypes = [
            ctypes.c_char_p, fp, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.sdso_loader_open.restype = ctypes.c_void_p
        lib.sdso_loader_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, fp, fp, fp, fp,
        ]
        lib.sdso_loader_next.restype = ctypes.c_int
        lib.sdso_loader_next.argtypes = [ctypes.c_void_p, fp, fp]
        lib.sdso_loader_close.restype = None
        lib.sdso_loader_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_err


def decode_gray(path: str, max_pixels: int = 1 << 26) -> np.ndarray:
    """One-shot native decode to float32 grayscale (H, W)."""
    lib = _load()
    assert lib is not None, f"native loader unavailable: {_build_err}"
    buf = np.empty(max_pixels, np.float32)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.sdso_decode_gray(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_pixels, ctypes.byref(w), ctypes.byref(h),
    )
    assert rc == 0, f"decode failed ({rc}): {path}"
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()


def _fptr(a: Optional[np.ndarray]):
    if a is None:
        return None
    return np.ascontiguousarray(a, np.float32).ctypes.data_as(
        ctypes.POINTER(ctypes.c_float)
    )


class NativeStereoLoader:
    """Prefetching stereo frame stream, in frame order.

    remap_x/remap_y: (H, W) float32 source coordinates per output pixel with
    invalid pixels < 0 (callers encode the reference's remap_ok mask as -1).
    gamma: (256,) inverse-response LUT; vignette_inv: (H, W) 1/V factor.
    """

    def __init__(
        self,
        left_paths: Sequence[str],
        right_paths: Sequence[str],
        out_w: int,
        out_h: int,
        remap_x: Optional[np.ndarray] = None,
        remap_y: Optional[np.ndarray] = None,
        gamma: Optional[np.ndarray] = None,
        vignette_inv: Optional[np.ndarray] = None,
        n_workers: int = 3,
        capacity: int = 8,
    ):
        lib = _load()
        assert lib is not None, f"native loader unavailable: {_build_err}"
        assert len(left_paths) == len(right_paths)
        self._lib = lib
        self.n = len(left_paths)
        self.w, self.h = out_w, out_h
        # keep the encoded path buffers alive for the loader's lifetime
        self._lbytes = [p.encode() for p in left_paths]
        self._rbytes = [p.encode() for p in right_paths]
        larr = (ctypes.c_char_p * self.n)(*self._lbytes)
        rarr = (ctypes.c_char_p * self.n)(*self._rbytes)
        # keep the calibration arrays alive until open() copies them
        rx = np.ascontiguousarray(remap_x, np.float32) if remap_x is not None else None
        ry = np.ascontiguousarray(remap_y, np.float32) if remap_y is not None else None
        gm = np.ascontiguousarray(gamma, np.float32) if gamma is not None else None
        vi = (
            np.ascontiguousarray(vignette_inv, np.float32)
            if vignette_inv is not None else None
        )
        self._h = lib.sdso_loader_open(
            larr, rarr, self.n, n_workers, capacity, out_w, out_h,
            _fptr(rx), _fptr(ry), _fptr(gm), _fptr(vi),
        )
        assert self._h, "loader_open failed"
        self._taken = 0

    def __len__(self):
        return self.n

    def next(self):
        """Blocking: (frame_idx, left, right) or None at end of stream."""
        if self._taken >= self.n:
            return None
        left = np.empty((self.h, self.w), np.float32)
        right = np.empty((self.h, self.w), np.float32)
        idx = self._lib.sdso_loader_next(
            self._h,
            left.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            right.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        self._taken += 1
        if idx == -1:
            return None
        if idx == -2:
            raise IOError(f"native decode failed at frame {self._taken - 1}")
        return idx, left, right

    def __iter__(self):
        while True:
            item = self.next()
            if item is None:
                return
            yield item

    def close(self):
        if getattr(self, "_h", None):
            self._lib.sdso_loader_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
