"""ctypes binding for the C++ threaded frame loader (native/frameloader.cpp).

Native runtime component (SURVEY.md §2.1 #8 equivalent): decode runs on a
C++ worker thread into a preallocated ring; Python only memcpys frames
out, so host decode overlaps device compute without the GIL in the way.

The library is not shipped: the first `_load()` builds it from
native/frameloader.cpp with `make -C native` against the system OpenCV 4
headers (/usr/include/opencv4), under a file lock, into a temporary name
that is renamed into place — concurrent first users never load a
half-written file. Importers check `available()`; `NativeFrameStream`
raises with the build's reason (missing headers, compiler error) when the
library cannot be built. Off the main path: `io.video.FrameStream`
decodes with cv2 instead.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Iterator, Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libframeloader.so")
OPENCV_INCLUDE = "/usr/include/opencv4"
_lib = None
_build_error: Optional[str] = None


def _build() -> Optional[str]:
    """Build the library in place; returns None or the reason it failed."""
    if not os.path.isdir(OPENCV_INCLUDE):
        return (f"OpenCV 4 development headers not found at "
                f"{OPENCV_INCLUDE} (install the system libopencv-dev "
                f"package, then `make -C native`)")
    import fcntl
    with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(_LIB_PATH):         # built while we waited
            return None
        tmp = f"libframeloader.so.{os.getpid()}.tmp"
        try:
            r = subprocess.run(["make", "-C", _NATIVE_DIR, f"OUT={tmp}"],
                               capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            return f"native loader build failed: {e}"
        if r.returncode != 0:
            return ("native loader build failed (make -C native): "
                    + (r.stderr or r.stdout).strip()[-2000:])
        os.replace(os.path.join(_NATIVE_DIR, tmp), _LIB_PATH)
    return None


def _load():
    global _lib, _build_error
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        _build_error = _build()
        if _build_error is not None:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        _build_error = f"cannot load {_LIB_PATH}: {e}"
        return None
    lib.fl_open.restype = ctypes.c_void_p
    lib.fl_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    if hasattr(lib, "fl_open2"):
        lib.fl_open2.restype = ctypes.c_void_p
        lib.fl_open2.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                 ctypes.c_int]
    lib.fl_info.argtypes = [ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_int),
                            ctypes.POINTER(ctypes.c_int),
                            ctypes.POINTER(ctypes.c_int64),
                            ctypes.POINTER(ctypes.c_double)]
    lib.fl_next.restype = ctypes.c_int
    lib.fl_next.argtypes = [ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_uint8)]
    lib.fl_close.argtypes = [ctypes.c_void_p]
    if hasattr(lib, "fl_error"):
        lib.fl_error.restype = ctypes.c_int
        lib.fl_error.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


class NativeFrameStream:
    """Threaded-decode frame stream backed by the C++ ring loader.

    gray=True converts BGR->gray u8 on the decode thread with cv2's exact
    fixed-point BT.601 (bit-identical to ops.color.grayscale_u8): frames
    come out (H, W) uint8 and the host->device transfer moves 1/3 of the
    bytes."""

    def __init__(self, path: str, ring: int = 8, gray: bool = False):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native frame loader unavailable: "
                               f"{_build_error}")
        self._lib = lib
        self.gray = bool(gray)
        if self.gray and not hasattr(lib, "fl_open2"):
            raise RuntimeError("gray mode needs a rebuilt loader "
                               "(make -C native)")
        if self.gray:
            self._h = lib.fl_open2(path.encode(), ring, 1)
        else:
            self._h = lib.fl_open(path.encode(), ring)
        if not self._h:
            raise IOError(f"cannot open video {path!r}")
        w = ctypes.c_int()
        h = ctypes.c_int()
        n = ctypes.c_int64()
        fps = ctypes.c_double()
        lib.fl_info(self._h, ctypes.byref(w), ctypes.byref(h),
                    ctypes.byref(n), ctypes.byref(fps))
        self.width = w.value
        self.height = h.value
        self.num_frames = int(n.value)
        self.fps = fps.value or 30.0

    def __iter__(self) -> Iterator[np.ndarray]:
        shape = ((self.height, self.width) if self.gray
                 else (self.height, self.width, 3))
        buf = np.empty(shape, dtype=np.uint8)
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        while True:
            if not self._lib.fl_next(self._h, ptr):
                # distinguish a decode failure from a clean end-of-stream
                # (a truncated/odd-dimension frame used to look like EOF
                # and the pipeline exported a half-length trajectory as
                # success); older .so builds without fl_error fall back
                # to the EOF interpretation
                if (hasattr(self._lib, "fl_error")
                        and self._lib.fl_error(self._h)):
                    raise RuntimeError(
                        "native loader: decode error mid-stream (frame "
                        "dimensions disagree with the container header)")
                break
            yield buf.copy()

    def read_all(self, limit: Optional[int] = None) -> np.ndarray:
        out = []
        for i, f in enumerate(self):
            if limit is not None and i >= limit:
                break
            out.append(f)
        return np.stack(out)

    def close(self):
        if self._h:
            self._lib.fl_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
