"""Host-side video decode / frame streaming.

Rebuild of the reference's IO layer (SURVEY.md §2.1 #8: "frame streams from
video files"). Decode stays on host (codecs are CPU work); the pipeline layer
owns the single host->HBM crossing per frame (BASELINE.json:5 "no frame data
round-trips to host between decode and trajectory output").

OpenCV is used only as a codec here — never for compute.
"""

from __future__ import annotations

import os
import threading
import queue
from typing import Iterator, Optional

import numpy as np


def open_video(path: str) -> "FrameStream":
    return FrameStream(path)


class FrameStream:
    """Iterates BGR uint8 frames from a video file (or .npz/.npy clip).

    gray=True yields (H, W) uint8 via cv2.cvtColor (bit-identical to the
    device grayscale) — 1/3 of the host->device bytes in streaming mode."""

    def __init__(self, path: str, gray: bool = False):
        self.path = path
        self.gray = bool(gray)
        self._cap = None
        self._arr = None
        if path.endswith((".npz", ".npy")):
            if path.endswith(".npz"):
                with np.load(path) as z:
                    self._arr = z[list(z.keys())[0]]
            else:
                self._arr = np.load(path)
            self.num_frames = len(self._arr)
            f0 = self._arr[0]
            self.height, self.width = f0.shape[:2]
            self.fps = 30.0
        else:
            import cv2  # codec only
            self._cap = cv2.VideoCapture(path)
            if not self._cap.isOpened():
                raise IOError(f"cannot open video {path!r}")
            self.num_frames = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
            self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            self.fps = float(self._cap.get(cv2.CAP_PROP_FPS)) or 30.0

    def __iter__(self) -> Iterator[np.ndarray]:
        if self.gray:
            import cv2
        if self._arr is not None:
            for f in self._arr:
                f = np.ascontiguousarray(f)
                if self.gray and f.ndim == 3 and f.shape[-1] == 3:
                    f = cv2.cvtColor(f, cv2.COLOR_BGR2GRAY)
                yield f
            return
        while True:
            ok, frame = self._cap.read()
            if not ok:
                break
            if self.gray:
                frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            yield frame

    def read_all(self, limit: Optional[int] = None) -> np.ndarray:
        """Decode the whole clip to one (T, H, W, C) array."""
        out = []
        for i, f in enumerate(self):
            if limit is not None and i >= limit:
                break
            out.append(f)
        return np.stack(out)

    def close(self):
        if self._cap is not None:
            self._cap.release()
            self._cap = None


class PrefetchStream:
    """Background-thread decode with a bounded queue.

    Double-buffers host decode against device compute (SURVEY.md §7 "host
    decode throughput"): the consumer pulls frame t while the worker decodes
    t+1..t+depth.
    """

    _END = object()

    def __init__(self, stream, depth: int = 4):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stream = stream
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Bounded put so an abandoned consumer can't pin this thread
        (and the open decoder) for the process lifetime."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for frame in self._stream:
                if not self._put(frame):
                    return
            self._put(self._END)
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            # a decode error must NOT look like a clean end-of-stream
            # (it used to: the old finally put _END and tracking silently
            # returned partial trajectories as success)
            self._put(e)

    def __iter__(self):
        try:
            while True:
                item = self._q.get()
                if item is self._END:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            self._stop.set()
            try:
                self._q.get_nowait()        # wake a blocked put
            except queue.Empty:
                pass


def device_prefetch(frames, depth: int = 2):
    """Generator of DEVICE-resident frames with decode + H2D overlapped
    against the consumer's compute (SURVEY.md §7 "host decode
    throughput"; round-2 verdict item 7).

    A background thread decodes and `jax.device_put`s up to `depth`
    frames ahead; device_put enqueues an async transfer, so while the
    pipeline computes on frame t, frame t+1's bytes are already moving
    over the host->device link, and the streaming path is bounded by the
    slowest of decode, transfer and compute instead of their sum.

    Exceptions in the worker propagate to the consumer.
    """
    import jax

    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    end = object()
    stop = threading.Event()

    def worker():
        try:
            for f in frames:
                buf = jax.device_put(np.ascontiguousarray(f))
                # bounded put so an abandoned consumer (step_fn raised,
                # caller broke out of the loop) can't pin this thread —
                # and depth+1 device frames — for the process lifetime
                while not stop.is_set():
                    try:
                        q.put(buf, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put(end)
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        # fires on consumer abandonment (GeneratorExit) as well as on
        # normal exhaustion; drain one slot so a blocked put wakes up
        stop.set()
        try:
            q.get_nowait()
        except queue.Empty:
            pass


def write_video(path: str, frames: np.ndarray, fps: float = 30.0) -> None:
    """Write (T, H, W, 3) BGR uint8 frames (debug overlays; host, post-hoc)."""
    if path.endswith(".npz"):
        np.savez_compressed(path, frames=frames)
        return
    import cv2
    h, w = frames.shape[1:3]
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    wr = cv2.VideoWriter(path, fourcc, fps, (w, h))
    try:
        for f in frames:
            wr.write(np.ascontiguousarray(f))
    finally:
        wr.release()
