"""C++ native frame loader: decode parity with the python path."""

import numpy as np
import pytest

from kalman_hydra_tpu.io import native_loader
from kalman_hydra_tpu.io.synthetic import moving_blob_clip
from kalman_hydra_tpu.io.video import write_video, FrameStream


@pytest.fixture()
def native():
    """The loader, built on first use (decided here, not at import)."""
    if not native_loader.available():
        pytest.skip(f"native loader unavailable: "
                    f"{native_loader._build_error}")
    return native_loader


def test_native_decode_matches_python(tmp_path, native):
    frames, _ = moving_blob_clip(num_frames=6, height=64, width=64, seed=0)
    path = str(tmp_path / "clip.avi")
    import cv2
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30,
                         (64, 64))
    for f in frames:
        wr.write(np.ascontiguousarray(f))
    wr.release()

    py_frames = FrameStream(path).read_all()
    ns = native_loader.NativeFrameStream(path)
    assert (ns.width, ns.height) == (64, 64)
    nat_frames = ns.read_all()
    ns.close()
    assert nat_frames.shape == py_frames.shape
    # same codec, two OpenCV builds (5.0 wheel vs 4.x system): allow tiny
    # JPEG-decode differences
    assert np.abs(nat_frames.astype(int) - py_frames.astype(int)).mean() < 2.0


def test_native_loader_feeds_pipeline(tmp_path, native):
    frames, _ = moving_blob_clip(num_frames=5, height=64, width=64, seed=1)
    path = str(tmp_path / "clip.avi")
    import cv2
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30,
                         (64, 64))
    for f in frames:
        wr.write(np.ascontiguousarray(f))
    wr.release()

    from kalman_hydra_tpu import pipeline as pl
    from kalman_hydra_tpu.config import FlowConfig, RunConfig, TrackConfig
    cfg = RunConfig(flow=FlowConfig(levels=2),
                    tracks=TrackConfig(num_tracks=8, corner_pool=16))
    ns = native_loader.NativeFrameStream(path)
    tr = pl.track_stream(iter(ns), cfg)
    ns.close()
    assert tr.positions.shape[0] == 5
    assert np.isfinite(tr.positions).all()


def test_native_gray_mode_bit_exact(tmp_path, native):
    """gray=True must be bit-identical to the device grayscale
    (ops.color.grayscale_u8 / cv2 fixed-point BT.601) on the SAME decoded
    BGR frames — and feed the pipeline as (H, W) u8."""
    frames, _ = moving_blob_clip(num_frames=4, height=64, width=64, seed=2)
    path = str(tmp_path / "clip.avi")
    import cv2
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30,
                         (64, 64))
    for f in frames:
        wr.write(np.ascontiguousarray(f))
    wr.release()

    ns_bgr = native_loader.NativeFrameStream(path)
    bgr = ns_bgr.read_all()
    ns_bgr.close()
    ns_gray = native_loader.NativeFrameStream(path, gray=True)
    gray = ns_gray.read_all()
    ns_gray.close()
    assert gray.shape == bgr.shape[:3]
    # same decoder output -> same gray values, no tolerance
    f = bgr.astype(np.int64)
    ref = ((f[..., 0] * 3735 + f[..., 1] * 19235 + f[..., 2] * 9798
            + (1 << 14)) >> 15).astype(np.uint8)
    np.testing.assert_array_equal(gray, ref)

    from kalman_hydra_tpu import pipeline as pl
    from kalman_hydra_tpu.config import FlowConfig, RunConfig, TrackConfig
    cfg = RunConfig(flow=FlowConfig(levels=2),
                    tracks=TrackConfig(num_tracks=8, corner_pool=16))
    ns = native_loader.NativeFrameStream(path, gray=True)
    tr = pl.track_stream(iter(ns), cfg)
    ns.close()
    assert tr.positions.shape[0] == 4
    assert np.isfinite(tr.positions).all()


def test_framestream_gray_matches_cvtcolor(tmp_path):
    frames, _ = moving_blob_clip(num_frames=3, height=48, width=48, seed=3)
    path = str(tmp_path / "clip.npz")
    np.savez(path, frames=frames)
    import cv2
    bgr = FrameStream(path).read_all()
    gray = FrameStream(path, gray=True).read_all()
    ref = np.stack([cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in bgr])
    np.testing.assert_array_equal(gray, ref)


def test_missing_opencv_headers_fail_clearly(tmp_path, monkeypatch):
    """Without the OpenCV headers the build is not attempted and opening
    a stream says why."""
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_LIB_PATH",
                        str(tmp_path / "libframeloader.so"))
    monkeypatch.setattr(native_loader, "OPENCV_INCLUDE",
                        str(tmp_path / "no-opencv4"))
    assert not native_loader.available()
    with pytest.raises(RuntimeError, match="OpenCV 4 development headers"):
        native_loader.NativeFrameStream(str(tmp_path / "clip.avi"))
