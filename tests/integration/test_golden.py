"""Golden-file regression tests (SURVEY.md §4.5): oracle outputs are
committed; both the oracle (drift detection across cv2 versions) and the
device path (regression detection across our changes) are pinned to them."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from kalman_hydra_tpu.config import FlowConfig, RunConfig, TrackConfig
from kalman_hydra_tpu.ops.farneback import farneback
from kalman_hydra_tpu import pipeline as pl
from kalman_hydra_tpu.ref import imgproc as ip

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "golden",
                      "oracle_v1.npz")


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def test_oracle_still_matches_golden_flow(golden):
    flow = ip.farneback(golden["pair_a"], golden["pair_b"],
                        FlowConfig(levels=3))
    assert np.abs(flow - golden["farneback_flow"]).max() < 1e-4


def test_device_flow_matches_golden(golden):
    got = np.asarray(farneback(
        jnp.asarray(golden["pair_a"].astype(np.float32)),
        jnp.asarray(golden["pair_b"].astype(np.float32)),
        FlowConfig(levels=3)))
    epe = np.linalg.norm(got - golden["farneback_flow"], axis=-1)
    assert epe.mean() < 0.05
    assert epe[8:-8, 8:-8].mean() < 0.01


def test_device_tracks_match_golden(golden):
    cfg = RunConfig(flow=FlowConfig(levels=3),
                    tracks=TrackConfig(num_tracks=8, reinit=False))
    tr = pl.track_clip(golden["clip_frames"], cfg,
                       seeds=golden["clip_seeds"])
    d = np.linalg.norm(tr.positions - golden["track_positions"], axis=-1)
    assert d.mean() < 1e-2
