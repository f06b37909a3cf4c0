"""kalman_hydra_tpu — JAX rebuild of the kalman-hydra tracking pipeline.

From-scratch JAX/XLA framework with the capabilities of
`hydradarpa/kalman-hydra` (BASELINE.json north star): video -> dense optical
flow (pyramidal LK / Farneback) -> batched EKF point tracks -> RTS smoothing
-> trajectory export, device-resident end to end.
"""

__version__ = "0.1.0"

from .config import (EkfConfig, FlowConfig, RunConfig, SmoothConfig,
                     TrackConfig)

__all__ = [
    "EkfConfig", "FlowConfig", "RunConfig", "SmoothConfig", "TrackConfig",
]
