"""Frozen, hashable configuration dataclasses.

JAX rebuild of the reference's per-script argparse configuration
(SURVEY.md §5 "Config / flag system"). Frozen dataclasses are hashable and
therefore usable as `jax.jit` static arguments, which keeps every shape and
loop bound static inside the compiled pipeline (an XLA requirement the
reference never had to care about).

Reference behavior contract: BASELINE.json:5 (north star) and the five
benchmark configs BASELINE.json:6-12. The reference checkout was empty at
survey time (SURVEY.md §0), so numeric defaults mirror OpenCV's documented
defaults for `calcOpticalFlowFarneback` / `calcOpticalFlowPyrLK`, which are
the parity oracle.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass


@dataclass(frozen=True)
class FlowConfig:
    """Dense / sparse optical-flow parameters.

    Field semantics mirror `cv2.calcOpticalFlowFarneback` and
    `cv2.calcOpticalFlowPyrLK` so the oracle and the device path are driven by
    one object.
    """

    method: str = "farneback"  # "farneback" | "lk_dense" | "lk_sparse"
    # --- shared pyramid controls ---
    levels: int = 5            # number of pyramid levels (incl. base)
    pyr_scale: float = 0.5     # Farneback inter-level scale (0 < s < 1)
    # --- Farneback ---
    winsize: int = 15          # neighborhood for flow averaging
    iterations: int = 3        # refinement iterations per level
    poly_n: int = 5            # polynomial-expansion neighborhood (5 or 7)
    poly_sigma: float = 1.1    # Gaussian applicability sigma
    gaussian_win: bool = False  # OPTFLOW_FARNEBACK_GAUSSIAN
    # --- Lucas-Kanade ---
    lk_winsize: int = 21       # LK integration window (odd)
    lk_max_iter: int = 10      # termination criteria maxCount
    lk_eps: float = 0.01       # termination criteria epsilon
    lk_min_eig: float = 1e-4   # minEigThreshold
    # --- performance knobs ---
    fast_warp: int = 0         # >0: gather-free select-sum warp with this
                               # per-level displacement clamp (px); 0 = exact
    bf16_poly: bool = False    # store polyexp planes in bfloat16 (halves
                               # warp bandwidth; ~4e-4 px EPE, PARITY.md)
    lk_block_halo: int = 0     # >0: sparse LK extracts one halo'd block per
                               # point per level (row-gather + one-hot
                               # contraction) and iterates gather-free
                               # inside it, clamping per-level displacement
                               # to the halo; 0 = exact per-iter slices
    lk_solver: str = "blockhalo"  # batched level-solver formulation
                               # (lk_block_halo > 0 only): "blockhalo" =
                               # per-iteration select-sum sub-blocks;
                               # "corr" / "corr_conv" = correlation-table
                               # iterations (same math exactly — b(o) is
                               # bilinear in the block, so all integer-
                               # offset correlations are precomputed once
                               # and each Gauss-Newton step is an O(K)
                               # table lookup + 2x2 solve, with early-exit
                               # while_loop); _conv builds the tables as
                               # one depthwise conv instead of static
                               # slice-reduces
    lk_blocked_gather: bool = True  # batched sparse LK extracts each
                               # point's template/search blocks via the
                               # blocked two-128-column-block gather + one-
                               # hot residual contraction (bit-exact);
                               # False = full-width row gather.
    temporal_init: bool = False  # pipeline warm start: seed each frame
                               # pair's coarsest level with the PREVIOUS
                               # pair's flow (cv2 OPTFLOW_USE_INITIAL_FLOW
                               # chained over time; Farneback only). Lets
                               # small `levels` budgets track motion that
                               # would otherwise exceed their pyramid
                               # reach; frame pair 0->1 is a cold start.

    def __post_init__(self):
        if self.method not in ("farneback", "lk_dense", "lk_sparse"):
            raise ValueError(f"unknown flow method {self.method!r}")
        if not (0.0 < self.pyr_scale < 1.0):
            raise ValueError("pyr_scale must be in (0, 1)")
        if self.poly_n % 2 == 0 or self.lk_winsize % 2 == 0:
            raise ValueError("poly_n and lk_winsize must be odd")
        if self.lk_solver not in ("blockhalo", "corr", "corr_conv"):
            raise ValueError(f"unknown lk_solver {self.lk_solver!r}")
        if self.temporal_init and self.method != "farneback":
            raise ValueError("temporal_init chains Farneback's initial-"
                             "flow warm start (OPTFLOW_USE_INITIAL_FLOW); "
                             f"method={self.method!r} has none")


@dataclass(frozen=True)
class EkfConfig:
    """Per-track (extended) Kalman filter parameters.

    Math contract (BASELINE.json:5 / SURVEY.md §2.3): predict x=Fx,
    P=FPF^T+Q; update with Cholesky innovation solve and Joseph-form
    covariance. State models: 4-state constant velocity [x,y,vx,vy]
    (BASELINE.json:7) and 6-state constant acceleration (BASELINE.json:9).
    """

    state_dim: int = 4          # 4 (constant velocity) | 6 (constant accel)
    dynamics: str = "auto"      # "auto" (cv/ca by state_dim) | "ct"
                                # (coordinated turn, 4-state, fixed rate)
    turn_rate: float = 0.0      # rad/frame for dynamics="ct"
    dt: float = 1.0             # frame interval
    q: float = 0.05             # process-noise spectral density (accel^2)
    r: float = 0.25             # measurement noise variance (px^2)
    p0_pos: float = 1.0         # initial position variance
    p0_vel: float = 10.0        # initial velocity variance
    p0_acc: float = 10.0        # initial acceleration variance (6-state)
    measurement: str = "position"  # "position" (linear KF)
                                   # | "implicit_flow" (EKF)
                                   # | "photometric" (appearance GN channel)
                                   # | "flow_photometric" (both, sequential)
                                   # | "render" (mesh-render GN channel —
                                   #   needs a RenderTemplate, models/render)
                                   # | "flow_render" (flow primary + render
                                   #   refine, sequential)
    iekf_iters: int = 1         # >1 enables the iterated-EKF variant
    filter_type: str = "ekf"    # "ekf" | "ukf" (unscented flow update;
                                # only affects nonlinear flow measurements)
    ukf_alpha: float = 1.0      # sigma-point spread (lam = a^2(n+k) - n;
                                # keep n+lam > 0 to avoid negative-weight
                                # covariance collapse)
    ukf_beta: float = 2.0       # prior-distribution constant (Gaussian)
    ukf_kappa: float = 0.0      # secondary scaling
    gate_chi2: float = 9.21     # chi^2(2 dof, 0.99) NIS gate
    max_misses: int = 5         # consecutive gated frames before re-seed
    adaptive_q: float = 0.0     # >0: Mehra-style per-track Q adaptation
                                # rate (NIS-driven scale in [0.1, 10])
    # --- photometric channel (models/photometric.py: the render-residual
    #     observation analog, SURVEY.md §2.1 #3/#4) ---
    photo_win: int = 13         # template window (odd)
    photo_iters: int = 5        # Gauss-Newton iterations
    photo_r: float = 4.0        # intensity noise variance sigma_I^2 (u8 scale)
    photo_min_eig: float = 0.1  # min structure-tensor eigenvalue / pixel gate
    photo_clip: float = 4.0     # per-iteration GN step clamp (px)
    # --- mesh-render channel (models/render.py: the deformed-mesh
    #     appearance observation, SURVEY.md §2.1 #3 — vertices coupled
    #     through shared triangles, survives rotation/stretch) ---
    render_iters: int = 5       # block-diagonal Gauss-Newton sweeps
    render_r: float = 4.0       # intensity noise variance sigma_I^2 (u8 scale)
    render_min_eig: float = 0.05  # min G eigenvalue per unit support gate
    render_clip: float = 2.0    # per-sweep GN step clamp (px)

    def __post_init__(self):
        if self.state_dim not in (4, 6):
            raise ValueError("state_dim must be 4 or 6")
        if self.measurement not in ("position", "implicit_flow",
                                    "photometric", "flow_photometric",
                                    "render", "flow_render"):
            raise ValueError(f"unknown measurement model {self.measurement!r}")
        if self.photo_win % 2 == 0:
            raise ValueError("photo_win must be odd")
        if self.filter_type not in ("ekf", "ukf"):
            raise ValueError(f"unknown filter_type {self.filter_type!r}")
        if self.dynamics not in ("auto", "ct"):
            raise ValueError(f"unknown dynamics model {self.dynamics!r}")
        if self.dynamics == "ct" and (
                self.state_dim != 4 or self.turn_rate == 0.0):
            raise ValueError("dynamics='ct' needs state_dim=4 and a "
                             "nonzero turn_rate")


@dataclass(frozen=True)
class TrackConfig:
    """Track seeding / lifecycle (fixed-capacity pool, SURVEY.md §7)."""

    num_tracks: int = 256       # fixed pool size (static shape under jit)
    quality_level: float = 0.01  # goodFeaturesToTrack quality ratio
    min_distance: float = 8.0   # NMS radius for seeding
    corner_block: int = 3       # structure-tensor window for Shi-Tomasi
    reinit: bool = True         # occlusion-gated re-seeding (BASELINE.json:11)
    reinit_every: int = 1       # corner-pool refresh interval (frames);
                                # >1 reuses the pool between refreshes
    corner_pool: int = 512      # per-frame candidate corners kept for re-init
    seed_in_body: bool = False  # restrict seeding to the segmented body
    init_velocity: bool = False  # init track velocity from the first flow
                                 # field (removes the dead-reckoning
                                 # convergence transient; off = oracle-parity)


@dataclass(frozen=True)
class SmoothConfig:
    """RTS smoother (BASELINE.json:11).

    chunk = 0: monolithic backward pass on device (history stays in HBM).
    chunk > 0: host-chunked smoothing (models.rts.rts_smooth_chunked) —
    O(chunk) device memory for long horizons (SURVEY.md §3.4 memory plan);
    also the mode `track_stream` uses for streaming smoothing (where it
    defaults to 64 if left at 0).
    lag > 0: ONLINE fixed-lag smoothing (models.rts.fixed_lag_smooth): the
    per-frame step keeps an (lag+1)-deep state window in the scan carry
    and emits the smoothed estimate of frame t-lag at step t — O(lag)
    device memory AND O(K) host traffic per frame (the chunked mode must
    ship the full P history to host every frame). In `track_stream`, lag takes precedence
    over chunk when both are set; the trailing window is flushed with a
    full in-window RTS at end of stream.
    """

    enabled: bool = False
    chunk: int = 0              # 0 = monolithic on-device; >0 = host-chunked
    lag: int = 0                # >0 = online fixed-lag smoother (streaming)

    def __post_init__(self):
        if self.chunk < 0 or self.lag < 0:
            raise ValueError("chunk and lag must be >= 0")


@dataclass(frozen=True)
class RunConfig:
    """Top-level pipeline configuration (one video -> trajectories)."""

    flow: FlowConfig = FlowConfig()
    ekf: EkfConfig = EkfConfig()
    tracks: TrackConfig = TrackConfig()
    smooth: SmoothConfig = SmoothConfig()
    pair_batch: bool = False    # cold-mode pair-batched pipeline: dense
                                # flow for EVERY frame pair of the clip is
                                # computed up front, batched over pairs,
                                # before one EKF/lifecycle scan over the
                                # precomputed fields; trajectory
                                # semantics match the per-frame scan.
                                # Requires a dense flow method, a
                                # flow-driven measurement model, and
                                # temporal_init=False (warm start is
                                # sequential by construction).
    dtype: str = "float32"
    data_axis: str = "data"     # mesh axis name for clip-parallel sharding

    def __post_init__(self):
        # cross-field validation: sparse LK drives a plain position KF
        # (measurement='photometric' is fine — it bypasses flow entirely),
        # so flow-based measurement models would be silently ignored
        if (self.flow.method == "lk_sparse"
                and self.ekf.measurement in ("implicit_flow",
                                             "flow_photometric",
                                             "flow_render")):
            raise ValueError(
                "flow.method='lk_sparse' always measures track positions "
                "(plain KF update); ekf.measurement="
                f"{self.ekf.measurement!r} would be silently ignored — "
                "use measurement='position' or a dense flow method")
        if (self.ekf.measurement in ("render", "flow_render")
                and self.tracks.reinit):
            # render tracks ARE mesh vertices: corner-pool re-seeding would
            # silently detach track slots from their template vertices
            raise ValueError(
                "ekf.measurement='render'/'flow_render' tracks mesh "
                "vertices whose identity the RenderTemplate fixes; set "
                "tracks.reinit=False (re-mesh via models.mesh instead)")
        if self.pair_batch:
            if self.flow.method not in ("farneback", "lk_dense"):
                raise ValueError(
                    "pair_batch precomputes DENSE flow for all pairs; "
                    f"flow.method={self.flow.method!r} is unsupported")
            if self.flow.temporal_init:
                raise ValueError(
                    "pair_batch requires temporal_init=False: the warm "
                    "start chains pairs sequentially, which is exactly "
                    "the dependency pair batching removes")
            if self.ekf.measurement not in ("position", "implicit_flow"):
                raise ValueError(
                    "pair_batch supports flow-driven measurements only "
                    "(position / implicit_flow); "
                    f"got {self.ekf.measurement!r}")
        if self.flow.method == "lk_sparse" and self.tracks.init_velocity:
            # init_velocity samples a DENSE frame0->1 flow field at the
            # seeds; with lk_sparse it would crash inside jit tracing
            raise ValueError(
                "tracks.init_velocity=True requires a dense flow method "
                "(it samples the frame0->1 flow field); "
                "flow.method='lk_sparse' has none")

    # ---- (de)serialization for CLI / checkpointing ----
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "RunConfig":
        raw = json.loads(text)
        # keep OLD run artifacts loadable: lk_sparse + a flow-based
        # measurement model was silently ignored before the cross-field
        # validation below existed — degrade to the behavior those runs
        # actually had (position KF) with a warning instead of refusing
        # to deserialize them
        flow_raw = raw.get("flow", {})
        ekf_raw = raw.get("ekf", {})
        if (flow_raw.get("method") == "lk_sparse"
                and ekf_raw.get("measurement") in ("implicit_flow",
                                                   "flow_photometric")):
            import warnings
            warnings.warn(
                "config JSON combines flow.method='lk_sparse' with "
                f"ekf.measurement={ekf_raw['measurement']!r}; that "
                "combination was always a position-KF update — loading it "
                "as measurement='position' (new configs must say so "
                "explicitly)", stacklevel=2)
            ekf_raw = dict(ekf_raw, measurement="position")
            raw = dict(raw, ekf=ekf_raw)

        def known(cls, section):
            # drop (with a warning) fields a config JSON carries that this
            # version no longer has — perf knobs come and go with their
            # measured verdicts, and an old run artifact must stay
            # loadable; its semantics never depended on them
            d = raw.get(section, {})
            names = {f.name for f in dataclasses.fields(cls)}
            unknown = sorted(set(d) - names)
            if unknown:
                import warnings
                warnings.warn(
                    f"config JSON section {section!r} carries fields this "
                    f"version no longer has: {unknown} — ignored",
                    stacklevel=3)
            return cls(**{k: v for k, v in d.items() if k in names})

        sections = ("flow", "ekf", "tracks", "smooth")
        top = {f.name for f in dataclasses.fields(RunConfig)}
        dropped = sorted(set(raw) - top - set(sections))
        if dropped:
            # e.g. the retired kernel switches impl / pallas_interpret:
            # the kernel choice is no longer a configuration field
            import warnings
            warnings.warn(f"config JSON carries top-level fields this "
                          f"version no longer has: {dropped} — ignored",
                          stacklevel=2)
        return RunConfig(
            flow=known(FlowConfig, "flow"),
            ekf=known(EkfConfig, "ekf"),
            tracks=known(TrackConfig, "tracks"),
            smooth=known(SmoothConfig, "smooth"),
            **{k: v for k, v in raw.items()
               if k in top and k not in sections},
        )

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)
