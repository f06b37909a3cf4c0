"""GPU bring-up surfaces that the CPU suite can reach: the XLA-only
kernel policy, the compile-cache rule of the entry points, chip_smoke.py's
refusal off the GPU and each of its phases at a tiny size (the --four
phase on 4 virtual CPU devices), and the analytic flow it scores against.
"""

import json
import os
import shutil
import subprocess
import sys
import warnings

import numpy as np
import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


# ----------------------------------------------------- kernel policy

def test_kernel_switch_is_not_a_config_field():
    """No hand-written kernel is left, so there is no switch to set: a
    request for one is an error on every backend, never a silent XLA
    fallback."""
    from kalman_hydra_tpu.config import RunConfig
    with pytest.raises(TypeError):
        RunConfig(impl="pallas")
    with pytest.raises(TypeError):
        RunConfig(pallas_interpret=True)


def test_old_kernel_config_json_loads_with_warning():
    from kalman_hydra_tpu.config import RunConfig
    raw = json.loads(RunConfig().to_json())
    raw.update(impl="pallas", pallas_interpret=True)
    raw["flow"].update(fi_tile_h=64, pe_fused=True)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        cfg = RunConfig.from_json(json.dumps(raw))
    assert cfg == RunConfig()
    msgs = " ".join(str(w.message) for w in rec)
    assert "impl" in msgs and "fi_tile_h" in msgs


def test_package_has_no_kernel_layer():
    import importlib.util
    assert importlib.util.find_spec("kalman_hydra_tpu.kernels") is None


# ----------------------------------------------------- compile cache

@pytest.fixture()
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_follows_env_var(tmp_path, monkeypatch,
                                       restore_cache_dir):
    from kalman_hydra_tpu.utils import compile_cache as cc
    monkeypatch.setenv(cc.ENV_VAR, str(tmp_path / "cc"))
    assert cc.enable_compile_cache(ROOT) == str(tmp_path / "cc")
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "cc")


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    from kalman_hydra_tpu.utils import compile_cache as cc
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    want = os.path.join(ROOT, ".jax_cache")
    assert cc.compile_cache_dir() == want
    assert cc.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_compile_cache_unset_outside_a_checkout(tmp_path, monkeypatch):
    from kalman_hydra_tpu.utils import compile_cache as cc
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    assert cc.compile_cache_dir(str(tmp_path)) is None


# ----------------------------------------------------- chip_smoke.py

def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu_backend():
    r = _run_smoke(ROOT, os.path.join(ROOT, "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "not 'gpu'" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path), "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_gpu_line_without_nvidia_smi(monkeypatch):
    import chip_smoke
    monkeypatch.setenv("PATH", "")
    assert chip_smoke.gpu_line().startswith("nvidia-smi")


@pytest.fixture(scope="module")
def tiny_smoke(tmp_path_factory):
    import chip_smoke
    clip, geom = chip_smoke.make_clip(96, 128, 5)
    main_cfg, fast_cfg = chip_smoke.configs(32)
    work = str(tmp_path_factory.mktemp("smoke"))
    results = chip_smoke.phase_main(clip, main_cfg, fast_cfg, work)
    return clip, geom, main_cfg, fast_cfg, results


def test_chip_smoke_main_phase_tiny(tiny_smoke, capsys):
    clip, _, _, _, results = tiny_smoke
    assert results["main"].positions.shape == (5, 32, 2)
    assert results["main"].smoothed is not None
    assert np.isfinite(results["fast"].positions).all()


def test_chip_smoke_parity_phase_tiny(tiny_smoke, capsys):
    import chip_smoke
    clip, geom, main_cfg, fast_cfg, results = tiny_smoke
    nums = chip_smoke.phase_parity(clip, geom, main_cfg, fast_cfg, results)
    # CPU against CPU: the comparison machinery reports zero difference
    assert float(nums["f32_flow_max"]) == 0.0
    assert nums["f32_alive_mismatch"] == 0
    assert nums["bf16_alive_mismatch"] == 0
    assert float(nums["f32_epe"]) < chip_smoke.EPE_TOL
    assert "[parity]" in capsys.readouterr().out


def test_chip_smoke_four_phase_on_virtual_devices(capsys):
    import chip_smoke
    assert len(jax.devices()) >= 4
    nums = chip_smoke.phase_four(4, clip_hw=(64, 96), frames=3,
                                 num_tracks=8, band_hw=(128, 96),
                                 band_levels=3)
    assert nums["dp_devices"] == 4 and nums["band_devices"] == 4
    assert nums["dp_alive_equal"]
    assert "[four]" in capsys.readouterr().out


# ------------------------------------------------ analytic blob flow

def test_moving_blob_flow_matches_point_truth():
    from kalman_hydra_tpu.io.synthetic import (moving_blob_clip,
                                               moving_blob_flow)
    geom = dict(height=96, width=128, blob_sigma=12.0,
                velocity=(2.1, -1.4), accel=(0.1, 0.05))
    _, truth = moving_blob_clip(num_frames=4, num_points=8, seed=0, **geom)
    flow, valid = moving_blob_flow(2, **geom)
    disp = truth.positions[3] - truth.positions[2]
    assert valid.any() and (~valid).any()
    inside = valid & (np.abs(flow).sum(-1) > 0)
    np.testing.assert_allclose(flow[inside], np.broadcast_to(
        disp[0], flow[inside].shape), atol=1e-5)
    assert (flow[valid & ~inside] == 0).all()


def test_farneback_sharded_device_output():
    """as_numpy=False hands back the row-sharded device array."""
    from jax.sharding import Mesh
    from kalman_hydra_tpu.config import FlowConfig
    from kalman_hydra_tpu.io.synthetic import translating_pair
    from kalman_hydra_tpu.parallel.spatial import farneback_sharded
    a, b, _ = translating_pair(height=64, width=64, shift=(1.0, -0.5))
    mesh = Mesh(np.array(jax.devices()[:2]), ("space",))
    cfg = FlowConfig(levels=2, fast_warp=4)
    out = farneback_sharded(a, b, cfg, mesh=mesh, as_numpy=False)
    assert len({s.device for s in out.addressable_shards}) == 2
    np.testing.assert_array_equal(
        np.asarray(out), farneback_sharded(a, b, cfg, mesh=mesh))
