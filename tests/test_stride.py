"""Gravity stride (cfg.gravity_stride): one hermite4_block force advance
spanning m physics steps, interior steps on predictor-sampled positions.
All SLR physics still runs every dt."""
import pytest
import jax.numpy as jnp
import numpy as np

from al26.config import SimConfig
from al26.sim import init_cluster
from al26.sim.step import (
    fresh_cache, run_steps, run_steps_cached_strided, stride_active,
)


def _cfg(**kw):
    base = dict(n=96, rc=1.0, final_time=10.0, seed=31, dtype="f32",
                integrator="hermite4_block", k_fast=16)
    base.update(kw)
    return SimConfig(**base)


def test_stride_gate():
    cfg = _cfg(gravity_stride=2)
    assert stride_active(cfg, 96, jnp.float32, None, "pallas")
    # off by default, off for other integrators, off with natal kicks
    assert not stride_active(_cfg(), 96, jnp.float32, None, "pallas")
    assert not stride_active(
        _cfg(gravity_stride=2, integrator="leapfrog", leapfrog_n_sub=2),
        96, jnp.float32, None, "pallas")
    assert not stride_active(_cfg(gravity_stride=2, natal_kicks=True),
                             96, jnp.float32, None, "pallas")


def test_stride2_tracks_unstrided():
    """Trajectories and deposition must track the exact per-step path
    closely (interior positions are predictor samples, O(dt^4) off)."""
    cfg1 = _cfg()
    state, aux, cfg1 = init_cluster(cfg1)
    cfg2 = cfg1.replace(gravity_stride=2)

    s1 = run_steps(state, aux, cfg1, 10, force_impl="pallas")
    cache = fresh_cache(state, cfg2, "hermite4_block")
    s2, _ = run_steps_cached_strided(state, cache, aux, cfg2, 10,
                                     force_impl="pallas")
    assert int(s2.step_count) == 10
    assert float(s2.time) == float(s1.time)
    np.testing.assert_allclose(np.asarray(s2.cluster.pos),
                               np.asarray(s1.cluster.pos),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(s2.cluster.slr),
                               np.asarray(s1.cluster.slr),
                               rtol=5e-3, atol=1e-30)
    # per-step physics DID run every dt: wind deposition is nonzero and
    # the masses follow the same per-dt stellar evolution
    np.testing.assert_array_equal(np.asarray(s2.cluster.mass),
                                  np.asarray(s1.cluster.mass))
    assert float(np.asarray(s2.cluster.slr).sum()) > 0


def test_stride_remainder_steps():
    """n_steps not divisible by the stride: the remainder runs as plain
    cached steps; step_count/time land exactly."""
    cfg = _cfg(gravity_stride=4)
    state, aux, cfg = init_cluster(cfg)
    cache = fresh_cache(state, cfg, "hermite4_block")
    s, _ = run_steps_cached_strided(state, cache, aux, cfg, 7,
                                    force_impl="pallas")
    assert int(s.step_count) == 7
    np.testing.assert_allclose(float(s.time), 7 * cfg.dt, rtol=1e-6)


def test_stride_fewer_steps_than_stride():
    """n_steps < gravity_stride: zero full strides, remainder-only path
    (run_steps_cached_strided's divmod composition)."""
    cfg = _cfg(gravity_stride=8)
    state, aux, cfg = init_cluster(cfg)
    cache = fresh_cache(state, cfg, "hermite4_block")
    s, _ = run_steps_cached_strided(state, cache, aux, cfg, 3,
                                    force_impl="pallas")
    assert int(s.step_count) == 3
    np.testing.assert_allclose(float(s.time), 3 * cfg.dt, rtol=1e-6)


def test_run_steps_auto_engages_stride():
    """run_steps itself honours cfg.gravity_stride on the capable path."""
    cfg = _cfg(gravity_stride=2)
    state, aux, cfg = init_cluster(cfg)
    s_auto = run_steps(state, aux, cfg, 6, force_impl="pallas")
    cache = fresh_cache(state, cfg, "hermite4_block")
    s_manual, _ = run_steps_cached_strided(state, cache, aux, cfg, 6,
                                           force_impl="pallas")
    np.testing.assert_array_equal(np.asarray(s_auto.cluster.pos),
                                  np.asarray(s_manual.cluster.pos))


@pytest.mark.slow  # mesh variant of test_stride2_tracks_unstrided
def test_stride_on_mesh_tracks_unstrided():
    """Round 3: the gravity stride engages on the mesh path (previously
    single-chip only) — one column-sharded force advance spanning m steps,
    tracking the unstrided mesh run at the single-chip stride tolerances."""
    from al26.parallel.sharded import make_mesh, shard_state_rows

    cfg1 = _cfg()
    state, aux, cfg1 = init_cluster(cfg1)
    cfg2 = cfg1.replace(gravity_stride=2)
    mesh = make_mesh(8)
    assert stride_active(cfg2, 96, jnp.float32, mesh, "auto")
    assert stride_active(cfg2, 96, jnp.float32, mesh, "ring")
    state_m = shard_state_rows(state, mesh)
    s1 = run_steps(state_m, aux, cfg1, 10, mesh=mesh)
    cache = fresh_cache(state_m, cfg2, "hermite4_block", mesh)
    s2, _ = run_steps_cached_strided(state_m, cache, aux, cfg2, 10,
                                     mesh=mesh, force_impl="auto")
    assert int(s2.step_count) == 10
    assert float(s2.time) == float(s1.time)
    np.testing.assert_allclose(np.asarray(s2.cluster.pos),
                               np.asarray(s1.cluster.pos),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(s2.cluster.slr),
                               np.asarray(s1.cluster.slr),
                               rtol=5e-3, atol=1e-30)
    # per-dt physics ran every step on both sides
    np.testing.assert_array_equal(np.asarray(s2.cluster.mass),
                                  np.asarray(s1.cluster.mass))


@pytest.mark.slow
def test_stride_mesh_one_sweep_per_stride(monkeypatch):
    """One eager mesh stride of m=2 physics steps runs exactly ONE full
    row sweep (the closing evaluation; the subcycle's K x N row work goes
    through the column-sharded rows fn)."""
    import al26.parallel.sharded as shd
    from al26.sim.step import _stride_impl

    counter = {"n": 0}
    real = shd._local_rows_force

    def counting(*a, **kw):
        counter["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(shd, "_local_rows_force", counting)

    cfg = _cfg(gravity_stride=2)
    state, aux, cfg = init_cluster(cfg)
    mesh = shd.make_mesh(8)
    state = shd.shard_state_rows(state, mesh)
    cache = fresh_cache(state, cfg, "hermite4_block", mesh)
    counter["n"] = 0
    s, _ = _stride_impl(state, aux, cfg, cache, 2, mesh, "auto")
    assert int(s.step_count) == 2
    assert counter["n"] == 1, counter["n"]


@pytest.mark.slow  # mesh + async-save integration; the async writer
# and the mesh driver each have faster default tests
def test_driver_mesh_async_saves(tmp_path):
    """Regression: a mesh_shape driver run with the DEFAULT async writer
    must not deadlock. The writer's background device->host pull used to
    race the next chunk's all_gather and starve XLA's in-process CPU
    collective rendezvous (20 s timeout -> process abort); the driver now
    gathers sharded state on the main thread before submitting the job."""
    import os

    from al26.sim.driver import run

    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        r2 = run(SimConfig(filename="m1", n=96, rc=1.0, final_time=0.3,
                           seed=8, dtype="f32", integrator="hermite4_block",
                           k_fast=16, n_plot=3, steps_per_plot=10,
                           mesh_shape=(8,), gravity_stride=2,
                           async_saves=True),
                 progress=False)
    finally:
        os.chdir(cwd)
    # the run completed (no rendezvous abort) and wrote the file set
    assert abs(float(r2.state.time) - 0.3) < 1e-6
    assert np.isfinite(np.asarray(r2.state.cluster.pos)).all()
    assert (tmp_path / "m1-cluster-yields.csv").exists()
    # accuracy of the mesh+stride path vs single-chip is pinned by
    # test_stride_on_mesh_tracks_unstrided / test_driver_runs_with_stride


@pytest.mark.slow  # driver-level stride run; engagement is covered by
# the faster test_run_steps_auto_engages_stride
def test_driver_runs_with_stride(tmp_path):
    """End-to-end driver run with gravity_stride=2 produces the full file
    set and a final state matching stride=1 closely."""
    import os

    from al26.sim.driver import run

    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        common = dict(n=96, rc=1.0, final_time=0.5, seed=8, dtype="f32",
                      integrator="hermite4_block", k_fast=16,
                      force_impl="pallas", n_plot=5, steps_per_plot=4)
        r1 = run(SimConfig(filename="s1", **common), progress=False)
        r2 = run(SimConfig(filename="s2", gravity_stride=2, **common),
                 progress=False)
    finally:
        os.chdir(cwd)
    assert float(r2.state.time) == float(r1.state.time)
    np.testing.assert_allclose(np.asarray(r2.state.cluster.pos),
                               np.asarray(r1.state.cluster.pos),
                               rtol=1e-4, atol=1e-5)
    assert (tmp_path / "s2-cluster-yields.csv").exists()
