"""Three-level block-timestep Hermite (cfg.k_ultra): the k_ultra fastest
rows subcycle at the shared minimum while the rest of the fast group steps
at its own shared-minimum pace (ops/integrators.py:hermite4_block_advance).
Must track the two-level scheme to f32 round-off."""
import jax.numpy as jnp
import numpy as np
import pytest

from al26.config import SimConfig
from al26.ops.nbody import total_energy
from al26.sim import init_cluster
from al26.sim.step import (
    fresh_cache, run_steps, run_steps_cached_strided,
)


def _run(cfg, n_steps=40):
    state, aux, cfg = init_cluster(cfg)
    return run_steps(state, aux, cfg, n_steps), cfg


# slow lane (round-5 re-tier): k_ultra tier equality run (the stride/tier composition equalities keep a faster default sibling in test_stride)
@pytest.mark.slow
def test_tiered_tracks_two_level():
    base = dict(n=384, rc=0.5, final_time=10.0, seed=21, dtype="f32",
                integrator="hermite4_block", k_fast=96)
    s0, cfg = _run(SimConfig(**base))
    s1, _ = _run(SimConfig(k_ultra=32, **base))
    p0, p1 = np.asarray(s0.cluster.pos), np.asarray(s1.cluster.pos)
    np.testing.assert_allclose(p1, p0, rtol=1e-4, atol=1e-5)
    e0 = float(total_energy(s0.cluster.pos, s0.cluster.vel,
                            s0.cluster.mass, cfg.eps2))
    e1 = float(total_energy(s1.cluster.pos, s1.cluster.vel,
                            s1.cluster.mass, cfg.eps2))
    assert abs(e1 - e0) / abs(e0) < 1e-5
    # per-dt physics identical (masses follow the same stellar evolution)
    np.testing.assert_array_equal(np.asarray(s0.cluster.mass),
                                  np.asarray(s1.cluster.mass))


@pytest.mark.slow  # composition equality; k_ultra and the stride each
# have their own faster default tests (test_tiered_tracks_two_level,
# test_stride2_tracks_unstrided)
def test_tiered_with_gravity_stride():
    """k_ultra composes with the gravity stride (interior sample capture
    runs per tier, sim/step.py:_stride_impl)."""
    base = dict(n=256, rc=0.8, final_time=10.0, seed=5, dtype="f32",
                integrator="hermite4_block", k_fast=64, k_ultra=16)
    cfg = SimConfig(**base)
    state, aux, cfg = init_cluster(cfg)
    s0 = run_steps(state, aux, cfg, 8, force_impl="pallas")
    cfg2 = cfg.replace(gravity_stride=2)
    cache = fresh_cache(state, cfg2, "hermite4_block")
    s2, _ = run_steps_cached_strided(state, cache, aux, cfg2, 8,
                                     force_impl="pallas")
    assert int(s2.step_count) == 8
    np.testing.assert_allclose(np.asarray(s2.cluster.pos),
                               np.asarray(s0.cluster.pos),
                               rtol=1e-4, atol=1e-5)


# slow lane (round-5 re-tier): k_ultra edge-bounds sweep (the stride/tier default coverage remains in test_stride)
@pytest.mark.slow
def test_tiered_degenerate_bounds():
    """k_ultra >= k_fast or 0 falls back to the two-level loop (exact)."""
    base = dict(n=192, rc=1.0, final_time=10.0, seed=9, dtype="f32",
                integrator="hermite4_block", k_fast=48)
    s0, _ = _run(SimConfig(**base), 10)
    s_same, _ = _run(SimConfig(k_ultra=48, **base), 10)  # == k_fast: off
    np.testing.assert_array_equal(np.asarray(s0.cluster.pos),
                                  np.asarray(s_same.cluster.pos))
