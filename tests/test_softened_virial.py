"""cfg.softened_virial: the virial radius (global wind-bubble size) from
the BHTree-softened potential instead of the reference's raw one
(sim/step.py:_pot_eps2) — a documented speed/parity trade."""
import pytest
import jax.numpy as jnp
import numpy as np

from al26.config import SimConfig
from al26.sim import init_cluster
from al26.sim.step import run_steps, step


@pytest.mark.slow
def test_softened_virial_shifts_only_global_channel():
    base = dict(n=256, rc=1.0, final_time=10.0, seed=44, dtype="f32",
                integrator="hermite4_block", k_fast=64)
    state, aux, cfg = init_cluster(SimConfig(**base))
    s0 = run_steps(state, aux, cfg, 30, force_impl="pallas")
    s1 = run_steps(state, aux, cfg.replace(softened_virial=True), 30,
                   force_impl="pallas")
    slr0 = np.asarray(s0.cluster.slr)
    slr1 = np.asarray(s1.cluster.slr)
    # trajectories and the LOCAL wind channel (per-star bubbles, no r_vir
    # dependence) are identical; the GLOBAL channel dilutes by the bubble
    # volume ratio (r_vir grows 6-18%: the softened U is shallower)
    np.testing.assert_array_equal(np.asarray(s0.cluster.pos),
                                  np.asarray(s1.cluster.pos))
    np.testing.assert_array_equal(slr0[:, :, 0], slr1[:, :, 0])
    g0 = float(slr0[:, 0, 1].sum())
    g1 = float(slr1[:, 0, 1].sum())
    if g0 > 0:
        assert g0 != g1                 # the parity trade is real
        assert g1 < g0                  # bigger bubble -> diluted
        assert abs(g1 - g0) / g0 < 0.5  # bounded by the volume ratio


# slow lane (round-5 re-tier): softened-virial x cache cross-variant (the softened-virial physics bounds and the cache equalities stay default separately)
@pytest.mark.slow
def test_softened_virial_cache_matches_uncached():
    """The force cache's mass-delta correction must mirror the softened
    pot convention (ops/nbody.py:mass_delta_correction pot_softened),
    else the cached potential drifts from the true one on every
    mass-loss step — cached and uncached runs must agree closely."""
    cfg = SimConfig(n=192, rc=1.0, final_time=10.0, seed=44, dtype="f32",
                    integrator="hermite4_block", k_fast=48,
                    softened_virial=True)
    state, aux, cfg = init_cluster(cfg)
    s_cached = run_steps(state, aux, cfg, 25, force_impl="pallas")
    s_plain = state
    for _ in range(25):
        s_plain = step(s_plain, aux, cfg, force_impl="pallas")
    np.testing.assert_allclose(np.asarray(s_cached.cluster.pos),
                               np.asarray(s_plain.cluster.pos),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(s_cached.cluster.slr),
                               np.asarray(s_plain.cluster.slr),
                               rtol=1e-4, atol=1e-30)
