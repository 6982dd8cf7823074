"""Force-cache correctness: each step's closing evaluation, mass-delta
corrected, IS the next step's opening evaluation (sim/step.py), so the
Pallas leapfrog/hermite4_block paths run ONE full O(N^2) sweep per step."""
import pytest
import jax.numpy as jnp
import numpy as np

from al26.config import SimConfig
from al26.sim import init_cluster
from al26.sim.step import run_steps, step


def test_mass_delta_correction_is_exact():
    """Linearity in source masses: cached eval + correction == fresh eval
    with the new masses, to float round-off."""
    from al26.ops.nbody import (
        acc_jerk_pot_dense, acc_pot_dense, mass_delta_correction,
    )

    rng = np.random.default_rng(5)
    n, eps2 = 64, 0.05
    pos = jnp.asarray(rng.normal(size=(n, 3)))
    vel = jnp.asarray(rng.normal(size=(n, 3)))
    mass = jnp.asarray(rng.uniform(0.1, 2.0, n))
    src = jnp.asarray([3, 17, 40], jnp.int32)
    dm = jnp.asarray([-0.5, 1.2, -0.05])
    mass_new = mass.at[src].add(dm)

    a0, j0, _ = acc_jerk_pot_dense(pos, vel, mass, eps2)
    _, p0 = acc_pot_dense(pos, mass, 0.0)
    a, j, p = mass_delta_correction(a0, j0, p0, pos, vel, src, dm, eps2)
    a_ref, j_ref, _ = acc_jerk_pot_dense(pos, vel, mass_new, eps2)
    _, p_ref = acc_pot_dense(pos, mass_new, 0.0)
    np.testing.assert_allclose(np.asarray(a), np.asarray(a_ref),
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(np.asarray(j), np.asarray(j_ref),
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(np.asarray(p), np.asarray(p_ref),
                               rtol=1e-12, atol=1e-13)
    # padding slots (dm forced to 0) contribute nothing
    a2, j2, p2 = mass_delta_correction(
        a0, j0, p0, pos, vel,
        jnp.asarray([3, 17, 40, 0, 0], jnp.int32),
        jnp.concatenate([dm, jnp.zeros(2)]), eps2,
    )
    np.testing.assert_array_equal(np.asarray(a), np.asarray(a2))
    np.testing.assert_array_equal(np.asarray(p), np.asarray(p2))


def test_mass_delta_correction_chunked_bitwise():
    """The row-chunked path (block > 0, the large-N HBM-bounded variant
    that keeps run_steps compilable at N >= 2e5) equals the dense
    evaluation to compile-variation round-off: chunking splits the N
    targets, never the per-row sum over the M sources (XLA may
    reassociate the tiny M contraction differently between the two
    program shapes — observed 1 ulp on 1/300 elements in f64). Covers row
    padding (n not a multiple of block), jerk=None, pot_softened and the
    ensemble group mask."""
    from al26.ops.nbody import mass_delta_correction

    rng = np.random.default_rng(11)
    n = 100  # not a multiple of block: exercises the -1 target padding
    pos = jnp.asarray(rng.normal(size=(n, 3)))
    vel = jnp.asarray(rng.normal(size=(n, 3)))
    acc = jnp.asarray(rng.normal(size=(n, 3)))
    jerk = jnp.asarray(rng.normal(size=(n, 3)))
    pot = jnp.asarray(rng.normal(size=n))
    src = jnp.asarray([3, 17, 40, 77, 0], jnp.int32)
    dm = jnp.asarray([-0.5, 1.2, -0.05, -0.3, 0.0])

    for kw in ({}, {"jerk_none": True}, {"pot_softened": True},
               {"group_size": 25}):
        j_in = None if kw.pop("jerk_none", False) else jerk
        dense = mass_delta_correction(acc, j_in, pot, pos, vel, src, dm,
                                      0.05, block=0, **kw)
        chunk = mass_delta_correction(acc, j_in, pot, pos, vel, src, dm,
                                      0.05, block=32, **kw)
        np.testing.assert_allclose(np.asarray(dense[0]),
                                   np.asarray(chunk[0]),
                                   rtol=1e-14, atol=1e-16)
        if j_in is not None:
            np.testing.assert_allclose(np.asarray(dense[1]),
                                       np.asarray(chunk[1]),
                                       rtol=1e-14, atol=1e-16)
        else:
            assert dense[1] is None and chunk[1] is None
        np.testing.assert_allclose(np.asarray(dense[2]),
                                   np.asarray(chunk[2]),
                                   rtol=1e-14, atol=1e-16)


# slow lane (round-5 re-tier): leapfrog cache equality (the hermite4/block cache equalities and the cross-chunk threading test stay default)
@pytest.mark.slow
def test_cached_leapfrog_equals_uncached():
    """Without mass evolution the cache is mathematically identical to a
    fresh opening sweep (same kernel call at the same operands): step-level
    application is BITWISE identical, and the scanned run matches per-step
    stepping to compile-variation round-off (a reduction may re-associate
    between the scan and standalone-step programs)."""
    from al26.sim.step import _step_impl, fresh_cache

    cfg = SimConfig(n=96, rc=1.0, final_time=1.0, seed=9, dtype="f32",
                    integrator="leapfrog", leapfrog_n_sub=2,
                    star_max_mass=3.0, no_massive_star_requirement=True)
    state, aux, cfg = init_cluster(cfg)
    # step-level: bitwise
    cache = fresh_cache(state, cfg, "leapfrog")
    s_c, cache = _step_impl(state, aux, cfg, None, "pallas", cache)
    s_c, cache = _step_impl(s_c, aux, cfg, None, "pallas", cache)
    s_u = step(step(state, aux, cfg, force_impl="pallas"), aux, cfg,
               force_impl="pallas")
    np.testing.assert_array_equal(np.asarray(s_c.cluster.pos),
                                  np.asarray(s_u.cluster.pos))
    np.testing.assert_array_equal(np.asarray(s_c.cluster.vel),
                                  np.asarray(s_u.cluster.vel))
    # scanned run: round-off only
    s_cached = run_steps(state, aux, cfg, 5, force_impl="pallas")
    s_plain = state
    for _ in range(5):
        s_plain = step(s_plain, aux, cfg, force_impl="pallas")
    np.testing.assert_allclose(np.asarray(s_cached.cluster.pos),
                               np.asarray(s_plain.cluster.pos),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(s_cached.cluster.slr),
                               np.asarray(s_plain.cluster.slr),
                               rtol=1e-5, atol=1e-32)


def test_cached_block_with_mass_loss_tracks_uncached():
    """With evolving massive stars, the cached hermite4_block path differs
    from per-step stepping only by P(EC) reuse + the (exact) mass-delta
    correction — trajectories and deposition must track tightly."""
    cfg = SimConfig(n=96, rc=1.0, final_time=10.0, seed=31, dtype="f32",
                    integrator="hermite4_block", k_fast=16)
    state, aux, cfg = init_cluster(cfg)
    s_cached = run_steps(state, aux, cfg, 10, force_impl="pallas")
    s_plain = state
    for _ in range(10):
        s_plain = step(s_plain, aux, cfg, force_impl="pallas")
    np.testing.assert_allclose(np.asarray(s_cached.cluster.pos),
                               np.asarray(s_plain.cluster.pos),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(s_cached.cluster.slr),
                               np.asarray(s_plain.cluster.slr),
                               rtol=2e-3, atol=1e-30)
    # mass evolution itself is identical (time-based, not force-based)
    np.testing.assert_array_equal(np.asarray(s_cached.cluster.mass),
                                  np.asarray(s_plain.cluster.mass))


def test_cached_run_steps_cached_threads_across_chunks():
    """run_steps_cached(state, cache) across two chunks == one chunk of the
    same total length (the driver's checkpoint-boundary threading)."""
    from al26.sim.step import _resolve_integ, fresh_cache, run_steps_cached

    cfg = SimConfig(n=96, rc=1.0, final_time=1.0, seed=9, dtype="f32",
                    integrator="leapfrog", leapfrog_n_sub=2,
                    star_max_mass=3.0, no_massive_star_requirement=True)
    state, aux, cfg = init_cluster(cfg)
    integ = _resolve_integ(cfg, state.cluster.n)
    cache = fresh_cache(state, cfg, integ)
    s1, cache = run_steps_cached(state, cache, aux, cfg, 3,
                                 force_impl="pallas")
    s1, cache = run_steps_cached(s1, cache, aux, cfg, 4,
                                 force_impl="pallas")
    cache0 = fresh_cache(state, cfg, integ)
    s2, _ = run_steps_cached(state, cache0, aux, cfg, 7,
                             force_impl="pallas")
    np.testing.assert_array_equal(np.asarray(s1.cluster.pos),
                                  np.asarray(s2.cluster.pos))


@pytest.mark.slow
def test_ensemble_flat_cache_matches_uncached(monkeypatch):
    """The flat ensemble's cached scan equals the uncached flat stepping
    (bitwise without mass evolution; the mass-delta correction is exact, so
    with massive stars only float summation order differs)."""
    import al26.ops.backend as pk
    from al26.parallel.ensemble import (
        ensemble_run_steps, ensemble_step_flat, init_ensemble,
    )

    monkeypatch.setattr(pk, "kernel_here", lambda n, dtype: True)

    cfg = SimConfig(n=24, rc=1.0, final_time=1.0, seed=12, dtype="f32",
                    star_max_mass=3.0, no_massive_star_requirement=True)
    bs, ba, cfgs = init_ensemble(cfg, 3)
    cfg = cfgs[0]
    assert cfg.integrator == "leapfrog"
    out_cached = ensemble_run_steps(bs, ba, cfg, 4, flat=True)
    s = bs
    for _ in range(4):
        s = ensemble_step_flat(s, ba, cfg)
    np.testing.assert_array_equal(np.asarray(out_cached.cluster.pos),
                                  np.asarray(s.cluster.pos))
    np.testing.assert_array_equal(np.asarray(out_cached.cluster.slr),
                                  np.asarray(s.cluster.slr))

    # with evolving massive stars: exact correction, tight tracking
    cfg2 = SimConfig(n=24, rc=1.0, final_time=10.0, seed=13, dtype="f32")
    bs2, ba2, cfgs2 = init_ensemble(cfg2, 3)
    cfg2 = cfgs2[0]
    out_c = ensemble_run_steps(bs2, ba2, cfg2, 4, flat=True)
    s2 = bs2
    for _ in range(4):
        s2 = ensemble_step_flat(s2, ba2, cfg2)
    np.testing.assert_allclose(np.asarray(out_c.cluster.pos),
                               np.asarray(s2.cluster.pos),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out_c.cluster.slr),
                               np.asarray(s2.cluster.slr),
                               rtol=1e-4, atol=1e-30)


def test_cached_hermite4_with_mass_loss_tracks_uncached():
    """Shared-adaptive hermite4 (round-2 cache extension): every substep
    routes through the pot-returning evaluation and the LAST substep's
    P(EC) evaluation carries into the next step — S sweeps per outer step
    instead of S+1. Trajectories must track the uncached path tightly."""
    cfg = SimConfig(n=96, rc=1.0, final_time=10.0, seed=31, dtype="f32",
                    integrator="hermite4")
    state, aux, cfg = init_cluster(cfg)
    s_cached = run_steps(state, aux, cfg, 10, force_impl="pallas")
    s_plain = state
    for _ in range(10):
        s_plain = step(s_plain, aux, cfg, force_impl="pallas")
    np.testing.assert_allclose(np.asarray(s_cached.cluster.pos),
                               np.asarray(s_plain.cluster.pos),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(s_cached.cluster.slr),
                               np.asarray(s_plain.cluster.slr),
                               rtol=2e-3, atol=1e-30)
    np.testing.assert_array_equal(np.asarray(s_cached.cluster.mass),
                                  np.asarray(s_plain.cluster.mass))


def test_hermite4_energy_conserved_with_cache():
    """The P(EC) opening-eval reuse must not degrade energy conservation:
    a massive-star-free cluster stays within the uncached drift bound."""
    from al26.ops.nbody import acc_pot_dense
    from al26.units import G_INTERNAL

    cfg = SimConfig(n=64, rc=1.0, final_time=1.0, seed=17, dtype="f32",
                    integrator="hermite4", star_max_mass=3.0,
                    no_massive_star_requirement=True)
    state, aux, cfg = init_cluster(cfg)

    def etot(s):
        # energy of the SOFTENED system the integrator actually solves
        c = s.cluster
        _, pot = acc_pot_dense(c.pos, c.mass, cfg.eps2)
        ke = 0.5 * jnp.sum(c.mass * jnp.sum(c.vel**2, -1))
        return float(ke + 0.5 * jnp.sum(c.mass * pot))

    e0 = etot(state)
    s_end = run_steps(state, aux, cfg, 20, force_impl="pallas")
    assert abs(etot(s_end) - e0) / abs(e0) < 5e-4


@pytest.mark.slow
def test_cached_trajectory_matches_uncached():
    """run_steps_traj_cached (round 3: interloper runs keep the force
    cache) matches the uncached trajectory run — with no mass evolution
    the mass-delta correction adds exactly 0.0, so the physics and the
    trajectory rows are identical."""
    from al26.sim.step import run_steps_traj, run_steps_traj_cached

    cfg = SimConfig(n=64, rc=0.5, final_time=1.0, seed=6, dtype="f32",
                    integrator="leapfrog", leapfrog_n_sub=2,
                    star_max_mass=3.0, no_massive_star_requirement=True,
                    interloper=True, interloper_mass=3.0,
                    interloper_velocity=20.0, interloper_radius=0.05,
                    interloper_offset_time=0.0,
                    interloper_trajectory=True)
    state, aux, cfg = init_cluster(cfg)
    from al26.sim.step import fresh_cache

    cache = fresh_cache(state, cfg, "leapfrog")
    s_c, _, rows_c = run_steps_traj_cached(state, cache, aux, cfg, 10,
                                           None, "pallas")
    s_u, rows_u = run_steps_traj(state, aux, cfg, 10, force_impl="pallas")
    np.testing.assert_allclose(np.asarray(rows_c), np.asarray(rows_u),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(s_c.cluster.pos),
                               np.asarray(s_u.cluster.pos),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(s_c.cluster.agb_raw),
                               np.asarray(s_u.cluster.agb_raw),
                               rtol=1e-6, atol=1e-32)
    # driver path: a trajectory run engages the cache (writes the file)
    import os
    import tempfile

    from al26.sim.driver import run

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)
        try:
            run(cfg.replace(filename="tj", final_time=0.1, n_plot=2,
                            steps_per_plot=5, force_impl="pallas"),
                progress=False)
            assert os.path.exists("interloper_trajectory.dat")
        finally:
            os.chdir(cwd)


@pytest.mark.slow  # compile-only but ~40 s of CPU XLA lowering at N=2e5;
# the correction's VALUES are covered by the default force-cache tests
def test_mass_delta_correction_memory_bounded_at_2e5():
    """The compiled correction's temporaries stay bounded at the scale
    that ran out of memory before row-chunking (N=204800, M=1655: the
    dense path compiled 10.1 GB of [N,M,3] broadcast temporaries, the
    auto-chunked one 0.26 GB — docs/validation.md). Pins the auto
    threshold against regression via the compiled program's own memory
    analysis (no execution)."""
    import jax

    from al26.ops.nbody import mass_delta_correction

    n, m = 204800, 1655
    sds = jax.ShapeDtypeStruct
    f32 = jnp.float32
    a = sds((n, 3), f32)
    p = sds((n,), f32)
    src = sds((m,), jnp.int32)
    dm = sds((m,), f32)
    fn = jax.jit(lambda acc, jerk, pot, po, ve, s, d:
                 mass_delta_correction(acc, jerk, pot, po, ve, s, d, 0.125))
    ma = fn.lower(a, a, p, a, a, src, dm).compile().memory_analysis()
    assert ma.temp_size_in_bytes < 2**30  # < 1 GB; dense was ~10 GB
