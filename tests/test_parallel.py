"""Multi-device tests on the 8-device fake CPU mesh (SURVEY.md §4g)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from al26.config import SimConfig
from al26.ops.nbody import acc_jerk_pot_dense, potential_energy
from al26.parallel.ensemble import (
    ensemble_run_steps, init_ensemble, make_ensemble_mesh, shard_ensemble,
)
from al26.parallel.sharded import (
    make_mesh, make_sharded_force, shard_state_rows, sharded_acc_jerk_pot,
    sharded_potential_energy,
)
from al26.sim import init_cluster, run_steps, step


def test_eight_fake_devices():
    assert len(jax.devices()) == 8


def test_sharded_force_matches_dense():
    rng = np.random.default_rng(0)
    n = 256
    pos = jnp.asarray(rng.normal(size=(n, 3)))
    vel = jnp.asarray(rng.normal(size=(n, 3)))
    mass = jnp.asarray(rng.uniform(0.1, 2.0, n))
    mesh = make_mesh(8)
    a1, j1, p1 = acc_jerk_pot_dense(pos, vel, mass, 1e-3)
    a2, j2, p2 = sharded_acc_jerk_pot(pos, vel, mass, mesh, 1e-3)
    np.testing.assert_allclose(np.asarray(a1), np.asarray(a2), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(j1), np.asarray(j2), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p2), rtol=1e-12)
    u1 = float(potential_energy(pos, mass, 1e-3))
    u2 = float(sharded_potential_energy(pos, mass, mesh, 1e-3))
    assert u1 == pytest.approx(u2, rel=1e-12)


def test_sharded_step_matches_single_device():
    """The full physics step under row sharding must equal the
    single-device result (cache off on both sides: the CPU single-device
    path has no cache, and the round-3 mesh cache changes hermite4 to
    P(EC) semantics — pinned separately below)."""
    cfg = SimConfig(n=64, rc=1.0, final_time=10.0, seed=13,
                    force_cache=False)
    state, aux, cfg = init_cluster(cfg)
    mesh = make_mesh(8)
    s_ref = run_steps(state, aux, cfg, 5)
    state_sharded = shard_state_rows(state, mesh)
    s_shd = run_steps(state_sharded, aux, cfg, 5, mesh=mesh)
    np.testing.assert_allclose(
        np.asarray(s_ref.cluster.pos), np.asarray(s_shd.cluster.pos),
        rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(s_ref.cluster.slr), np.asarray(s_shd.cluster.slr),
        rtol=1e-9, atol=1e-30)


def test_ensemble_sharded_run():
    """8 realizations across 8 devices: one launch, independent clusters."""
    cfg = SimConfig(n=32, rc=1.0, final_time=10.0, seed=100,
                    no_massive_star_requirement=True)
    bs, ba, cfgs = init_ensemble(cfg, 8)
    mesh = make_ensemble_mesh(8)
    bs, ba = shard_ensemble(bs, ba, mesh)
    out = ensemble_run_steps(bs, ba, cfg, 3)
    assert out.cluster.pos.shape == (8, 32, 3)
    # cross-check realization 2 against its single run
    s2, a2, _ = init_cluster(cfg.replace(seed=102))
    ref = run_steps(s2, a2, cfg, 3)
    np.testing.assert_allclose(
        np.asarray(out.cluster.pos[2]), np.asarray(ref.cluster.pos),
        rtol=1e-9, atol=1e-12)


def test_force_fn_hook_in_integrator():
    from al26.ops.integrators import hermite4_advance

    rng = np.random.default_rng(1)
    n = 64
    pos = jnp.asarray(rng.normal(size=(n, 3)))
    vel = jnp.asarray(rng.normal(size=(n, 3)) * 0.1)
    mass = jnp.asarray(rng.uniform(0.1, 1.0, n))
    mesh = make_mesh(8)
    ff = make_sharded_force(mesh, mass, 1e-3)
    p1, v1 = hermite4_advance(pos, vel, mass, jnp.asarray(0.01), eps2=1e-3)
    p2, v2 = hermite4_advance(pos, vel, mass, jnp.asarray(0.01), eps2=1e-3,
                              force_fn=ff)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p2), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), rtol=1e-10)


# slow lane (round-5 re-tier): mesh-driver equality variant (test_sharded_force_matches_dense and the rows equality stay default; dryrun axis 1 executes the driver path)
@pytest.mark.slow
def test_driver_with_mesh_matches_unsharded(tmp_path):
    """run(cfg) with mesh_shape=(8,) row-shards the whole checkpointed run
    and matches the single-device trajectory."""
    import os

    from al26.sim.driver import run

    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        # force_cache off for BOTH: the plain CPU run has no cache path,
        # and the round-3 meshed cache switches hermite4 to P(EC)
        # semantics — the cached-vs-uncached agreement is pinned
        # separately (test_mesh_cached_matches_uncached)
        base_cfg = SimConfig(n=64, rc=0.5, final_time=0.5, seed=17,
                             n_plot=2, steps_per_plot=5, force_cache=False)
        r1 = run(base_cfg.replace(filename="plain"), progress=False)
        r2 = run(base_cfg.replace(filename="meshed", mesh_shape=(8,)),
                 progress=False)
        np.testing.assert_allclose(
            np.asarray(r1.state.cluster.pos),
            np.asarray(r2.state.cluster.pos), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(
            np.asarray(r1.state.cluster.slr),
            np.asarray(r2.state.cluster.slr), rtol=1e-9, atol=1e-30)
    finally:
        os.chdir(cwd)


def test_driver_mesh_divisibility_error(tmp_path):
    import os

    from al26.sim.driver import run

    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        cfg = SimConfig(n=30, rc=0.5, final_time=0.5, seed=1,
                        mesh_shape=(8,), n_plot=2, steps_per_plot=5,
                        no_massive_star_requirement=True)
        with pytest.raises(ValueError, match="must divide"):
            run(cfg, progress=False)
    finally:
        os.chdir(cwd)


@pytest.mark.slow
def test_ring_force_matches_allgather():
    """The ppermute ring-streamed force equals the all-gather sharded force
    and the dense reference on the 8-device mesh."""
    from al26.parallel.ring import make_ring_force, ring_acc_jerk_pot

    rng = np.random.default_rng(8)
    n = 256
    pos = jnp.asarray(rng.normal(size=(n, 3)))
    vel = jnp.asarray(rng.normal(size=(n, 3)))
    mass = jnp.asarray(rng.uniform(0.1, 2.0, n))
    mesh = make_mesh(8)
    a1, j1, p1 = sharded_acc_jerk_pot(pos, vel, mass, mesh, 1e-3)
    a2, j2, p2 = ring_acc_jerk_pot(pos, vel, mass, mesh, 1e-3)
    np.testing.assert_allclose(np.asarray(a2), np.asarray(a1), rtol=1e-11)
    np.testing.assert_allclose(np.asarray(j2), np.asarray(j1), rtol=1e-11)
    np.testing.assert_allclose(np.asarray(p2), np.asarray(p1), rtol=1e-11)
    a3, j3, p3 = acc_jerk_pot_dense(pos, vel, mass, 1e-3)
    np.testing.assert_allclose(np.asarray(a2), np.asarray(a3), rtol=1e-10)
    # integrator hook
    from al26.ops.integrators import hermite4_advance

    ff = make_ring_force(mesh, mass, 1e-3)
    p_a, v_a = hermite4_advance(pos, vel, mass, jnp.asarray(0.01), eps2=1e-3)
    p_b, v_b = hermite4_advance(pos, vel, mass, jnp.asarray(0.01), eps2=1e-3,
                                force_fn=ff)
    np.testing.assert_allclose(np.asarray(p_b), np.asarray(p_a), rtol=1e-9)


# slow lane (round-5 re-tier): ring variant of a default-tested path (the sharded step equality stays default; dryrun covers ring)
@pytest.mark.slow
def test_step_with_ring_force_matches():
    # cache off for like-for-like (the CPU single-device side cannot
    # cache; the ring cache is pinned separately below)
    cfg = SimConfig(n=64, rc=1.0, final_time=10.0, seed=13,
                    force_cache=False)
    state, aux, cfg = init_cluster(cfg)
    mesh = make_mesh(8)
    s_ref = run_steps(state, aux, cfg, 3)
    from al26.parallel.sharded import shard_state_rows

    state_sharded = shard_state_rows(state, mesh)
    s_ring = run_steps(state_sharded, aux, cfg, 3, mesh=mesh,
                       force_impl="ring")
    np.testing.assert_allclose(
        np.asarray(s_ring.cluster.pos), np.asarray(s_ref.cluster.pos),
        rtol=1e-9, atol=1e-12)


def test_ensemble_flat_matches_vmapped():
    """The flattened block-diagonal ensemble step produces trajectories and
    deposition equal to the vmapped per-realization step over a short
    horizon (same physics, different substep sharing/summation order)."""
    from al26.parallel.ensemble import ensemble_run_steps

    cfg = SimConfig(n=32, rc=1.0, final_time=10.0, seed=100,
                    integrator="leapfrog", leapfrog_n_sub=4,
                    no_massive_star_requirement=True)
    bs, ba, cfgs = init_ensemble(cfg, 4)
    out_v = ensemble_run_steps(bs, ba, cfgs[0], 5, flat=False)
    out_f = ensemble_run_steps(bs, ba, cfgs[0], 5, flat=True)
    np.testing.assert_allclose(np.asarray(out_f.cluster.pos),
                               np.asarray(out_v.cluster.pos),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(out_f.cluster.slr),
                               np.asarray(out_v.cluster.slr),
                               rtol=1e-6, atol=1e-30)


def test_ensemble_flat_no_cross_talk():
    """Block-diagonal masking: realizations must not feel each other's
    gravity — a realization's trajectory is identical whether it runs alone
    or flattened with others."""
    from al26.parallel.ensemble import ensemble_run_steps

    cfg = SimConfig(n=32, rc=1.0, final_time=10.0, seed=200,
                    integrator="leapfrog", leapfrog_n_sub=4,
                    no_massive_star_requirement=True)
    bs, ba, cfgs = init_ensemble(cfg, 3)
    out = ensemble_run_steps(bs, ba, cfgs[0], 5, flat=True)
    s1, a1, c1 = init_cluster(cfg.replace(seed=201))
    ref = run_steps(s1, a1, c1.replace(integrator="leapfrog",
                                       leapfrog_n_sub=4), 5)
    np.testing.assert_allclose(np.asarray(out.cluster.pos[1]),
                               np.asarray(ref.cluster.pos),
                               rtol=1e-8, atol=1e-10)


def test_ensemble_flat_block_integrator_isolated():
    """Flat + hermite4_block (the kernel path): realizations stay
    gravitationally isolated and close to vmapped hermite4 trajectories."""
    from al26.parallel.ensemble import ensemble_run_steps

    cfg = SimConfig(n=32, rc=1.0, final_time=10.0, seed=300, k_fast=8,
                    integrator="hermite4_block",
                    no_massive_star_requirement=True)
    bs, ba, cfgs = init_ensemble(cfg, 3)
    out = ensemble_run_steps(bs, ba, cfgs[0], 5, flat=True)
    # against the single-realization hermite4_block run
    s1, a1, c1 = init_cluster(cfg.replace(seed=301))
    ref = run_steps(s1, a1, c1, 5)
    np.testing.assert_allclose(np.asarray(out.cluster.pos[1]),
                               np.asarray(ref.cluster.pos),
                               rtol=1e-4, atol=1e-7)


@pytest.mark.slow  # mesh variant of the single-chip trajectory runs
# (tests/test_io.py::test_interloper_trajectory_file)
def test_traj_run_carries_mesh():
    """run_steps_traj with a mesh (review regression: the trajectory path
    silently dropped the sharded force) matches run_steps."""
    from al26.sim import run_steps_traj
    from al26.parallel.sharded import shard_state_rows

    cfg = SimConfig(n=64, rc=0.5, final_time=2.0, seed=5, interloper=True,
                    interloper_mass=3.0, interloper_velocity=20.0,
                    interloper_radius=0.05,
                    no_massive_star_requirement=True)
    state, aux, cfg = init_cluster(cfg)
    # n_total = 65 (interloper): not divisible by 8 -> use 5-device mesh
    mesh = make_mesh(5)
    s_ref, rows_ref = run_steps_traj(state, aux, cfg, 4)
    state_sh = shard_state_rows(state, mesh)
    s_mesh, rows_mesh = run_steps_traj(state_sh, aux, cfg, 4, mesh=mesh)
    np.testing.assert_allclose(np.asarray(s_mesh.cluster.pos),
                               np.asarray(s_ref.cluster.pos),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(rows_mesh), np.asarray(rows_ref),
                               rtol=1e-9, atol=1e-12)


def test_ensemble_auto_resolves_to_leapfrog_at_boundary():
    """integrator="auto" must resolve at the ENSEMBLE boundary to the
    BHTree-parity leapfrog for every realization (per-realization init
    would pick hermite4 at n <= 8192, which collapses on flattened evolved
    ensembles), with one shared substep count recorded in every
    realization's config (what run_ensemble actually steps with)."""
    cfg = SimConfig(n=32, rc=1.0, final_time=10.0, seed=2, dtype="f32",
                    no_massive_star_requirement=True)
    assert cfg.integrator == "auto"
    _, _, cfgs = init_ensemble(cfg, 3)
    assert all(c.integrator == "leapfrog" for c in cfgs)
    n_subs = {c.leapfrog_n_sub for c in cfgs}
    assert len(n_subs) == 1 and n_subs.pop() >= 1
    # an explicit integrator choice is NOT overridden
    cfg_h = cfg.replace(integrator="hermite4")
    _, _, cfgs_h = init_ensemble(cfg_h, 2)
    assert all(c.integrator == "hermite4" for c in cfgs_h)


def test_ensemble_resume_roundtrip(tmp_path):
    """Ensemble reload: every pt-<k> realization resumes from its own
    checkpoint and continues to the SAME final state as the uninterrupted
    run (reference resume semantics, al26_nbody.py:1647-1656, extended
    across the ensemble axis)."""
    import os

    import numpy as np

    from al26.sim.driver import run_ensemble

    cfg = SimConfig(n=24, rc=0.5, final_time=0.5, seed=77, ensemble=2,
                    n_plot=2, steps_per_plot=5,
                    no_massive_star_requirement=True)
    full, sim_dirs, _ = run_ensemble(cfg, progress=False,
                                     root=str(tmp_path))
    # resume each realization from checkpoint #1 (t = 1 step) and re-run
    cfg_r = cfg.replace(reload=os.path.join(str(tmp_path), "pt-0.5-24"),
                        n_checkpoint=1)
    resumed, sim_dirs_r, _ = run_ensemble(cfg_r, progress=False)
    assert [os.path.normpath(d) for d in sim_dirs_r] == [
        os.path.normpath(d) for d in sim_dirs]
    assert float(resumed.time[0]) == cfg.final_time
    np.testing.assert_array_equal(np.asarray(resumed.cluster.pos),
                                  np.asarray(full.cluster.pos))
    np.testing.assert_array_equal(np.asarray(resumed.cluster.slr),
                                  np.asarray(full.cluster.slr))


@pytest.mark.slow  # faster sibling: test_io.py::test_resume_extends_final_time
def test_ensemble_resume_extends_final_time(tmp_path):
    """`--ensemble -r X -t_f T`: the whole grid extends on the original
    step grid (SimConfig.extended_to) and bit-matches an uninterrupted
    ensemble on the same grid; every realization's stored args carry the
    extended schedule for the next resume."""
    import os

    import numpy as np

    from al26.sim.driver import run_ensemble

    cfg = SimConfig(n=24, rc=0.5, final_time=0.5, seed=77, ensemble=2,
                    n_plot=2, steps_per_plot=5,
                    no_massive_star_requirement=True)
    run_ensemble(cfg, progress=False, root=str(tmp_path / "short"))
    full, _, _ = run_ensemble(cfg.replace(final_time=1.0, n_plot=4),
                              progress=False, root=str(tmp_path / "long"))
    cfg_r = cfg.replace(reload=str(tmp_path / "short" / "pt-0.5-24"),
                        extend_final_time=0.96)  # snaps to 1.0
    resumed, dirs_r, _ = run_ensemble(cfg_r, progress=False)
    assert float(resumed.time[0]) == pytest.approx(1.0)
    np.testing.assert_array_equal(np.asarray(resumed.cluster.pos),
                                  np.asarray(full.cluster.pos))
    np.testing.assert_array_equal(np.asarray(resumed.cluster.slr),
                                  np.asarray(full.cluster.slr))
    # next plain resume continues the EXTENDED schedule
    again, _, _ = run_ensemble(cfg.replace(
        reload=str(tmp_path / "short" / "pt-0.5-24")), progress=False)
    assert float(again.time[0]) == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# Round-3 mesh-path parity with the single-chip cache machinery
# (VERDICT r2 weak item 3 / next-round item 4)
# ---------------------------------------------------------------------------
@pytest.mark.slow
def test_mesh_cached_one_sweep_per_step(monkeypatch):
    """The sharded step runs NO sweep beyond the integrator's own: the
    virial potential rides the fused force sweep (no
    sharded_potential_energy pass), and the opening evaluation comes from
    the cache — counted by tracing run_steps with instrumented per-shard
    sweeps (everything funnels through parallel.sharded)."""
    import al26.parallel.sharded as shd
    from al26.sim.step import _cacheable

    counter = {"n": 0}
    pots = {"n": 0}
    real = shd._local_rows_force
    real_pot = shd.sharded_potential_energy

    def counting(*a, **kw):
        counter["n"] += 1
        return real(*a, **kw)

    def counting_pot(*a, **kw):
        pots["n"] += 1
        return real_pot(*a, **kw)

    monkeypatch.setattr(shd, "_local_rows_force", counting)
    monkeypatch.setattr(shd, "sharded_potential_energy", counting_pot)

    from al26.sim.step import _step_impl, fresh_cache

    cfg = SimConfig(n=64, rc=1.0, final_time=10.0, seed=23021,
                    integrator="hermite4_block", k_fast=16)
    state, aux, cfg = init_cluster(cfg)
    mesh = make_mesh(8)
    assert _cacheable(cfg, 64, state.cluster.pos.dtype, mesh, "auto")
    state = shard_state_rows(state, mesh)
    cache = fresh_cache(state, cfg, "hermite4_block", mesh)
    counter["n"] = 0
    # one EAGER step with the cache: the only full-row sweep is the
    # closing evaluation (the subcycle's K x N row work goes through the
    # column-sharded rows fn, counted as zero here) and the virial
    # potential rides it — no sharded_potential_energy pass
    _step_impl(state, aux, cfg, mesh, "auto", cache)
    assert counter["n"] == 1, counter["n"]
    assert pots["n"] == 0, "virial potential must ride the fused sweep"

    counter["n"] = 0
    _step_impl(state, aux, cfg.replace(force_cache=False), mesh, "auto",
               None, want_cache=False)
    # uncached: opening + closing full sweeps (the round-2 single-chip
    # economics, now on the mesh; previously this path ALSO paid a
    # separate potential sweep)
    assert counter["n"] == 2, counter["n"]
    assert pots["n"] == 0


def test_mesh_cached_matches_uncached():
    """Meshed cached (P(EC)) vs meshed uncached trajectories agree at the
    force-cache tolerance established on the single-chip path
    (test_force_cache.py)."""
    cfg = SimConfig(n=64, rc=1.0, final_time=10.0, seed=29)
    state, aux, cfg = init_cluster(cfg)
    mesh = make_mesh(8)
    state = shard_state_rows(state, mesh)
    s_cached = run_steps(state, aux, cfg, 50, mesh=mesh)
    s_plain = run_steps(state, aux, cfg.replace(force_cache=False), 50,
                        mesh=mesh)
    np.testing.assert_allclose(
        np.asarray(s_cached.cluster.pos), np.asarray(s_plain.cluster.pos),
        rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(
        np.asarray(s_cached.cluster.slr), np.asarray(s_plain.cluster.slr),
        rtol=2e-3, atol=1e-30)


def test_sharded_force_rows_matches_dense():
    """make_sharded_force_rows (replicated rows x sharded columns + psum)
    equals the dense row-subset force."""
    from al26.ops.nbody import _row_block_acc_jerk_pot
    from al26.parallel.sharded import make_sharded_force_rows

    rng = np.random.default_rng(5)
    n, k = 64, 8
    pos = jnp.asarray(rng.normal(size=(n, 3)))
    vel = jnp.asarray(rng.normal(size=(n, 3)))
    mass = jnp.asarray(rng.uniform(0.1, 2.0, size=n))
    ids = jnp.asarray(rng.choice(n, size=k, replace=False).astype(np.int32))
    pr, vr = pos[ids], vel[ids]
    mesh = make_mesh(8)
    fn = make_sharded_force_rows(mesh, mass, eps2=0.0)
    a_s, j_s = fn(pr, vr, ids, pos, vel)
    from al26.units import G_INTERNAL

    a_d, j_d, _ = _row_block_acc_jerk_pot(pr, vr, pos, vel, mass, 0.0,
                                          G_INTERNAL, ids)
    np.testing.assert_allclose(np.asarray(a_s), np.asarray(a_d),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(j_s), np.asarray(j_d),
                               rtol=1e-10, atol=1e-12)


def test_mesh_block_integrator_uses_sharded_rows(monkeypatch):
    """hermite4_block under a mesh routes its subcycle through the
    column-sharded rows function (no dense fallback), and matches the
    unsharded block integrator."""
    import al26.parallel.sharded as shd

    made = {"n": 0}
    real = shd.make_sharded_force_rows

    def counting(*a, **kw):
        made["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(shd, "make_sharded_force_rows", counting)

    cfg = SimConfig(n=64, rc=1.0, final_time=10.0, seed=31,
                    integrator="hermite4_block", k_fast=16,
                    force_cache=False)
    state, aux, cfg = init_cluster(cfg)
    mesh = make_mesh(8)
    s_ref = run_steps(state, aux, cfg, 5)
    s_shd = run_steps(shard_state_rows(state, mesh), aux, cfg, 5, mesh=mesh)
    assert made["n"] > 0
    np.testing.assert_allclose(
        np.asarray(s_ref.cluster.pos), np.asarray(s_shd.cluster.pos),
        rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(s_ref.cluster.slr), np.asarray(s_shd.cluster.slr),
        rtol=1e-9, atol=1e-30)


def test_ring_cached_matches_sharded_cached():
    """Round 3: the ring backend joins the fused/cached family — ONE
    ppermute-streamed sweep per step carrying the cross-step cache; it
    must track the all-gather sharded cached path to summation-order
    round-off, with no separate potential sweep."""
    import al26.parallel.sharded as shd
    from al26.sim.step import _cacheable

    cfg = SimConfig(n=64, rc=1.0, final_time=10.0, seed=37)
    state, aux, cfg = init_cluster(cfg)
    mesh = make_mesh(8)
    assert _cacheable(cfg, 64, state.cluster.pos.dtype, mesh, "ring")
    state = shard_state_rows(state, mesh)
    s_ring = run_steps(state, aux, cfg, 10, mesh=mesh, force_impl="ring")
    s_shd = run_steps(state, aux, cfg, 10, mesh=mesh, force_impl="sharded")
    np.testing.assert_allclose(
        np.asarray(s_ring.cluster.pos), np.asarray(s_shd.cluster.pos),
        rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(s_ring.cluster.slr), np.asarray(s_shd.cluster.slr),
        rtol=1e-9, atol=1e-30)


@pytest.mark.slow
def test_ring_one_sweep_per_step(monkeypatch):
    """Eager per-step accounting for the ring path, mirroring
    test_mesh_cached_one_sweep_per_step."""
    import al26.parallel.ring as ring
    import al26.parallel.sharded as shd
    from al26.sim.step import _step_impl, fresh_cache

    sweeps = {"n": 0}
    pots = {"n": 0}
    real = ring.ring_acc_jerk_pot
    real_pot = shd.sharded_potential_energy

    def counting(*a, **kw):
        sweeps["n"] += 1
        return real(*a, **kw)

    def counting_pot(*a, **kw):
        pots["n"] += 1
        return real_pot(*a, **kw)

    monkeypatch.setattr(ring, "ring_acc_jerk_pot", counting)
    monkeypatch.setattr(shd, "sharded_potential_energy", counting_pot)

    cfg = SimConfig(n=64, rc=1.0, final_time=10.0, seed=41,
                    integrator="hermite4_block", k_fast=16)
    state, aux, cfg = init_cluster(cfg)
    mesh = make_mesh(8)
    state = shard_state_rows(state, mesh)
    cache = fresh_cache(state, cfg, "hermite4_block", mesh, "ring")
    sweeps["n"] = 0
    _step_impl(state, aux, cfg, mesh, "ring", cache)
    assert sweeps["n"] == 1, sweeps["n"]   # the closing evaluation only
    assert pots["n"] == 0


def test_ensemble_explicit_leapfrog_shares_n_sub():
    """EXPLICIT integrator='leapfrog' with leapfrog_n_sub unset must also
    get the shared ensemble-boundary substep resolution: per-realization
    resolution derives n_sub from each realization's IMF-drawn total mass,
    so realizations straddling a power-of-2 boundary would record configs
    that differ from the one that stepped them (cfgs[0]) and
    load_ensemble would refuse the resume (round-3 review finding)."""
    cfg = SimConfig(n=32, rc=1.0, final_time=10.0, seed=2, dtype="f32",
                    integrator="leapfrog",
                    no_massive_star_requirement=True)
    assert cfg.leapfrog_n_sub is None
    _, _, cfgs = init_ensemble(cfg, 3)
    n_subs = {c.leapfrog_n_sub for c in cfgs}
    assert len(n_subs) == 1 and n_subs.pop() >= 1
    # an explicit n_sub is NOT overridden
    _, _, cfgs2 = init_ensemble(cfg.replace(leapfrog_n_sub=4), 2)
    assert all(c.leapfrog_n_sub == 4 for c in cfgs2)


def test_ensemble_force_cache_flag_honored(monkeypatch):
    """force_cache=False (the documented opt-out) must disable the flat
    ensemble's cache gate exactly like sim.step._cacheable does for
    single runs (round-3 review finding)."""
    import al26.ops.backend as pk
    from al26.parallel.ensemble import ensemble_cacheable

    monkeypatch.setattr(pk, "kernel_here", lambda n, dtype: True)
    cfg = SimConfig(n=24, rc=1.0, final_time=1.0, seed=5, dtype="f32",
                    integrator="leapfrog", leapfrog_n_sub=2,
                    no_massive_star_requirement=True)
    bs, _, cfgs = init_ensemble(cfg, 2)
    assert ensemble_cacheable(bs, cfgs[0])
    assert not ensemble_cacheable(bs, cfgs[0].replace(force_cache=False))


def test_ensemble_cache_threads_across_chunks(monkeypatch):
    """ensemble_run_steps_cached threaded over two chunks == one chunk of
    the total length (the driver's checkpoint-boundary threading; without
    it every chunk re-paid a fresh opening sweep)."""
    import numpy as np

    import al26.ops.backend as pk
    from al26.parallel.ensemble import (
        ensemble_fresh_cache, ensemble_run_steps_cached,
    )

    monkeypatch.setattr(pk, "kernel_here", lambda n, dtype: True)
    cfg = SimConfig(n=24, rc=1.0, final_time=1.0, seed=12, dtype="f32",
                    star_max_mass=3.0, no_massive_star_requirement=True)
    bs, ba, cfgs = init_ensemble(cfg, 2)
    cfg = cfgs[0]
    cache = ensemble_fresh_cache(bs, cfg)
    s1, cache = ensemble_run_steps_cached(bs, cache, ba, cfg, 2)
    s1, cache = ensemble_run_steps_cached(s1, cache, ba, cfg, 2)
    cache0 = ensemble_fresh_cache(bs, cfg)
    s2, _ = ensemble_run_steps_cached(bs, cache0, ba, cfg, 4)
    np.testing.assert_array_equal(np.asarray(s1.cluster.pos),
                                  np.asarray(s2.cluster.pos))
    np.testing.assert_array_equal(np.asarray(s1.cluster.slr),
                                  np.asarray(s2.cluster.slr))


# ---------------------------------------------------------------------------
# 2-D (ensemble x rows) mesh: the composition of the two production axes
# (SURVEY.md §2c items 1+4) for ensembles with fewer members than chips
# ---------------------------------------------------------------------------
@pytest.mark.slow  # slow sibling: driver-parity vs the 1-D run covers the 2-D step in the default set
def test_ensemble_2d_matches_unsharded():
    """A 2x4 (ens x rows) mesh run equals the unsharded vmapped ensemble:
    each realization's row-sharded sweep (all_gather over ROWS_AXIS only)
    reproduces the dense per-realization forces, and realizations never
    mix across the ens axis."""
    from al26.parallel.ensemble import (
        ensemble_run_steps, ensemble_run_steps_2d, make_ensemble2d_mesh,
        shard_ensemble_2d,
    )

    cfg = SimConfig(n=64, rc=1.0, final_time=10.0, seed=5)
    bs, ba, cfgs = init_ensemble(cfg, 4)
    cfg = cfgs[0]
    mesh = make_ensemble2d_mesh(2, 4)
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == {
        "ens": 2, "rows": 4}
    bs2, ba2 = shard_ensemble_2d(bs, ba, mesh)
    out2 = ensemble_run_steps_2d(bs2, ba2, cfg, 5, mesh)
    ref = ensemble_run_steps(bs, ba, cfg, 5, flat=False)
    np.testing.assert_allclose(np.asarray(out2.cluster.pos),
                               np.asarray(ref.cluster.pos),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(np.asarray(out2.cluster.slr),
                               np.asarray(ref.cluster.slr),
                               rtol=1e-10, atol=1e-30)


def test_ensemble_2d_rejects_non_leapfrog():
    from al26.parallel.ensemble import (
        ensemble_step_2d, make_ensemble2d_mesh, shard_ensemble_2d,
    )

    cfg = SimConfig(n=32, rc=1.0, final_time=10.0, seed=6,
                    integrator="hermite4",
                    no_massive_star_requirement=True)
    bs, ba, cfgs = init_ensemble(cfg, 2)
    mesh = make_ensemble2d_mesh(2, 4)
    bs, ba = shard_ensemble_2d(bs, ba, mesh)
    with pytest.raises(ValueError, match="leapfrog"):
        ensemble_step_2d(bs, ba, cfgs[0], mesh)


# slow lane (round-5 re-tier): 2-D-ensemble driver equality (dryrun axis 1x2 compiles+executes it; 1-D ensemble equalities stay default)
@pytest.mark.slow
def test_driver_ensemble_2d_matches_1d(tmp_path):
    """run_ensemble with mesh_shape=(2, 4) (ens x rows) writes the same
    grid-folder checkpoints and reaches the same final state as the
    default ensemble-sharded run (leapfrog physics is identical; only the
    force summation layout differs)."""
    import os

    from al26.sim.driver import run_ensemble

    cfg = SimConfig(n=24, rc=0.5, final_time=0.5, seed=88, ensemble=2,
                    n_plot=2, steps_per_plot=5,
                    no_massive_star_requirement=True)
    ref, sim_dirs, _ = run_ensemble(cfg, progress=False,
                                    root=str(tmp_path / "a"))
    out, sim_dirs2, _ = run_ensemble(cfg.replace(mesh_shape=(2, 4)),
                                     progress=False,
                                     root=str(tmp_path / "b"))
    assert len(sim_dirs2) == 2
    assert os.path.exists(os.path.join(sim_dirs2[0],
                                       "pt-0-cluster-yields.csv"))
    np.testing.assert_allclose(np.asarray(out.cluster.pos),
                               np.asarray(ref.cluster.pos),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(out.cluster.slr),
                               np.asarray(ref.cluster.slr),
                               rtol=1e-8, atol=1e-30)


def test_driver_ensemble_2d_shape_errors(tmp_path):
    from al26.sim.driver import run_ensemble

    cfg = SimConfig(n=24, rc=0.5, final_time=0.5, seed=88, ensemble=3,
                    n_plot=1, steps_per_plot=5, mesh_shape=(2, 4),
                    no_massive_star_requirement=True)
    with pytest.raises(ValueError, match="divide"):
        run_ensemble(cfg, progress=False, root=str(tmp_path))
    # an explicit 1-D mesh_shape with an ensemble must not be silently
    # ignored
    with pytest.raises(ValueError, match="2-tuple"):
        run_ensemble(cfg.replace(ensemble=2, mesh_shape=(8,)),
                     progress=False, root=str(tmp_path))


@pytest.mark.slow  # slow sibling: the default driver-parity test runs the cached production path
def test_ensemble_2d_cached_matches_uncached():
    """The 2-D path's force cache is EXACT for leapfrog (closing eval at
    the final positions + mass-delta correction), so cached and uncached
    runs agree to summation-order tolerance; threading the cache across
    two chunks equals one chunk of the total length (the driver's
    checkpoint-boundary threading)."""
    from al26.parallel.ensemble import (
        ensemble2d_fresh_cache, ensemble_run_steps_2d,
        ensemble_run_steps_2d_cached, make_ensemble2d_mesh,
        shard_ensemble_2d,
    )

    cfg = SimConfig(n=64, rc=1.0, final_time=10.0, seed=5)
    bs, ba, cfgs = init_ensemble(cfg, 4)
    cfg = cfgs[0]
    mesh = make_ensemble2d_mesh(2, 4)
    bs, ba = shard_ensemble_2d(bs, ba, mesh)
    ref = ensemble_run_steps_2d(bs, ba, cfg, 4, mesh)
    cache = ensemble2d_fresh_cache(bs, cfg, mesh)
    s1, cache1 = ensemble_run_steps_2d_cached(bs, cache, ba, cfg, 2, mesh)
    s1, _ = ensemble_run_steps_2d_cached(s1, cache1, ba, cfg, 2, mesh)
    np.testing.assert_allclose(np.asarray(s1.cluster.pos),
                               np.asarray(ref.cluster.pos),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(np.asarray(s1.cluster.slr),
                               np.asarray(ref.cluster.slr),
                               rtol=1e-10, atol=1e-30)
    cache0 = ensemble2d_fresh_cache(bs, cfg, mesh)
    s2, _ = ensemble_run_steps_2d_cached(bs, cache0, ba, cfg, 4, mesh)
    np.testing.assert_array_equal(np.asarray(s1.cluster.pos),
                                  np.asarray(s2.cluster.pos))
    np.testing.assert_array_equal(np.asarray(s1.cluster.slr),
                                  np.asarray(s2.cluster.slr))


@pytest.mark.slow  # slow sibling: 1-D ensemble resume + 2-D driver parity stay in the default set
def test_driver_ensemble_2d_resume(tmp_path):
    """2-D-mesh ensemble resume: each realization continues from its own
    checkpoint to the uninterrupted final state. Tolerance note: the
    cached 2-D path re-seeds a FRESH opening sweep on resume while the
    uninterrupted run carries the mass-delta-corrected closing eval —
    mathematically identical (force linearity in source masses) but a
    different summation order, so agreement is to ~ulp, not bitwise."""
    import os

    from al26.sim.driver import run_ensemble

    cfg = SimConfig(n=24, rc=0.5, final_time=0.5, seed=77, ensemble=2,
                    n_plot=2, steps_per_plot=5, mesh_shape=(2, 4))
    full, sim_dirs, _ = run_ensemble(cfg, progress=False,
                                     root=str(tmp_path))
    cfg_r = cfg.replace(reload=os.path.join(str(tmp_path), "pt-0.5-24"),
                        n_checkpoint=1)
    resumed, _, _ = run_ensemble(cfg_r, progress=False)
    assert float(resumed.time[0]) == cfg.final_time
    np.testing.assert_allclose(np.asarray(resumed.cluster.pos),
                               np.asarray(full.cluster.pos),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(np.asarray(resumed.cluster.slr),
                               np.asarray(full.cluster.slr),
                               rtol=1e-10, atol=1e-30)


# slow lane (round-5 re-tier): 2-D-mesh interloper variant (test_driver_ensemble_2d_matches_1d keeps the 2-D path default; 1-D interloper runs stay default)
@pytest.mark.slow
def test_driver_ensemble_2d_interloper_star_count(tmp_path):
    """With --interloper the per-realization star count is cfg.n + 1; the
    2-D rows axis must shard THAT (a cfg.n-based divisibility gate would
    wrongly reject n=31 / accept n=32 and then crash in shard_map)."""
    from al26.sim.driver import run_ensemble

    cfg = SimConfig(n=31, rc=0.5, final_time=0.5, seed=21, ensemble=2,
                    n_plot=1, steps_per_plot=5, interloper=True,
                    interloper_mass=5.0, interloper_velocity=20.0,
                    interloper_radius=0.05, interloper_distance=0.2,
                    no_massive_star_requirement=True)
    ref, _, _ = run_ensemble(cfg, progress=False,
                             root=str(tmp_path / "a"))
    out, _, _ = run_ensemble(cfg.replace(mesh_shape=(2, 4)),
                             progress=False, root=str(tmp_path / "b"))
    assert out.cluster.pos.shape == (2, 32, 3)
    np.testing.assert_allclose(np.asarray(out.cluster.pos),
                               np.asarray(ref.cluster.pos),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(out.cluster.agb_raw),
                               np.asarray(ref.cluster.agb_raw),
                               rtol=1e-8, atol=1e-30)


@pytest.mark.slow  # design-point scale (N=256 x 4-way rows, ~30 s on CPU);
# faster 2-D siblings in the default set: matches_unsharded (N=64),
# cached_matches (driver parity), interloper star-count
def test_ensemble_2d_design_point_one_fused_sweep_per_step(monkeypatch):
    """The 2-D (ens x rows) mesh at its DESIGN POINT — few members x
    large-N-per-member (VERDICT r3 weak #5): 2 realizations of N=256
    row-sharded 4 ways, with the production cache engaged. Counted by
    tracing the scanned cached path with an instrumented fused sweep:

      * cached step: exactly ONE fused (acc+pot) row-sharded sweep — the
        closing evaluation; the opening one comes from the cache and the
        virial potential rides the same fused pass (no separate
        potential sweep exists on this path at all);
      * uncached step with want_cache: exactly TWO (opening + closing);
      * the leapfrog's interior substeps use acc-only sweeps (no
        potential recovery paid per substep).

    Physics at the design point matches the dense vmapped ensemble."""
    import al26.parallel.ensemble as ens

    cfg = SimConfig(n=256, rc=1.0, final_time=10.0, seed=9)
    bs, ba, cfgs = init_ensemble(cfg, 2)
    cfg = cfgs[0]
    mesh = ens.make_ensemble2d_mesh(2, 4)
    bs2, ba2 = ens.shard_ensemble_2d(bs, ba, mesh)

    counts = {"fused": 0, "acc_only": 0}
    real = ens.ensemble2d_acc_pot

    def counting(pos, vel, mass, mesh_, eps2, pot_eps2=None,
                 with_pot=True):
        counts["fused" if with_pot else "acc_only"] += 1
        return real(pos, vel, mass, mesh_, eps2, pot_eps2=pot_eps2,
                    with_pot=with_pot)

    monkeypatch.setattr(ens, "ensemble2d_acc_pot", counting)

    # cached scan: body traced once -> per-step trace counts
    cache = ens.ensemble2d_fresh_cache(bs2, cfg, mesh)
    counts.update(fused=0, acc_only=0)
    out, _ = ens.ensemble_run_steps_2d_cached(bs2, cache, ba2, cfg, 2,
                                              mesh)
    assert counts["fused"] == 1, counts
    assert counts["acc_only"] >= 1
    n_sub = cfg.leapfrog_n_sub
    assert counts["acc_only"] <= n_sub

    # uncached step with want_cache: opening + closing fused sweeps
    counts.update(fused=0, acc_only=0)
    ens.ensemble_step_2d(bs2, ba2, cfg, mesh, cache=None, want_cache=True)
    assert counts["fused"] == 2, counts

    # the design point's physics equals the dense vmapped ensemble
    ref = ensemble_run_steps(bs, ba, cfg, 2, flat=False)
    np.testing.assert_allclose(np.asarray(out.cluster.pos),
                               np.asarray(ref.cluster.pos),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(np.asarray(out.cluster.slr),
                               np.asarray(ref.cluster.slr),
                               rtol=1e-10, atol=1e-30)
    # the rows axis genuinely shards the star axis at this size
    shard_shape = next(iter(
        out.cluster.pos.addressable_shards)).data.shape
    assert shard_shape[1] == 256 // 4


def test_run_ensemble_rejects_perf_ladder_flags(tmp_path):
    """The opt-in perf ladder is a single-run capability; an explicit
    opt-in must raise instead of being silently dropped (ADVICE r3)."""
    from al26.sim.driver import run_ensemble

    cfg = SimConfig(n=24, rc=0.5, final_time=0.5, seed=1, ensemble=2,
                    n_plot=1, steps_per_plot=5,
                    no_massive_star_requirement=True)
    for kw in ({"gravity_stride": 2}, {"softened_virial": True},
               {"k_ultra": 8}):
        with pytest.raises(ValueError, match="single runs only"):
            run_ensemble(cfg.replace(**kw), progress=False,
                         root=str(tmp_path))


def test_make_ensemble2d_mesh_validates_device_count():
    from al26.parallel.ensemble import make_ensemble2d_mesh

    with pytest.raises(ValueError, match="devices"):
        make_ensemble2d_mesh(4, 4)   # 16 > the fake mesh's 8


def test_make_ensemble2d_mesh_rejects_degenerate_rows():
    """n_rows defaults to len(devices) // n_ens: more realizations than
    devices must raise, not return an empty Mesh."""
    from al26.parallel.ensemble import make_ensemble2d_mesh

    with pytest.raises(ValueError, match="degenerate"):
        make_ensemble2d_mesh(16)  # 8 fake devices -> n_rows = 0


def test_ensemble_flat_kernel_per_device_under_mesh(monkeypatch):
    """With the batch sharded over an ensemble mesh, the flat kernel path
    sweeps each device's own realizations (shard_map) and matches the
    unsharded run."""
    import numpy as np

    import al26.ops.backend as pk
    from al26.parallel.ensemble import (
        ensemble_fresh_cache, ensemble_run_steps_cached, make_ensemble_mesh,
        shard_ensemble,
    )

    monkeypatch.setattr(pk, "kernel_here", lambda n, dtype: True)
    cfg = SimConfig(n=24, rc=1.0, final_time=1.0, seed=21, dtype="f32",
                    star_max_mass=3.0, no_massive_star_requirement=True)
    bs, ba, cfgs = init_ensemble(cfg, 8)
    cfg = cfgs[0]
    s1, _ = ensemble_run_steps_cached(bs, ensemble_fresh_cache(bs, cfg), ba,
                                      cfg, 2)
    mesh = make_ensemble_mesh(8)
    bs8, ba8 = shard_ensemble(bs, ba, mesh)
    s8, _ = ensemble_run_steps_cached(
        bs8, ensemble_fresh_cache(bs8, cfg, mesh), ba8, cfg, 2, mesh)
    assert len(s8.cluster.pos.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(s8.cluster.pos),
                               np.asarray(s1.cluster.pos), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("integrator,force_cache", [
    ("leapfrog", False), ("hermite4", True), ("hermite4_block", False),
    ("leapfrog", True)])
def test_ensemble_run_steps_flat_kernel_per_device_under_mesh(
        monkeypatch, integrator, force_cache):
    """ensemble_run_steps (the driver's path when the cache is off or the
    integrator cannot carry it) sweeps each device's own realizations
    under shard_map too, and matches the unsharded run."""
    import al26.ops.backend as pk

    monkeypatch.setattr(pk, "kernel_here", lambda n, dtype: True)
    cfg = SimConfig(n=24, rc=1.0, final_time=1.0, seed=21, dtype="f32",
                    star_max_mass=3.0, no_massive_star_requirement=True,
                    integrator=integrator, force_cache=force_cache)
    bs, ba, cfgs = init_ensemble(cfg, 8)
    cfg = cfgs[0]
    s1 = ensemble_run_steps(bs, ba, cfg, 2, flat=True)
    mesh = make_ensemble_mesh(8)
    bs8, ba8 = shard_ensemble(bs, ba, mesh)
    jaxpr = str(ensemble_run_steps.trace(bs8, ba8, cfg, 2, flat=True,
                                         mesh=mesh).jaxpr)
    assert "shard_map" in jaxpr
    s8 = ensemble_run_steps(bs8, ba8, cfg, 2, flat=True, mesh=mesh)
    assert len(s8.cluster.pos.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(s8.cluster.pos),
                               np.asarray(s1.cluster.pos), rtol=0,
                               atol=1e-5)
