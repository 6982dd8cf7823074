"""End-to-end step tests: the jitted physics step and scan driver."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from al26.config import SimConfig
from al26.sim import init_cluster, run_steps, step
from al26.state import CH_AGB, CH_GLOBAL, CH_LOCAL, CH_SNE
from al26.ops.nbody import total_energy


@pytest.fixture(scope="module")
def small_sim():
    cfg = SimConfig(n=128, rc=1.0, final_time=10.0, seed=7)
    state, aux, cfg = init_cluster(cfg)
    return state, aux, cfg


def test_init_invariants(small_sim):
    state, aux, cfg = small_sim
    c = state.cluster
    m = np.asarray(c.mass)
    assert c.n == cfg.n
    assert (np.asarray(c.m0) == m).all()
    assert np.asarray(c.mass_27al) == pytest.approx(8.5e-6 * m)
    assert np.asarray(c.mass_56fe) == pytest.approx(1.828e-4 * m)
    hm = m >= 13.0
    assert hm.any()  # the re-roll guarantees a massive star
    assert (np.asarray(c.wind_ratio)[hm] >= 0).all()
    assert (np.asarray(c.total_wind_loss)[hm] > 0).all()
    lm = (m >= 0.1) & (m <= 3.0)
    assert (np.asarray(c.disk_alive) == lm).all()
    # massive-star candidate slots cover exactly the m0 >= 13 set
    assert set(np.asarray(aux.hm_idx).tolist()) == set(np.flatnonzero(hm))


def test_step_advances_and_deposits(small_sim):
    state, aux, cfg = small_sim
    s = run_steps(state, aux, cfg, 20)
    assert float(s.time) == pytest.approx(20 * cfg.dt)
    c = s.cluster
    # wind deposition accumulated onto disc-bearing stars only
    glob = np.asarray(c.slr[:, :, CH_GLOBAL])
    lm = np.asarray(c.low_mass_mask())
    assert glob[lm].sum() > 0
    assert glob[~lm].sum() == 0
    # local model deposits less than or equal within fewer pairs
    assert np.asarray(c.slr[:, :, CH_LOCAL]).sum() >= 0
    # positions moved
    assert not np.allclose(np.asarray(c.pos), np.asarray(state.cluster.pos))


def test_energy_conservation_through_step():
    """With no massive stars the masses are constant, so the full physics
    step must conserve the (softened) total energy to integrator accuracy.
    (Clusters WITH massive stars lose energy physically through winds.)"""
    cfg = SimConfig(n=96, rc=1.0, final_time=10.0, seed=9,
                    star_max_mass=3.0, no_massive_star_requirement=True)
    state, aux, cfg = init_cluster(cfg)
    eps2 = cfg.eps2
    c0 = state.cluster
    e0 = float(total_energy(c0.pos, c0.vel, c0.mass, eps2))
    s = run_steps(state, aux, cfg, 50)
    c1 = s.cluster
    e1 = float(total_energy(c1.pos, c1.vel, c1.mass, eps2))
    assert abs((e1 - e0) / abs(e0)) < 1e-5
    # masses untouched
    np.testing.assert_array_equal(np.asarray(c1.mass), np.asarray(c0.mass))


def test_supernova_fires_once():
    """A 60 Msun star (lifetime ~3.9 Myr) must explode exactly once within
    a 6 Myr run and inject into the SNE channel."""
    cfg = SimConfig(n=64, rc=0.5, final_time=6.0, seed=3,
                    star_min_mass=0.1, star_max_mass=3.0,
                    no_massive_star_requirement=True)
    state, aux, cfg = init_cluster(cfg)
    # hand-place a massive star
    c = state.cluster
    m = np.asarray(c.mass).copy()
    m[0] = 60.0
    from al26.models.stellar import evolution as st
    from al26.models.yields import massive_star_yields, read_slrs
    twl = np.zeros_like(m)
    twl[0] = float(st.total_wind_loss(jnp.asarray(60.0)))
    y = massive_star_yields(m, read_slrs(), twl)
    sn_yield = np.stack([y["sn_yield_26al"], y["sn_yield_60fe"]], -1)
    wind_ratio = np.stack([y["wind_ratio_26al"], y["wind_ratio_60fe"]], -1)
    state = state.replace(cluster=c.replace(
        mass=jnp.asarray(m), m0=jnp.asarray(m),
        sn_yield=jnp.asarray(sn_yield), wind_ratio=jnp.asarray(wind_ratio),
        total_wind_loss=jnp.asarray(twl),
        disk_alive=jnp.asarray((m >= 0.1) & (m <= 3.0)),
    ))
    # rebuild aux from the modified m0: the massive-star slots AND (round 3)
    # the precomputed stellar PhaseTable derive from the initial masses
    from al26.sim.init import build_aux
    aux = build_aux(cfg, m, state.cluster.pos.dtype)

    t_sn = float(st.t_sn(jnp.asarray(60.0)))
    assert t_sn < 6.0
    s = run_steps(state, aux, cfg, cfg.n_steps)
    c1 = s.cluster
    assert bool(c1.kicked[0])
    assert float(c1.mass[0]) < 60.0  # dropped to remnant
    sne = np.asarray(c1.slr[:, :, CH_SNE])
    lm = (m >= 0.1) & (m <= 3.0)
    # 60 Msun collapses directly in LC18 (SN yield ~ 0): channel stays ~0
    # but the event still fires (kicked flag) — verify no NaNs
    assert np.isfinite(sne).all()
    # wind channel must have accumulated for disc stars
    assert np.asarray(c1.slr[:, :, CH_GLOBAL])[lm].sum() > 0


def test_supernova_injection_with_exploding_star():
    """A 20 Msun star has a real LC18 SN yield; discs get enriched."""
    cfg = SimConfig(n=32, rc=0.5, final_time=10.0, seed=4,
                    star_min_mass=0.1, star_max_mass=3.0,
                    no_massive_star_requirement=True)
    state, aux, cfg = init_cluster(cfg)
    c = state.cluster
    m = np.asarray(c.mass).copy()
    m[0] = 20.0
    from al26.models.stellar import evolution as st
    from al26.models.yields import massive_star_yields, read_slrs
    twl = np.zeros_like(m)
    twl[0] = float(st.total_wind_loss(jnp.asarray(20.0)))
    y = massive_star_yields(m, read_slrs(), twl)
    state = state.replace(cluster=c.replace(
        mass=jnp.asarray(m), m0=jnp.asarray(m),
        sn_yield=jnp.asarray(np.stack([y["sn_yield_26al"],
                                       y["sn_yield_60fe"]], -1)),
        wind_ratio=jnp.asarray(np.stack([y["wind_ratio_26al"],
                                         y["wind_ratio_60fe"]], -1)),
        total_wind_loss=jnp.asarray(twl),
        disk_alive=jnp.asarray((m >= 0.1) & (m <= 3.0)),
    ))
    import dataclasses
    aux = dataclasses.replace(aux, hm_idx=jnp.asarray([0], jnp.int32),
                              hm_slot_valid=jnp.ones(1, bool))
    s = run_steps(state, aux, cfg, cfg.n_steps)
    sne = np.asarray(s.cluster.slr[:, :, CH_SNE])
    lm = (m >= 0.1) & (m <= 3.0)
    assert sne[lm, 0].sum() > 0, "26Al SN injection expected"
    assert (sne[~lm] == 0).all()


def test_interloper_run():
    cfg = SimConfig(n=48, rc=0.5, final_time=2.0, seed=5, interloper=True,
                    interloper_mass=3.0, interloper_velocity=20.0,
                    interloper_radius=0.05, interloper_offset_time=0.0,
                    no_massive_star_requirement=True)
    state, aux, cfg = init_cluster(cfg)
    c = state.cluster
    assert c.n == cfg.n + 1
    assert bool(c.is_interloper[-1])
    # interloper starts at (-2rc, ri, 0) with +x velocity
    assert float(c.pos[-1, 0]) == pytest.approx(-2 * cfg.rc)
    s = run_steps(state, aux, cfg, cfg.n_steps)
    agb = np.asarray(s.cluster.slr[:, :, CH_AGB])
    raw = np.asarray(s.cluster.agb_raw)
    assert np.isfinite(agb).all() and np.isfinite(raw).all()
    # the interloper ploughs through the cluster: some deposition expected
    assert raw.sum() > 0
    # raw never decays -> raw >= decayed channel
    assert (raw >= agb - 1e-30).all()


def test_vmapped_ensemble():
    """Whole-cluster ensembles via vmap (SURVEY.md §2c item 4)."""
    cfg = SimConfig(n=32, rc=1.0, final_time=10.0, seed=11,
                    no_massive_star_requirement=True)
    states, auxes = [], []
    for seed in range(3):
        st_, aux_, _ = init_cluster(cfg.replace(seed=seed))
        states.append(st_)
        auxes.append(aux_)
    # pad hm_idx to common width
    width = max(a.hm_idx.shape[0] for a in auxes)
    import dataclasses
    auxes = [
        dataclasses.replace(
            a,
            hm_idx=jnp.pad(a.hm_idx, (0, width - a.hm_idx.shape[0])),
            hm_slot_valid=jnp.pad(a.hm_slot_valid,
                                  (0, width - a.hm_slot_valid.shape[0])),
        )
        for a in auxes
    ]
    batch_state = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
    batch_aux = jax.tree.map(lambda *xs: jnp.stack(xs), *auxes)
    stepped = jax.vmap(lambda s, a: step(s, a, cfg))(batch_state, batch_aux)
    assert stepped.cluster.pos.shape == (3, 32, 3)
    for i in range(3):
        single = step(states[i], auxes[i], cfg)
        np.testing.assert_allclose(
            np.asarray(stepped.cluster.pos[i]),
            np.asarray(single.cluster.pos), rtol=1e-9, atol=1e-12,
        )


def test_f32_f64_statistics_consistency():
    """Precision guard: f32 and f64 runs of the same cluster agree on the
    integrated SLR statistics to f32-appropriate tolerance over 1 Myr
    (the BASELINE reproducibility axis, SURVEY.md §7 hard part 2)."""
    cfg64 = SimConfig(n=96, rc=0.5, final_time=1.0, seed=23, dtype="f64")
    cfg32 = cfg64.replace(dtype="f32")
    s64, a64, c64 = init_cluster(cfg64)
    s32, a32, c32 = init_cluster(cfg32)
    o64 = run_steps(s64, a64, c64, 100)
    o32 = run_steps(s32, a32, c32, 100)
    sum64 = np.asarray(o64.cluster.slr).sum(axis=0)  # [S,C] totals
    sum32 = np.asarray(o32.cluster.slr).sum(axis=0)
    nz = sum64 > 0
    assert np.allclose(sum32[nz] / sum64[nz], 1.0, atol=0.05), (
        sum64, sum32)
    # positions stay close over this horizon (chaotic divergence is slow
    # with BHTree-parity softening)
    d = np.linalg.norm(np.asarray(o32.cluster.pos)
                       - np.asarray(o64.cluster.pos), axis=1)
    assert np.median(d) < 0.05


def test_step_with_block_integrator():
    """Full physics step with integrator=hermite4_block stays close to the
    hermite4 step over a checkpoint interval."""
    cfg_a = SimConfig(n=96, rc=1.0, final_time=10.0, seed=19,
                      integrator="hermite4")
    cfg_b = cfg_a.replace(integrator="hermite4_block", k_fast=16)
    s_a, aux_a, cfg_a = init_cluster(cfg_a)
    s_b, aux_b, cfg_b = init_cluster(cfg_b)
    o_a = run_steps(s_a, aux_a, cfg_a, 10)
    o_b = run_steps(s_b, aux_b, cfg_b, 10)
    np.testing.assert_allclose(np.asarray(o_b.cluster.pos),
                               np.asarray(o_a.cluster.pos),
                               rtol=1e-5, atol=1e-6)
    # SLR deposition statistics agree
    np.testing.assert_allclose(
        np.asarray(o_b.cluster.slr).sum(0),
        np.asarray(o_a.cluster.slr).sum(0), rtol=1e-4, atol=1e-30)


def test_sn_fires_for_13msun_star_that_thins_below_threshold():
    """Regression (review finding): a 13.5 Msun star whose post-MS wind
    drops its current mass below 13 before core collapse must still explode
    and inject its SN yield (initial-mass-based candidacy)."""
    cfg = SimConfig(n=32, rc=0.5, final_time=20.0, seed=6,
                    star_min_mass=0.1, star_max_mass=3.0,
                    no_massive_star_requirement=True)
    state, aux, cfg = init_cluster(cfg)
    c = state.cluster
    m = np.asarray(c.mass).copy()
    m[0] = 13.5
    from al26.models.stellar import evolution as st
    from al26.models.yields import massive_star_yields, read_slrs
    t_cc = float(st.t_sn(jnp.asarray(13.5)))   # ~16.6 Myr (Hurley+2000)
    assert t_cc < 20.0
    # the pre-SN mass is below the 13 Msun threshold — the failing case
    assert float(st.m_presn(jnp.asarray(13.5))) < 13.0
    twl = np.zeros_like(m)
    twl[0] = float(st.total_wind_loss(jnp.asarray(13.5)))
    y = massive_star_yields(m, read_slrs(), twl)
    assert y["sn_yield_26al"][0] > 0
    state = state.replace(cluster=c.replace(
        mass=jnp.asarray(m), m0=jnp.asarray(m),
        sn_yield=jnp.asarray(np.stack([y["sn_yield_26al"],
                                       y["sn_yield_60fe"]], -1)),
        wind_ratio=jnp.asarray(np.stack([y["wind_ratio_26al"],
                                         y["wind_ratio_60fe"]], -1)),
        total_wind_loss=jnp.asarray(twl),
        disk_alive=jnp.asarray((m >= 0.1) & (m <= 3.0)),
    ))
    import dataclasses
    aux = dataclasses.replace(aux, hm_idx=jnp.asarray([0], jnp.int32),
                              hm_slot_valid=jnp.ones(1, bool))
    s = run_steps(state, aux, cfg, cfg.n_steps)
    assert bool(s.cluster.kicked[0]), "SN must fire despite mass < 13"
    sne = np.asarray(s.cluster.slr[:, 0, CH_SNE])
    lm = (m >= 0.1) & (m <= 3.0)
    assert sne[lm].sum() > 0, "26Al SN injection expected"


def test_sn_parity_gate_loses_low_bin_sn():
    """The deliberate physics deviation, demonstrated at the step level:
    a 13.5 Msun star's pre-SN mass (~5.5 with the round-3 LC18 vel=300
    anchors) sits BELOW the 13 Msun threshold, so the reference's
    step-start current-mass gate (sn_parity_mode=True,
    al26_nbody.py:767,945-948) never fires its supernova, while the
    default initial-mass candidacy does. (Since round 3 this applies to
    the whole 13-25 Msun range — see
    test_golden_stats.test_golden_modes_diverge_at_10myr.)"""
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from al26.models.stellar import evolution as st
    from al26.sim.init import build_aux
    from al26.sim.step import step

    base = SimConfig(n=8, rc=1.0, final_time=20.0, seed=4, dtype="f64",
                     no_massive_star_requirement=True)
    state, aux, cfg = init_cluster(base)
    m0 = np.asarray(state.cluster.m0).copy()
    m0[0] = 13.5                      # pre-SN mass ~12.6 < threshold
    m0[1] = 1.0                       # a disc star to receive the yields
    t_sn = float(st.t_sn(jnp.asarray(13.5)))
    assert float(st.m_presn(jnp.asarray(13.5))) < cfg.high_mass_threshold
    k = int(t_sn / cfg.dt)            # step whose t_new crosses t_sn
    t_start = k * cfg.dt
    mass_now, mdot_now = st.evolve(jnp.asarray(m0), jnp.asarray(t_start))
    sn_yield = np.zeros((8, 2))
    sn_yield[0] = 1e-4
    cluster = dataclasses.replace(
        state.cluster,
        m0=jnp.asarray(m0), mass=mass_now.astype(jnp.float64),
        mdot=mdot_now.astype(jnp.float64),
        sn_yield=jnp.asarray(sn_yield),
        wind_ratio=jnp.zeros((8, 2)),
    )
    st0 = dataclasses.replace(state, cluster=cluster,
                              time=jnp.asarray(t_start, jnp.float64),
                              step_count=jnp.asarray(k, jnp.int32))
    aux = build_aux(cfg, m0, jnp.float64)
    assert bool(mass_now[0] < cfg.high_mass_threshold)  # step-start gate

    out_default = step(st0, aux, cfg)
    out_parity = step(st0, aux, cfg.replace(sn_parity_mode=True))
    assert bool(out_default.cluster.kicked[0])
    assert not bool(out_parity.cluster.kicked[0])
    assert float(out_default.cluster.slr[1, 0, 2]) > 0.0   # SNe channel
    assert float(out_parity.cluster.slr[1, 0, 2]) == 0.0
