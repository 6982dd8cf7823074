"""Stellar-evolution module and yield-pipeline tests (SURVEY.md §7 hard
part 1: SeBa-replacement fidelity checks)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from al26.models.stellar import evolution as st
from al26.models.yields import (
    calc_slr_yield,
    calc_wind_ratio,
    massive_star_yields,
    read_slrs,
)
from al26.models.agb import find_agb, read_agbs


def test_lifetimes_monotonic_and_plausible():
    m = jnp.asarray([13.0, 15.0, 20.0, 25.0, 40.0, 60.0, 120.0])
    t = np.asarray(st.t_sn(m))
    assert (np.diff(t) < 0).all(), "lifetime must decrease with mass"
    # canonical solar-metallicity ranges
    assert 10.0 < t[0] < 20.0    # 13 Msun
    assert 6.0 < t[3] < 9.0      # 25 Msun
    assert 2.0 < t[-1] < 4.0     # 120 Msun


def test_no_sn_below_cut():
    assert np.isinf(float(st.t_sn(jnp.asarray(3.0))))
    assert np.isinf(float(st.t_sn(jnp.asarray(7.9))))


def test_mdot_integrates_to_presn_loss():
    """Integral of the wind rate over the lifetime equals m0 - m_presn."""
    for m0 in [13.0, 20.0, 40.0, 120.0]:
        m0j = jnp.asarray(m0)
        t_cc = float(st.t_sn(m0j))
        ts = np.linspace(0, t_cc * 0.9999, 20001)
        rates = np.asarray(st.wind_mdot(m0j, jnp.asarray(ts)))
        integral = np.trapezoid(rates, ts)
        expected = m0 - float(st.m_presn(m0j))
        assert abs(integral - expected) / expected < 1e-3, m0


def test_mass_at_consistent_with_mdot():
    m0 = jnp.asarray(25.0)
    t_cc = float(st.t_sn(m0))
    t1, t2 = 0.3 * t_cc, 0.95 * t_cc
    ts = np.linspace(t1, t2, 50001)
    rates = np.asarray(st.wind_mdot(m0, jnp.asarray(ts)))
    dm = np.trapezoid(rates, ts)
    m1 = float(st.mass_at(m0, jnp.asarray(t1)))
    m2 = float(st.mass_at(m0, jnp.asarray(t2)))
    # trapezoid across the MS->post-MS rate discontinuity limits accuracy
    # (one interval straddles the jump: error ~ rate_jump * dt / 2)
    assert abs((m1 - m2) - dm) < 2e-4 * dm


def test_sn_signal_is_exact_zero_and_remnant_mass():
    m0 = jnp.asarray(20.0)
    t_cc = float(st.t_sn(m0))
    assert float(st.wind_mdot(m0, jnp.asarray(t_cc * 1.0001))) == 0.0
    assert float(st.wind_mdot(m0, jnp.asarray(t_cc * 0.999))) > 0.0
    m_after = float(st.mass_at(m0, jnp.asarray(t_cc * 1.01)))
    # compact remnant for a 20 Msun star: the LC18 vel=300 [Fe/H]=0
    # mass-conservation anchor is 3.11 Msun (lc18_anchors)
    assert 1.0 < m_after < 4.0


def test_total_wind_loss_semantics():
    """Reference's calc_total_mass_loss evolves past the SN -> includes the
    ejecta (al26_nbody.py:467-493)."""
    m0 = jnp.asarray(15.0)
    assert abs(float(st.total_wind_loss(m0)) -
               (15.0 - float(st.m_remnant(m0)))) < 1e-12
    # direct-collapse BH star loses less relative to an exploding star
    assert float(st.total_wind_loss(jnp.asarray(40.0))) < 40.0


def test_read_slrs_full_database():
    slrs = read_slrs()
    assert set(slrs) == {"Be10", "Al26", "Ca41", "Mn53", "Fe60"}
    al = slrs["Al26"]
    assert al.half_life_myr == 0.717
    assert al.stable == "27Al"
    assert al.zss == 5.23e-05
    # LC18 yield curves attached for Al26/Fe60: winds tabulated over
    # 13-120 Msun, SN ejecta only for 13-25 Msun (direct collapse above —
    # limongi-chieffi-2018/fit-data.py:72-79)
    assert len(al.wind_mass) == 9 and len(al.sne_mass) == 4
    assert al.wind_mass[0] == 13.0 and al.wind_mass[-1] == 120.0
    assert al.sne_mass[0] == 13.0 and al.sne_mass[-1] == 25.0
    # exact table endpoints (limongi_chieffi_2018/wind-yields.csv row Al26)
    assert np.isclose(al.wind_yield[0], 5.4088e-06)
    assert np.isclose(al.wind_yield[-1], 8.5138e-04)


def test_metallicity_yield_selection():
    """cfg.metallicity snaps to the nearest LC18 [Fe/H] grid point and
    selects the matching yield set (superset of the reference's fixed
    solar choice, fit-data.py feh=0)."""
    from al26.models.yields import feh_for_z

    assert feh_for_z(0.02) == 0
    assert feh_for_z(0.002) == -1
    assert feh_for_z(0.0002) == -2
    assert feh_for_z(1e-5) == -3
    assert feh_for_z(0.01) == 0          # log10(0.5) = -0.3 -> nearer 0

    solar = read_slrs()
    sub = read_slrs(feh=-1)
    assert set(sub) == set(solar)
    al0, al1 = solar["Al26"], sub["Al26"]
    np.testing.assert_array_equal(al0.wind_mass, al1.wind_mass)
    # different metallicity set -> different yields, same table shape
    assert not np.allclose(al0.wind_yield, al1.wind_yield)
    assert (al1.wind_yield > 0).all()
    with pytest.raises(ValueError):
        read_slrs(feh=2)


def test_init_cluster_uses_metallicity_yields():
    """init_cluster at Z=0.002 must bake the [Fe/H]=-1 wind yields into the
    per-star attributes (sim/init.py read_slrs call)."""
    from al26.config import SimConfig
    from al26.models.yields import calc_slr_yield
    from al26.sim import init_cluster

    base = dict(n=64, rc=1.0, final_time=1.0, seed=97, dtype="f32")
    s0, _, _ = init_cluster(SimConfig(**base))
    s1, _, _ = init_cluster(SimConfig(metallicity=0.002, **base))
    m0 = np.asarray(s0.cluster.m0)
    hm = m0 >= 13.0
    assert hm.any()
    al_solar = read_slrs()["Al26"]
    al_sub = read_slrs(feh=-1)["Al26"]
    i = int(np.flatnonzero(hm)[0])
    # wind_ratio = SLR wind yield / total wind loss; isotope 0 = 26Al.
    # (Lifetimes/total_wind_loss also shift with Z, so only the SOLAR run
    # is checked for an exact value; the sub-solar run must differ.)
    w0 = np.asarray(s0.cluster.wind_ratio[:, 0])
    w1 = np.asarray(s1.cluster.wind_ratio[:, 0])
    twl0 = float(np.asarray(s0.cluster.total_wind_loss)[i])
    expect0 = calc_slr_yield(float(m0[i]), al_solar.wind_mass,
                             al_solar.wind_yield) / twl0
    np.testing.assert_allclose(w0[i], expect0, rtol=1e-6)
    assert w0[i] != w1[i]
    # the change direction must match the tables (sub-solar 26Al wind
    # yields are lower at this mass)
    y_sub = calc_slr_yield(float(m0[i]), al_sub.wind_mass, al_sub.wind_yield)
    y_sol = calc_slr_yield(float(m0[i]), al_solar.wind_mass,
                           al_solar.wind_yield)
    assert (w1[i] < w0[i]) == (y_sub < y_sol)


def test_calc_slr_yield_interpolation():
    slrs = read_slrs()
    al = slrs["Al26"]
    # at a grid point: exact table value
    y13 = calc_slr_yield(13.0, al.wind_mass, al.wind_yield)
    assert np.isclose(y13, 5.4088e-06, rtol=1e-10)
    # between grid points: between neighbours (log-space Akima)
    y17 = calc_slr_yield(17.0, al.wind_mass, al.wind_yield)
    assert min(5.4109e-06, 4.6238e-06) * 0.5 < y17 < 1.3068e-05 * 2
    # outside range: zero (al26_nbody.py:459-461)
    assert calc_slr_yield(12.0, al.wind_mass, al.wind_yield) == 0.0
    assert calc_slr_yield(150.0, al.wind_mass, al.wind_yield) == 0.0


def test_sne_yields_zero_for_direct_collapse():
    """sne-yields.csv rows are ~0 for >=30 Msun (LC18 set R direct
    collapse) — the pipeline must not produce NaNs there."""
    slrs = read_slrs()
    al = slrs["Al26"]
    y40 = calc_slr_yield(40.0, al.sne_mass, al.sne_yield)
    assert np.isfinite(y40) and y40 >= 0.0


def test_massive_star_yields_vectorised():
    slrs = read_slrs()
    m0 = np.array([1.0, 15.0, 40.0])
    twl = np.array([0.0, 13.6, 27.5])
    y = massive_star_yields(m0, slrs, twl)
    assert y["wind_ratio_26al"][0] == 0.0
    assert y["wind_ratio_26al"][1] > 0.0
    assert y["sn_yield_26al"][1] > 0.0
    ratio = calc_wind_ratio(13.6, y["wind_yield_26al"][1])
    assert np.isclose(y["wind_ratio_26al"][1], ratio)


def test_agb_tables():
    tables = read_agbs()
    masses = sorted(t.mass_msun for t in tables)
    assert masses == [3.0, 5.0, 6.0, 7.0]
    t3 = find_agb(tables, 3.0)
    # dense grid covers the table range and matches host Akima inside
    mid = 0.5 * (t3.t_myr[0] + t3.t_myr[-1])
    host = t3.interp_rate_host("26al", mid)
    grid = np.interp(mid, t3.grid_t, t3.grid_26al)
    assert np.isclose(host, grid, rtol=1e-3, atol=1e-25)
    with pytest.raises(ValueError):
        find_agb(tables, 4.0)


def test_hurley2000_formula_exactness():
    """The Hurley+2000 eq. (4)-(7) implementation reproduces hand-evaluated
    values of the published formulae (zeta = 0 coefficients) to float
    precision — guards the coefficient table against typos/regressions."""
    from al26.models.stellar import hurley2000 as h

    # independently hand-evaluated t_bgb (Myr): (a1 + a2 M^4 + a3 M^5.5 +
    # M^7) / (a4 M^2 + a5 M^7)
    expect_tbgb = {1.0: 11581.8, 13.0: 15.642, 15.0: 12.624,
                   40.0: 4.733, 120.0: 3.248}
    for m, want in expect_tbgb.items():
        got = float(h.t_bgb(jnp.asarray(m)))
        assert abs(got - want) / want < 2e-3, (m, got, want)
    # at solar Z massive stars have mu ~ 1 > x: t_ms = mu * t_bgb ~ t_bgb
    for m in (13.0, 40.0, 120.0):
        tms = float(h.t_ms(jnp.asarray(m)))
        tbg = float(h.t_bgb(jnp.asarray(m)))
        assert 0.99 * tbg < tms <= tbg


def test_t_sn_matches_published_solar_grids():
    """t_sn within the documented grid spread of PUBLISHED solar-Z total
    (H+He) lifetimes: Schaller et al. (1992, A&AS 96, 269) non-overshoot
    grid values below; Hurley's underlying Pols et al. (1998) models
    include core overshooting, which systematically lengthens lifetimes,
    so the comparison allows +30%/-10% (docs/stellar_model.md)."""
    schaller_total = {15.0: 12.9, 25.0: 7.1, 40.0: 4.8, 60.0: 3.9,
                      120.0: 2.9}
    for m, t_grid in schaller_total.items():
        t = float(st.t_sn(jnp.asarray(m)))
        assert 0.9 * t_grid < t < 1.30 * t_grid, (m, t, t_grid)
    # absolute sanity anchors independent of any one grid
    assert 14.0 < float(st.t_sn(jnp.asarray(13.0))) < 19.0
    assert 2.5 < float(st.t_sn(jnp.asarray(120.0))) < 4.0


def test_t_end_continuous_at_sn_cut():
    """The hand-anchored low-mass branch and the Hurley branch meet at the
    8 Msun SN cut without a physically-meaningful jump (< 15%)."""
    lo = float(st.t_end(jnp.asarray(7.999)))
    hi = float(st.t_end(jnp.asarray(8.001)))
    assert abs(hi - lo) / lo < 0.15, (lo, hi)


def test_hurley_coeffs_solar_column_matches_round1_constants():
    """coeffs(0.02) must reproduce the zeta = 0 constants (the round-1
    public surface A1..A10, X_SOLAR) exactly."""
    from al26.models.stellar import hurley2000 as h

    c = h.coeffs(0.02)
    assert c[1] == h.A1 == 1.593890e3
    assert c[4] == h.A4 == 4.141960e-2
    assert c[10] == h.A10 == 8.073972e-1
    assert c["x"] == h.X_SOLAR == 0.95


def test_hurley_metallicity_polynomials_hand_evaluated():
    """Independent hand-evaluation of the Hurley+2000 Appendix A zeta
    polynomials at Z = 0.002 (zeta = -1): a_i = c0 - c1 + c2 - c3."""
    import math

    from al26.models.stellar import hurley2000 as h

    c = h.coeffs(0.002)
    zeta = math.log10(0.002 / 0.02)
    assert abs(zeta + 1.0) < 1e-12
    assert np.isclose(c[1], 1.593890e3 - 2.053038e3 + 1.231226e3 - 2.327785e2)
    assert np.isclose(c[6], 1.949814e1 - 1.758178e0 - 6.008212e0 + 4.470533e0)
    assert np.isclose(c[9], 1.312179e0 + 3.294936e-1 + 9.231860e-2 - 2.610989e-2)
    # eq. (6): x = max(0.95, min(0.95 - 0.03*(zeta + 0.30103), 0.99))
    assert np.isclose(c["x"], min(0.95 - 0.03 * (-1 + 0.30103), 0.99))
    # t_bgb against a direct formula evaluation at 15 Msun
    m = 15.0
    num = c[1] + c[2] * m**4 + c[3] * m**5.5 + m**7
    den = c[4] * m**2 + c[5] * m**7
    assert np.isclose(float(h.t_bgb(jnp.asarray(m), 0.002)), num / den,
                      rtol=1e-6)


def test_metallicity_threads_through_evolution():
    """t_sn / wind_mdot / mass_at respond to z; the default path is the
    solar one; SN signal semantics survive off-solar."""
    m0 = jnp.asarray(20.0)
    t_solar = float(st.t_sn(m0))
    t_lowz = float(st.t_sn(m0, z=0.004))
    assert t_solar == float(st.t_sn(m0, z=0.02))  # default == explicit solar
    assert abs(t_lowz - t_solar) / t_solar > 0.01  # Z actually matters
    # low-mass branch rescales continuously (no jump at the SN cut)
    lo = float(st.t_end(jnp.asarray(7.999), z=0.004))
    hi = float(st.t_end(jnp.asarray(8.001), z=0.004))
    assert abs(hi - lo) / lo < 0.15, (lo, hi)
    # the mdot == 0 SN signal still fires exactly at the z-shifted t_sn
    assert float(st.wind_mdot(m0, jnp.asarray(t_lowz * 0.999), z=0.004)) > 0
    assert float(st.wind_mdot(m0, jnp.asarray(t_lowz * 1.001), z=0.004)) == 0
    # lifetime-integrated loss is Z-independent by design (solar mass
    # anchors, evolution.py docstring)
    assert float(st.total_wind_loss(m0)) == float(st.total_wind_loss(m0))


def test_metallicity_config_guard():
    """init_cluster rejects Z outside the Hurley fit validity range."""
    from al26.config import SimConfig
    from al26.sim.init import init_cluster

    with pytest.raises(ValueError, match="metallicity"):
        init_cluster(SimConfig(n=8, metallicity=0.5,
                               no_massive_star_requirement=True))


# ---------------------------------------------------------------------------
# Round-3 anchor provenance (VERDICT r2 item 1): every mass anchor derives
# from a published source, pinned here by independent re-derivation.
# ---------------------------------------------------------------------------
def _independent_lc18_sums(path, n_mass, vel, feh):
    """Test-local re-parse of the raw LC18 machine-readable tables: sum of
    all isotopic yields per initial mass (mass conservation)."""
    import os
    import re

    sums = np.zeros(n_mass)
    row = re.compile(r"^\s*(\d+)\s+(-?\d+)\s+(\S+)\s+(.*)$")
    with open(path) as f:
        for line in f:
            m = row.match(line)
            if not m:
                continue
            vals = m.group(4).split()
            if len(vals) != n_mass:
                continue
            if int(m.group(1)) == vel and int(m.group(2)) == feh:
                sums += [float(x) for x in vals]
    return sums


def test_lc18_anchors_match_independent_rederivation():
    """m_rem = m_ini - sum(table 8), m_presn = m_ini - sum(table 9),
    re-derived in-test from the shipped raw tables for every [Fe/H]."""
    import os

    from al26.models.stellar import lc18_anchors as lc

    raw = os.path.join(os.path.dirname(lc.__file__), "..", "..", "data",
                       "limongi_chieffi_2018", "raw")
    for feh in lc.FEH_GRID:
        t8 = _independent_lc18_sums(
            os.path.join(raw, "limongi-table-8.txt"), 9, 300, feh)
        t9 = _independent_lc18_sums(
            os.path.join(raw, "limongi-table-9.txt"), 4, 300, feh)
        presn, rem = lc.anchors(feh)
        np.testing.assert_allclose(rem, lc.M_GRID - t8, rtol=1e-12)
        np.testing.assert_allclose(presn[:4], lc.M_GRID[:4] - t9, rtol=1e-12)
        # direct collapse above 25 Msun: presn == rem (LC18 set R)
        np.testing.assert_allclose(presn[4:], rem[4:], rtol=1e-12)
        # physical ordering
        assert np.all(rem > 0) and np.all(presn >= rem)
        assert np.all(presn <= lc.M_GRID)


def test_evolution_uses_lc18_anchors():
    """m_presn / m_remnant / total_wind_loss hit the LC18 anchor values
    exactly at the grid masses, per [Fe/H] set."""
    from al26.models.stellar import lc18_anchors as lc

    for feh, z in [(0, 0.02), (-1, 0.002), (-2, 2e-4), (-3, 2e-5)]:
        presn, rem = lc.anchors(feh)
        mg = jnp.asarray(lc.M_GRID)
        np.testing.assert_allclose(np.asarray(st.m_presn(mg, z)), presn,
                                   rtol=1e-6)
        np.testing.assert_allclose(np.asarray(st.m_remnant(mg, z)), rem,
                                   rtol=1e-6)
        np.testing.assert_allclose(np.asarray(st.total_wind_loss(mg, z)),
                                   lc.M_GRID - rem, rtol=1e-6)
    # the [Fe/H] sets genuinely differ (metallicity threads through)
    assert not np.allclose(np.asarray(st.m_remnant(jnp.asarray(60.0), 0.02)),
                           np.asarray(st.m_remnant(jnp.asarray(60.0), 2e-5)))


def test_tout96_zams_reproduces_the_sun():
    """Tout et al. (1996) fits at 1 Msun give the ZAMS Sun:
    L = 0.70 Lsun, R = 0.89 Rsun."""
    from al26.models.stellar import hurley2000 as h

    assert abs(float(h.l_zams(1.0)) - 0.70) < 0.02
    assert abs(float(h.r_zams(1.0)) - 0.89) < 0.02
    # monotone growth over the massive range
    ms = np.geomspace(1.0, 150.0, 50)
    assert np.all(np.diff(h.l_zams(ms)) > 0)
    assert np.all(np.diff(h.r_zams(ms)) > 0)


def test_nj90_formula_transcription():
    """NJ90: log10(-Mdot) = -14.02 + 1.24 logL + 0.16 logM + 0.81 logR,
    evaluated independently here against hurley2000.mdot_nj90."""
    from al26.models.stellar import hurley2000 as h

    rng = np.random.default_rng(3)
    for _ in range(20):
        m = rng.uniform(1.0, 120.0)
        L = rng.uniform(1.0, 2e6)
        R = rng.uniform(0.5, 1000.0)
        expect = 10.0 ** (-14.02 + 1.24 * np.log10(L) + 0.16 * np.log10(m)
                          + 0.81 * np.log10(R))
        assert abs(float(h.mdot_nj90(m, L, R)) / expect - 1.0) < 1e-4


def test_ms_wind_cap_on_grid():
    """The _MS_BUDGET_CAP guard on the LC18 grid, default (vel=300)
    family, at every PRODUCTION-REACHABLE (z, [Fe/H]) pairing: the
    UNRAMPED NJ90-at-ZAMS MS loss stays below half the wind budget
    everywhere, and with the round-5 calibrated ramp (x (1 + c/2),
    models.stellar.wind_shape) the cap engages only at the very top of
    the grid (>= 80 Msun) — a timing-only choice; either way the
    post-MS rate stays strictly positive (the SN signal is mdot == 0).
    The pairings use the runtime resolution feh_for_z — the feh=-3 set
    is unreachable within the Hurley validity range [1e-4, 0.03] (it
    needs z < 6.3e-5)."""
    from al26.models.stellar import hurley2000 as h
    from al26.models.stellar import lc18_anchors as lc
    from al26.models.yields import feh_for_z

    tms = np.asarray(h.t_ms(lc.M_GRID))
    zs = [0.02, 0.002, 2e-4, 1e-4]
    assert [feh_for_z(z) for z in zs] == [0, -1, -2, -2]
    low = lc.M_GRID < 80.0
    for z in zs:
        presn, _ = lc.anchors(feh_for_z(z))
        dm_ms = np.asarray(h.ms_wind_mdot(lc.M_GRID, z)) * tms
        frac = dm_ms / (lc.M_GRID - presn)
        assert np.all(frac < st._MS_BUDGET_CAP), (z, frac)
        c = np.asarray(st.wind_shape.interp("ramp_c", lc.M_GRID))
        assert np.all((frac * (1.0 + 0.5 * c))[low] < st._MS_BUDGET_CAP), z
        _, _, _, mdot_post, _ = st._phase_rates(jnp.asarray(lc.M_GRID), z)
        assert np.all(np.asarray(mdot_post) > 0.0), z


def test_wind_rate_positive_at_the_8msun_anchor():
    """The lifetime wind budget m0 - m_presn vanishes at the exact 8 Msun
    anchor on the LC18 families (the anchor grid pins presn(8) = 8), so
    without _DM_WIND_FLOOR the ALIVE rate there would be exactly 0 — the
    reserved post-collapse SN signal (al26_nbody.py:946-948). Pin > 0
    while alive and == 0 after collapse, on every track family."""
    m0 = jnp.asarray(8.0)
    for tracks in st.TRACKS:
        t_cc = float(st.t_end(m0, 0.02, tracks))
        for frac in (0.1, 0.5, 0.98):
            rate = float(st.wind_mdot(m0, jnp.asarray(t_cc * frac),
                                      0.02, tracks))
            assert rate > 0.0, (tracks, frac)
        assert float(st.wind_mdot(m0, jnp.asarray(t_cc * 1.001),
                                  0.02, tracks)) == 0.0, tracks


def test_wind_rates_strictly_positive_dense_grid():
    """Both phase rates stay strictly positive over a dense [8, 120]
    grid for every family: mdot == 0 must mean 'collapsed', never
    'budget rounded to zero' (the floor keeps the 8-Msun-adjacent band
    and the interpolation-clamp plateaus off exact zero). The round-5
    MS ramp keeps the invariant at BOTH ends of the MS: the ZAMS rate
    r0 > 0 and the slope >= 0 (monotone rising, wind_shape)."""
    ms = jnp.asarray(np.geomspace(8.0, 120.0, 257))
    for tracks in st.TRACKS:
        _, r0, r1, mdot_post, _ = st._phase_rates(ms, 0.02, tracks)
        assert np.all(np.asarray(r0) > 0.0), tracks
        assert np.all(np.asarray(r1) >= 0.0), tracks
        assert np.all(np.asarray(mdot_post) > 0.0), tracks


def test_hurley_z_validity_guard():
    """coeffs raises outside the published fit range [1e-4, 0.03]: the
    config-level check (sim.init) is bypassed by library callers passing
    an explicit z kwarg, so the formula module enforces its own domain."""
    from al26.models.stellar import hurley2000 as h

    with pytest.raises(ValueError, match="validity"):
        h.coeffs(5e-5)
    with pytest.raises(ValueError, match="validity"):
        st.t_sn(jnp.asarray(20.0), z=0.05)
    # the wind-rate path carries its own (Kudritzki-scaled) z too
    with pytest.raises(ValueError, match="validity"):
        h.ms_wind_mdot(20.0, 5e-5)
    # the boundary values are valid
    assert float(h.t_bgb(jnp.asarray(20.0), 1e-4)) > 0.0
    assert float(h.t_bgb(jnp.asarray(20.0), 0.03)) > 0.0


def test_ms_mdot_table_matches_closed_form():
    """The in-jit log-log interpolation table reproduces the host-side
    NJ90/Tout closed form to < 0.2% (and stays finite in f32 where the
    raw rational fits overflow)."""
    from al26.models.stellar import hurley2000 as h

    ms = np.geomspace(0.8, 150.0, 333)
    log_mg, log_rate = st._ms_mdot_table(0.02)
    interp = np.exp(np.interp(np.log(ms), log_mg, log_rate))
    np.testing.assert_allclose(interp, h.ms_wind_mdot(ms, 0.02), rtol=2e-3)
    out = st._phase_rates(jnp.asarray([120.0, 150.0], jnp.float32), 0.02)
    for arr in out:
        assert np.isfinite(np.asarray(arr)).all()


def test_evolve_from_table_matches_evolve_bitwise():
    """The precomputed PhaseTable path (the per-step fast path, sim.step)
    reproduces evolve() EXACTLY: phase_table factors out only (m0, z)-only
    subexpressions and evolve_from_table keeps the same where-structure,
    so no float op ordering changes."""
    rng = np.random.default_rng(7)
    m0 = jnp.asarray(np.concatenate([
        rng.uniform(0.1, 150.0, 500),
        [7.999, 8.0, 8.001, 13.0, 25.0, 25.001, 120.0],
    ]))
    for z in (0.02, 0.002):
        tbl = st.phase_table(m0, z=z)
        for t in (0.0, 2.7, 9.99, 40.0):
            mass_a, mdot_a = st.evolve(m0, jnp.asarray(t), z=z)
            mass_b, mdot_b = st.evolve_from_table(tbl, m0, jnp.asarray(t))
            np.testing.assert_array_equal(np.asarray(mass_a),
                                          np.asarray(mass_b))
            np.testing.assert_array_equal(np.asarray(mdot_a),
                                          np.asarray(mdot_b))


def test_phase_table_f32_state_promotion_matches():
    """Under x64 an f32-state run used to promote inside evolve (f64
    anchor constants) and cast the result back; the table path must
    reproduce that bit-for-bit: the table is computed from the f32-cast
    m0 but STORED in the promoted f64 (sim.init._stellar_table)."""
    assert jax.config.jax_enable_x64
    rng = np.random.default_rng(11)
    m0_f32 = jnp.asarray(rng.uniform(0.5, 120.0, 300), jnp.float32)
    tbl = st.phase_table(m0_f32, z=0.02)
    assert tbl.t_ms.dtype == jnp.float64   # promotion preserved
    t = jnp.asarray(5.5)
    mass_a, mdot_a = st.evolve(m0_f32, t, z=0.02)
    mass_b, mdot_b = st.evolve_from_table(tbl, m0_f32, t)
    np.testing.assert_array_equal(
        np.asarray(mass_a.astype(jnp.float32)),
        np.asarray(mass_b.astype(jnp.float32)))
    np.testing.assert_array_equal(
        np.asarray(mdot_a.astype(jnp.float32)),
        np.asarray(mdot_b.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# Round 5: MS wind timing calibrated on the reference's own SeBa wind
# histories (limongi-2006.tar.gz::cumulative_yield.pdf vector data ->
# data/seba/wind-shape.csv; scripts/gen_wind_shape.py).
# ---------------------------------------------------------------------------

def test_ms_wind_ramp_matches_dump_quantiles():
    """The one-parameter monotone ramp rate(u) ∝ 1 + c u reproduces the
    dump-derived within-MS cumulative release quantiles (q25/q50/q75 of
    the digitized SeBa curves) to < 0.04 in life fraction on every
    calibration mass — the shape pin VERDICT r4 item 3 asked for."""
    from al26.models.stellar import wind_shape

    tbl = wind_shape.table()
    u = np.linspace(0.0, 1.0, 2001)
    for i in range(len(tbl["m0"])):
        c = tbl["ramp_c"][i]
        F = (u + 0.5 * c * u * u) / (1.0 + 0.5 * c)
        for q, key in ((0.25, "q25"), (0.5, "q50"), (0.75, "q75")):
            u_model = float(np.interp(q, F, u))
            assert abs(u_model - tbl[key][i]) < 0.04, (tbl["m0"][i], key)


def test_ms_wind_rate_monotone_rising_and_budget_exact():
    """The MS rate rises monotonically (SeBa's behaviour, not flat) and
    the ramp preserves the budget integral EXACTLY: the mass lost by
    core collapse equals m0 - m_presn on every family."""
    ms = jnp.asarray([13.0, 20.0, 40.0, 60.0, 90.0])
    for tracks in st.TRACKS:
        t_ms, r0, r1, _, t_cc = st._phase_rates(ms, 0.02, tracks)
        early = np.asarray(st.wind_mdot(ms, 0.1 * t_ms, 0.02, tracks))
        late = np.asarray(st.wind_mdot(ms, 0.85 * t_ms, 0.02, tracks))
        assert np.all(late > early), tracks  # strictly rising (c > 0)
        # calibrated rise factor: rate(t_ms)/rate(0) = 1 + c in [2, 4.5]
        ratio = np.asarray(r0 + r1 * t_ms) / np.asarray(r0)
        assert np.all(ratio > 2.0) and np.all(ratio < 4.5), tracks
        m_end = st.mass_at(ms, t_cc * (1.0 - 1e-9), 0.02, tracks)
        presn = st.m_presn(ms, 0.02, tracks)
        np.testing.assert_allclose(np.asarray(m_end), np.asarray(presn),
                                   rtol=1e-7, err_msg=tracks)


def test_seba_ms_share_matches_dump():
    """On the seba family the fraction of the lifetime wind budget shed
    by the end of the MS equals the dump-calibrated ms_frac (3-10% over
    the 20-60 Msun grid) — replacing the round-4 0.5 cap, which was
    ~5-15x too MS-heavy against the reference's own curves."""
    from al26.models.stellar import wind_shape

    tbl = wind_shape.table()
    m0 = jnp.asarray(tbl["m0"])
    t_ms, r0, r1, _, _ = st._phase_rates(m0, 0.02, "seba")
    dm_ms = np.asarray((r0 + 0.5 * r1 * t_ms) * t_ms)
    budget = np.asarray(m0 - st.m_presn(m0, 0.02, "seba"))
    np.testing.assert_allclose(dm_ms / budget, tbl["ms_frac"], rtol=1e-8)
    assert np.all(tbl["ms_frac"] < 0.11)
