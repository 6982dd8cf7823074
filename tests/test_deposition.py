"""Golden-value tests of the deposition physics against independent numpy
transcriptions of the reference formulas (SURVEY.md §4d,e)."""
import jax.numpy as jnp
import numpy as np

from al26.ops import deposition as dep
from al26.state import CH_AGB
from al26.units import LN2_REFERENCE


def _reference_wind_abs(lm_id, hm_id, x, v, mdot, wind_ratio, r_disk,
                        distance_limit, bubble_radius, dt):
    """Numpy oracle with the exact semantics of calc_wind_abs
    (al26_nbody.py:642-702): per (lm, hm) pair, skip pairs beyond the
    bubble in the local model, otherwise deposit
    wind_ratio*mdot*eta_bub*dt with eta_bub = 0.75 r_disk^2 |v_lm| dt / r_bub^3."""
    n = len(x)
    out = np.zeros(n)
    for i in lm_id:
        for j in hm_id:
            if distance_limit != 0.0:
                d = np.linalg.norm(x[i] - x[j])
                if bubble_radius <= d:
                    continue
            spd = np.linalg.norm(v[i])
            eta = 0.75 * r_disk[i] ** 2 * (spd * dt) / bubble_radius**3
            out[i] += wind_ratio[j] * mdot[j] * eta * dt
    return out


def _random_system(rng, n=40, n_hm=4):
    x = rng.normal(0, 0.5, size=(n, 3))
    v = rng.normal(0, 1.0, size=(n, 3))
    mass = rng.uniform(0.2, 2.0, n)
    hm_id = rng.choice(n, n_hm, replace=False)
    mass[hm_id] = rng.uniform(13.0, 60.0, n_hm)
    lm_id = [i for i in range(n) if 0.1 <= mass[i] <= 3.0]
    mdot = np.zeros(n)
    mdot[hm_id] = rng.uniform(0.01, 0.5, n_hm)
    ratio = np.zeros((n, 2))
    ratio[hm_id] = rng.uniform(1e-6, 1e-4, (n_hm, 2))
    r_disk = np.full(n, 100 * 4.84814e-6)
    return x, v, mass, hm_id, lm_id, mdot, ratio, r_disk


def test_wind_deposition_matches_reference_global_and_local():
    rng = np.random.default_rng(0)
    x, v, mass, hm_id, lm_id, mdot, ratio, r_disk = _random_system(rng)
    dt = 0.01
    lm_mask = jnp.asarray((mass >= 0.1) & (mass <= 3.0))
    hm_idx = jnp.asarray(hm_id, dtype=jnp.int32)
    hm_valid = jnp.ones(len(hm_id), bool)

    for local, r_bub in [(False, 1.3), (True, 0.1)]:
        got = dep.wind_deposition(
            jnp.asarray(x), jnp.asarray(v), jnp.asarray(r_disk),
            lm_mask, hm_idx, hm_valid, jnp.asarray(mdot),
            jnp.asarray(ratio), jnp.asarray(r_bub), jnp.asarray(dt),
            local=local,
        )
        for s in range(2):
            want = _reference_wind_abs(
                lm_id, hm_id, x, v, mdot, ratio[:, s], r_disk,
                distance_limit=(r_bub if local else 0.0),
                bubble_radius=r_bub, dt=dt,
            )
            np.testing.assert_allclose(np.asarray(got[:, s]), want,
                                       rtol=1e-12, atol=1e-30)


def test_sn_injection_matches_reference():
    rng = np.random.default_rng(1)
    x, v, mass, hm_id, lm_id, mdot, ratio, r_disk = _random_system(rng)
    # one star explodes: wind rate exactly zero, not yet kicked
    sn_star = hm_id[0]
    mdot[sn_star] = 0.0
    kicked = np.zeros(len(x), bool)
    kicked[hm_id[1]] = True  # already-kicked star must not re-inject
    mdot[hm_id[1]] = 0.0
    sn_yield = np.zeros((len(x), 2))
    sn_yield[hm_id] = rng.uniform(1e-5, 1e-4, (len(hm_id), 2))

    got, kicked_new = dep.sn_injection(
        jnp.asarray(x), jnp.asarray(r_disk),
        jnp.asarray((mass >= 0.1) & (mass <= 3.0)),
        jnp.asarray(hm_id, dtype=jnp.int32),
        jnp.ones(len(hm_id), bool),
        jnp.asarray(mdot), jnp.asarray(kicked), jnp.asarray(sn_yield),
    )
    want = np.zeros((len(x), 2))
    for i in lm_id:
        d = np.linalg.norm(x[i] - x[sn_star])
        eta = 0.5 * 0.7 * (0.5 * r_disk[i] ** 2) / (4 * d**2)
        want[i] = sn_yield[sn_star] * eta
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12)
    assert bool(kicked_new[sn_star])
    assert bool(kicked_new[hm_id[1]])  # stays kicked
    assert not np.asarray(kicked_new)[lm_id].any()


def test_chord_fraction_exact_vs_sampled():
    rng = np.random.default_rng(2)
    for _ in range(20):
        p1o = jnp.asarray(rng.normal(0, 1, 3))
        p1n = jnp.asarray(rng.normal(0, 1, 3))
        p2o = jnp.asarray(rng.normal(0, 1, 3))
        p2n = jnp.asarray(rng.normal(0, 1, 3))
        r = float(rng.uniform(0.3, 1.5))
        exact = float(dep.chord_fraction(p1o, p1n, p2o, p2n, r))
        sampled = float(dep.chord_fraction_sampled(p1o, p1n, p2o, p2n, r,
                                                   n=16384))
        assert abs(exact - sampled) < 2e-3, (exact, sampled)


def test_chord_fraction_degenerate_static():
    p = jnp.zeros(3)
    q = jnp.asarray([0.05, 0.0, 0.0])
    assert float(dep.chord_fraction(p, p, q, q, 0.1)) == 1.0
    far = jnp.asarray([5.0, 0.0, 0.0])
    assert float(dep.chord_fraction(p, p, far, far, 0.1)) == 0.0


def test_decay_matches_reference_constants():
    slr = jnp.ones((3, 2, 4))
    dt = 0.01
    out = dep.apply_decay(slr, jnp.asarray(dt), 0.717, 2.600, decay_agb=True)
    f_al = np.exp(-dt * LN2_REFERENCE / 0.717)
    f_fe = np.exp(-dt * LN2_REFERENCE / 2.600)
    np.testing.assert_allclose(np.asarray(out[:, 0]), f_al, rtol=1e-14)
    np.testing.assert_allclose(np.asarray(out[:, 1]), f_fe, rtol=1e-14)


def test_decay_agb_channel_gating():
    slr = jnp.ones((2, 2, 4))
    out = dep.apply_decay(slr, jnp.asarray(0.01), 0.717, 2.600,
                          decay_agb=False)
    np.testing.assert_allclose(np.asarray(out[:, :, CH_AGB]), 1.0)
    assert (np.asarray(out[:, :, :CH_AGB]) < 1.0).all()


def test_condense_snapshot_and_death():
    n = 4
    slr = jnp.arange(n * 2 * 4, dtype=jnp.float64).reshape(n, 2, 4) + 1
    final = jnp.zeros_like(slr)
    tau = jnp.asarray([5.0, 0.05, 5.0, 5.0])
    alive = jnp.asarray([True, True, False, True])
    lm = jnp.asarray([True, True, True, False])
    final2, alive2 = dep.condense(slr, final, True, tau, alive, lm,
                                  jnp.asarray(0.1))
    # star 0: alive, tau >= t -> snapshot
    np.testing.assert_allclose(np.asarray(final2[0]), np.asarray(slr[0]))
    # star 1: tau < t -> dies, no snapshot
    assert not bool(alive2[1])
    np.testing.assert_allclose(np.asarray(final2[1]), 0.0)
    # star 2: already dead -> untouched
    np.testing.assert_allclose(np.asarray(final2[2]), 0.0)
    # star 3: not low-mass -> untouched
    np.testing.assert_allclose(np.asarray(final2[3]), 0.0)
    assert bool(alive2[0]) and bool(alive2[3])


def test_sn_injection_padded_slots_do_not_double_count():
    """A padded (duplicated-index) slot with hm_slot_valid=False must not
    inject a second copy of star 0's yield — the ensemble-padding case."""
    rng = np.random.default_rng(5)
    x, v, mass, hm_id, lm_id, mdot, ratio, r_disk = _random_system(rng)
    # make slot list [hm..., 0(pad)] with star hm_id[0] exploding
    mdot[hm_id[0]] = 0.0
    kicked = np.zeros(len(x), bool)
    sn_yield = np.zeros((len(x), 2))
    sn_yield[hm_id] = 1e-5
    idx_clean = jnp.asarray(hm_id, jnp.int32)
    idx_padded = jnp.asarray(list(hm_id) + [hm_id[0]], jnp.int32)
    valid_padded = jnp.asarray([True] * len(hm_id) + [False])
    a1, _ = dep.sn_injection(
        jnp.asarray(x), jnp.asarray(r_disk),
        jnp.asarray((mass >= 0.1) & (mass <= 3.0)),
        idx_clean, jnp.ones(len(hm_id), bool),
        jnp.asarray(mdot), jnp.asarray(kicked), jnp.asarray(sn_yield))
    a2, _ = dep.sn_injection(
        jnp.asarray(x), jnp.asarray(r_disk),
        jnp.asarray((mass >= 0.1) & (mass <= 3.0)),
        idx_padded, valid_padded,
        jnp.asarray(mdot), jnp.asarray(kicked), jnp.asarray(sn_yield))
    np.testing.assert_allclose(np.asarray(a2), np.asarray(a1), rtol=1e-14)
