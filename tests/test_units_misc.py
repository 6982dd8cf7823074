"""Unit-layer and misc helper tests."""
import numpy as np
import pytest

from al26 import units as u


def test_unit_conversions():
    q = u.Quantity(1.0, u.pc)
    assert q.value_in(u.km) == pytest.approx(3.0856775814913673e13)
    v = u.Quantity(1.0, u.pcmyr)
    assert v.value_in(u.kms) == pytest.approx(u.PCMYR_TO_KMS)
    m = u.Quantity(2.0, u.msol)
    assert m.value_in(u.kg) == pytest.approx(2 * u.MSUN_SI)
    t = u.Quantity(1.0, u.myr)
    assert t.value_in(u.yr) == pytest.approx(1e6)


def test_quantity_arithmetic_and_ratio():
    a = u.Quantity(np.array([2.0, 4.0]), u.msol)
    b = u.Quantity(np.array([1.0, 2.0]), u.msol)
    np.testing.assert_allclose((a + b).value_in(u.msol), [3.0, 6.0])
    np.testing.assert_allclose((a - b).value_in(u.msol), [1.0, 2.0])
    # same-dimension division -> dimensionless ndarray (the postprocess
    # ratio pattern, plot_slr_statistics.py:43)
    ratio = a / b
    np.testing.assert_allclose(ratio, [2.0, 2.0])
    with pytest.raises(ValueError):
        a.value_in(u.pc)


def test_g_internal_value():
    # G = 4.498e-3 pc^3 / (Msun Myr^2) to ~0.1%
    assert u.G_INTERNAL == pytest.approx(4.4985e-3, rel=2e-3)


def test_min_intercept_time():
    import jax.numpy as jnp

    from al26.ops.nbody import min_intercept_time

    pos = jnp.asarray([[0.0, 0, 0], [1.0, 0, 0], [0.0, 3, 0]])
    vel = jnp.asarray([[2.0, 0, 0], [0.0, 0, 0], [1.0, 0, 0]])
    lm = jnp.asarray([True, False, True])
    hm = jnp.asarray([False, True, False])
    # lm star 0 at d=1 with speed 2 -> 0.5; lm star 2 at d=sqrt(10), speed 1
    t = float(min_intercept_time(pos, vel, lm, hm))
    assert t == pytest.approx(0.5)


def test_determinism_same_seed():
    """Two identical runs produce identical state (deterministic RNG +
    deterministic reductions; SURVEY.md §7 hard part 2)."""
    import numpy as np

    from al26.config import SimConfig
    from al26.sim import init_cluster, run_steps

    cfg = SimConfig(n=48, rc=0.5, final_time=1.0, seed=77)
    s1, a1, c1 = init_cluster(cfg)
    s2, a2, c2 = init_cluster(cfg)
    o1 = run_steps(s1, a1, c1, 25)
    o2 = run_steps(s2, a2, c2, 25)
    np.testing.assert_array_equal(np.asarray(o1.cluster.pos),
                                  np.asarray(o2.cluster.pos))
    np.testing.assert_array_equal(np.asarray(o1.cluster.slr),
                                  np.asarray(o2.cluster.slr))


def test_state_validation_catches_corruption():
    import numpy as np
    import pytest as _pytest

    from al26.config import SimConfig
    from al26.sim import init_cluster
    from al26.state import cluster_to_numpy
    from al26.utils.validate import StateValidationError, validate_cluster_dict

    cfg = SimConfig(n=16, rc=1.0, seed=1, no_massive_star_requirement=True)
    state, _, _ = init_cluster(cfg)
    d = cluster_to_numpy(state.cluster)
    validate_cluster_dict(d, 0.0)  # clean state passes

    bad = {k: v.copy() for k, v in d.items()}
    bad["pos"][3, 1] = np.nan
    with _pytest.raises(StateValidationError, match="pos.*non-finite"):
        validate_cluster_dict(bad, 1.0)

    bad2 = {k: v.copy() for k, v in d.items()}
    bad2["mass"][0] = -1.0
    with _pytest.raises(StateValidationError, match="negative stellar mass"):
        validate_cluster_dict(bad2, 1.0)


def test_phase_timers_accumulate_and_report():
    """utils/timing.py: the structured replacement for the reference's
    manual time.time() brackets (al26_nbody.py:764-1109) — totals/counts
    accumulate per phase and the report sorts by total."""
    import time

    from al26.utils.timing import PhaseTimers

    tm = PhaseTimers()
    for _ in range(3):
        with tm.phase("physics"):
            time.sleep(0.002)
    with tm.phase("checkpoint"):
        time.sleep(0.02)
    try:
        with tm.phase("failing"):
            raise ValueError("boom")
    except ValueError:
        pass  # the finally path must still record the phase
    assert tm.counts["physics"] == 3
    assert tm.counts["failing"] == 1
    assert tm.totals["checkpoint"] >= 0.02
    assert tm.last["physics"] <= tm.totals["physics"]
    rep = tm.report()
    # sorted by descending total — assert against the MEASURED totals, not
    # the intended sleep ratios (scheduler latency on a loaded box can
    # inflate the 2 ms sleeps past the 20 ms one)
    order = sorted(tm.totals, key=lambda k: -tm.totals[k])
    assert rep.index(order[0]) < rep.index(order[-1])
    assert "x3" in rep


def test_array_or_unit_builds_one_quantity():
    """numpy must defer on `ndarray | unit` (Unit.__array_ufunc__ = None)
    so the AMUSE construction syntax returns ONE Quantity holding the
    array — the reference does exactly `calc_wind_abs(...) | units.kg`
    then `.value_in(msol)` (al26_plot.py:533,540); an object ndarray of
    per-element Quantities would crash that path."""
    import numpy as np

    from al26 import units as u

    q = np.array([1.0, 2.0, 3.0]) | u.kg
    assert isinstance(q, u.Quantity)
    np.testing.assert_array_equal(q.value_in(u.kg), [1.0, 2.0, 3.0])
    np.testing.assert_allclose((np.ones(2) | u.msol).value_in(u.kg),
                               u.MSUN_SI)
    # scalar construction unchanged
    assert (0.5 | u.myr).value_in(u.myr) == 0.5
