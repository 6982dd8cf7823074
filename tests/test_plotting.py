"""Post-processing / plotting pipeline tests against real run output
(SURVEY.md §4: the north star is that the ensemble postprocessor consumes
our files unchanged)."""
import os
from glob import glob

import numpy as np
import pytest

from al26.config import SimConfig
from al26.sim.driver import run


@pytest.fixture(scope="module")
def sim_grid(tmp_path_factory):
    """A miniature pt-<rc>-<n> grid of two sims, reference folder layout."""
    root = tmp_path_factory.mktemp("grid")
    for sim_i in range(2):
        d = root / "pt-0.5-48" / "pt-0.5-48" / f"pt-{sim_i}"
        d.mkdir(parents=True)
        cwd = os.getcwd()
        os.chdir(d)
        try:
            cfg = SimConfig(n=48, rc=0.5, final_time=1.0, seed=31 + sim_i,
                            filename=f"pt-{sim_i}", n_plot=5, steps_per_plot=4)
            run(cfg, progress=False)
        finally:
            os.chdir(cwd)
    return root


def test_readers(sim_grid):
    from al26.plotting import read_state, read_yields
    from al26.units import msol, myr

    sim = sorted(glob(str(sim_grid) + "/pt-*/pt-*/pt-0/"))[0]
    states = sorted(glob(sim + "*-state-*.zst"))
    state = read_state(states[-1])
    assert len(state.cluster) == 48
    y = read_yields(sorted(glob(sim + "*yields*.zst"))[-1])
    assert isinstance(y.local_26al, np.ndarray)
    assert y.local_26al.shape == (7, 48)
    assert y.time[-1] == pytest.approx(1.0)


def test_disk_final_enrichment(sim_grid):
    from al26.plotting import calc_disk_final_enrichment, read_state, read_yields
    from al26.units import myr

    sim = sorted(glob(str(sim_grid) + "/pt-*/pt-*/pt-0/"))[0]
    state = read_state(sorted(glob(sim + "*-state-*.zst"))[-1])
    y = read_yields(sorted(glob(sim + "*yields*.zst"))[-1])
    taus = np.asarray(state.cluster.tau_disk.value_in(myr))
    y = calc_disk_final_enrichment(y, taus)
    for key in ("global_26al_final", "local_60fe_final", "sne_26al_final"):
        vals = np.asarray(getattr(y, key))
        assert vals.shape == (48,)
        assert np.isfinite(vals).all()


def test_postprocess_pipeline(sim_grid, tmp_path):
    """The full ensemble postprocessor over the mini-grid -> tidy table."""
    import pandas as pd

    from al26.plotting import postprocess

    out = str(tmp_path / "all-sims-ratios.pkl.zst")
    cwd = os.getcwd()
    os.chdir(sim_grid)
    try:
        postprocess.main(".", out)
    finally:
        os.chdir(cwd)
    df = pd.read_pickle(out)
    # 2 sims x 48 stars x 2 isotopes x 5 models
    assert len(df) == 2 * 48 * 2 * 5
    assert set(df.model.unique()) == {
        "local", "global", "sne", "local+sne", "global+sne"}
    assert set(df.isotope.unique()) == {"26al", "60fe"}
    assert (df.nstars == 48).all()
    assert (df.rc == 0.5).all()
    assert np.isfinite(df.yield_ratio_decay).all()
    # combined model == sum of parts
    one = df[(df.sim_number == 0) & (df.star == 0) & (df.isotope == "26al")]
    combined = float(one[one.model == "local+sne"].yield_ratio_nodecay.iloc[0])
    parts = (float(one[one.model == "local"].yield_ratio_nodecay.iloc[0])
             + float(one[one.model == "sne"].yield_ratio_nodecay.iloc[0]))
    assert combined == pytest.approx(parts)


def test_sn_times(sim_grid):
    from al26.plotting import calc_sn_times, read_state

    sim = sorted(glob(str(sim_grid) + "/pt-*/pt-*/pt-0/"))[0]
    state = read_state(sorted(glob(sim + "*-state-*.zst"))[0])
    times, masses = calc_sn_times(state.cluster)
    assert len(times) == len(masses)
    if times:
        assert all(2.0 < t < 45.0 for t in times)
        assert masses == sorted(masses, reverse=True)


def test_energy_and_density_diagnostics(sim_grid):
    from al26.plotting import (
        calc_cluster_half_mass, calc_dE, calc_etot, calc_local_densities,
        read_state,
    )

    sim = sorted(glob(str(sim_grid) + "/pt-*/pt-*/pt-0/"))[0]
    states = sorted(glob(sim + "*-state-*.zst"))
    s0, s1 = read_state(states[0]), read_state(states[-1])
    e0, e1 = calc_etot(s0), calc_etot(s1)
    assert np.isfinite(e0) and np.isfinite(e1)
    assert abs(calc_dE(e0, e1)) < 0.5
    rho = calc_local_densities(s0.cluster)
    assert rho.shape == (48,) and (rho > 0).all()
    rh = calc_cluster_half_mass(s0.cluster)
    assert 0.1 < rh < 2.0


def test_figure_scripts_produce_output(sim_grid, tmp_path):
    """The paper-figure scripts run end-to-end on real sim output."""
    matplotlib = pytest.importorskip("matplotlib")
    from al26.plotting import plot_slr_statistics, plot_slr_heating
    from al26.plotting import plot_3d_pos, postprocess, box_plot, violin_plot

    simdir = sorted(glob(str(sim_grid) + "/pt-*/pt-*/"))[0]
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        plot_slr_statistics.main("cdf", simdir)
        assert os.path.exists("cdf.pdf")
        plot_slr_heating.main("heat", simdir)
        assert os.path.exists("heat.pdf")
        state_file = sorted(glob(simdir + "pt-0/*-state-*.zst"))[-1]
        plot_3d_pos.main(state_file, "pos")
        assert os.path.exists("pos.png")
        os.chdir(sim_grid)
        postprocess.main(".", str(tmp_path / "table.pkl.zst"))
        os.chdir(tmp_path)
        box_plot.main("table.pkl.zst", "boxes")
        assert os.path.exists("boxes.pdf")
        violin_plot.main("table.pkl.zst", "violins")
        assert os.path.exists("violins.pdf")
    finally:
        os.chdir(cwd)


def test_ensemble_driver_grid_layout(tmp_path):
    """run_ensemble writes the reference grid layout and the postprocessor
    consumes it end-to-end."""
    import pandas as pd

    from al26.plotting import postprocess
    from al26.sim.driver import run_ensemble

    cfg = SimConfig(n=24, rc=0.5, final_time=0.5, seed=50, ensemble=2,
                    n_plot=2, steps_per_plot=5,
                    no_massive_star_requirement=True)
    _, sim_dirs, _ = run_ensemble(cfg, progress=False, root=str(tmp_path))
    assert sim_dirs[0].endswith("pt-0.5-24/pt-0.5-24/pt-0")
    files = os.listdir(sim_dirs[0])
    assert any("-state-00000" in f for f in files)
    assert any(f.endswith("-yields.ubj.zst") for f in files)
    out = str(tmp_path / "table.pkl.zst")
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        postprocess.main(".", out)
    finally:
        os.chdir(cwd)
    df = pd.read_pickle(out)
    assert len(df) == 2 * 24 * 2 * 5
    assert set(df.sim_number.unique()) == {0, 1}


def test_disk_final_enrichment_matches_perstar_scipy(sim_grid):
    """The vectorized one-Akima-per-series evaluation equals the per-star
    scipy construction the function previously ran (6*N interpolators) —
    including the out-of-range and disc-outlives-run fallbacks."""
    from glob import glob

    from scipy.interpolate import Akima1DInterpolator

    from al26.plotting import calc_disk_final_enrichment, read_state, read_yields
    from al26.units import myr

    sim = sorted(glob(str(sim_grid) + "/pt-*/pt-*/pt-0/"))[0]
    state = read_state(sorted(glob(sim + "*-state-*.zst"))[-1])
    y = read_yields(sorted(glob(sim + "*yields*.zst"))[-1])
    taus = np.asarray(state.cluster.tau_disk.value_in(myr)).copy()
    # force every fallback class: outlives-run, before-first-snapshot
    taus[0] = 1e9
    taus[1] = -1.0
    t = np.asarray(y.time)
    expected = {}
    for iso in ("26al", "60fe"):
        for model in ("global", "local", "sne"):
            key = f"{model}_{iso}"
            arr = np.asarray(getattr(y, key))
            fy = []
            for i in range(len(taus)):
                val = float(Akima1DInterpolator(t, arr[:, i])(float(taus[i])))
                if np.isnan(val) or taus[i] >= t[-1]:
                    val = arr[-1, i]
                fy.append(val)
            expected[key + "_final"] = np.asarray(fy)
    y = calc_disk_final_enrichment(y, taus)
    for key, exp in expected.items():
        np.testing.assert_allclose(np.asarray(getattr(y, key)), exp,
                                   rtol=1e-12, atol=1e-300)
