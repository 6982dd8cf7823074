"""Loading REFERENCE-written (AMUSE-pickle) state files without AMUSE.

The fixture (tests/amuse_fixture.py) replicates the real AMUSE object
graph — Particles -> _private -> InMemoryAttributeStorage ->
InMemoryVectorQuantityAttribute -> VectorQuantity -> units.core expression
trees — pickled under the genuine `amuse.*` module paths, which are NOT
importable here. Everything below therefore exercises the tolerant
unpickler + graph miner (al26.io.compat) end to end:
load_state payloads, a resumed simulation, and plotting/postprocess.
"""
import os
import pickle

import numpy as np
import pytest

from al26.config import SimConfig
from al26.io import checkpoint as ckpt
from al26.io.compat import cluster_to_particles
from al26.io.compression import compress
from al26.io.yields_store import Yields
from al26.sim import init_cluster
from al26.state import cluster_to_numpy
from amuse_fixture import build_state_pickle

N_FIX = 12


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    """A pt-grid sim directory whose state files are AMUSE-format pickles
    and whose yields/CSV files come from the normal store."""
    root = tmp_path_factory.mktemp("refgrid")
    sim_dir = root / f"pt-1.0-{N_FIX}" / f"pt-1.0-{N_FIX}" / "pt-0"
    sim_dir.mkdir(parents=True)
    cfg = SimConfig(n=N_FIX, rc=1.0, final_time=10.0, seed=42, dtype="f64",
                    no_massive_star_requirement=True)
    state, aux, cfg = init_cluster(cfg, as_numpy=True)
    cols = cluster_to_particles(cluster_to_numpy(state.cluster)).columns()

    base = str(sim_dir / "pt-0")
    yields = Yields(base)  # a bare "pt-0" would drop the CSV in the cwd
    # 4 checkpoints so the disc-lifetime Akima interpolation has a history
    for k, t in enumerate([0.0, 3.0, 7.0, 10.0]):
        particles = cluster_to_particles(cluster_to_numpy(state.cluster))
        yields.update_state(t, particles)
        blob = build_state_pickle(cols, N_FIX, 1.0, t, 10.0, "pt-0")
        with open(f"{base}-state-{str(k).zfill(5)}.pkl.zst", "wb") as f:
            f.write(compress(blob))
    yields.marinate(f"{base}-yields.ubj.zst")
    return root, sim_dir, cols, cfg


def test_fixture_requires_tolerant_loading(fixture_dir):
    """The fixture genuinely embeds amuse.* class paths: plain pickle.loads
    must fail with ModuleNotFoundError, as a real reference file would."""
    _, sim_dir, _, _ = fixture_dir
    from al26.io.compression import decompress

    with open(str(sim_dir / "pt-0-state-00000.pkl.zst"), "rb") as f:
        data = decompress(f.read())
    with pytest.raises(ModuleNotFoundError):
        pickle.loads(data)


def test_load_state_mines_the_amuse_graph(fixture_dir):
    """load_state on an AMUSE pickle returns a WORKING Particles table with
    values converted from the stored units (SI positions, MSun masses,
    MSun/yr mdot) back to canonical columns."""
    from al26.units import msol, myr, pc

    _, sim_dir, cols, _ = fixture_dir
    st = ckpt.load_state(str(sim_dir / "pt-0-state-00003.pkl.zst"))
    p = st.cluster
    assert len(p) == N_FIX
    np.testing.assert_allclose(p.mass.value_in(msol), cols["mass"],
                               rtol=1e-13)
    np.testing.assert_allclose(p.x.value_in(pc), cols["x"], rtol=1e-13)
    np.testing.assert_allclose(p.tau_disk.value_in(myr), cols["tau_disk"],
                               rtol=1e-13)
    np.testing.assert_allclose(
        np.asarray(p.mass_26al_local.value_in(msol)),
        cols["mass_26al_local"], rtol=1e-13,
    )
    # unitless attributes survive as raw arrays
    np.testing.assert_array_equal(np.asarray(p.disk_alive),
                                  cols["disk_alive"])
    # metadata quantities were re-tagged: the resume path's access pattern
    assert float(st.metadata.time.value_in(myr)) == 10.0
    assert st.metadata.args.n == N_FIX


def test_resume_from_reference_checkpoint(fixture_dir):
    """load_run + one stepped chunk from an AMUSE-format checkpoint: the
    full resume path (al26_nbody.py:1647-1656) on a reference file."""
    from al26.sim.driver import load_run
    from al26.sim.step import run_steps

    _, sim_dir, cols, _ = fixture_dir
    state, aux, cfg, metadata, yields, converter = load_run(
        str(sim_dir / "pt-0"), n_checkpoint=2
    )
    assert float(state.time) == 7.0
    np.testing.assert_allclose(np.asarray(state.cluster.mass),
                               cols["mass"], rtol=1e-12)
    # the stub converter was rebuilt into a picklable one
    pickle.dumps(converter)
    out = run_steps(state, aux, cfg, 2)
    assert np.isfinite(np.asarray(out.cluster.pos)).all()
    assert float(out.time) > 7.0


def test_postprocess_runs_on_reference_files(fixture_dir):
    """plotting/postprocess over a grid directory of AMUSE-format states
    (the reference's own post-processing workflow, postprocess.py:59-67)."""
    import pandas as pd

    from al26.plotting import postprocess

    root, _, cols, _ = fixture_dir
    out = str(root / "all-sims-ratios.pkl.zst")
    postprocess.main(str(root), out)
    df = pd.read_pickle(out)
    # 12 stars x 2 isotopes x 5 models
    assert len(df) == N_FIX * 2 * 5
    assert set(df["model"]) == {"local", "global", "sne", "local+sne",
                                "global+sne"}
    assert (df["nstars"] == N_FIX).all()
    np.testing.assert_allclose(
        df[df["star"] == 0]["mass"].iloc[0], cols["mass"][0], rtol=1e-12
    )
    assert np.isfinite(df["yield_ratio_nodecay"]).all()


def test_checked_in_reference_state_loads():
    """The byte-FROZEN AMUSE-format state pickle checked into
    tests/golden/amuse/ (scripts/gen_amuse_fixture.py; VERDICT r4 item 5)
    loads end-to-end through plotting.read_state: genuine amuse.* module
    paths, random uint64 particle keys, sorted-key storage ancillaries,
    SI-stored positions and a real converter payload — bytes that cannot
    co-drift with the in-process fixture builder."""
    from al26.plotting.lib import read_state

    path = os.path.join(os.path.dirname(__file__), "golden", "amuse",
                        "pt-0-state-00003.pkl.zst")
    state = read_state(path)
    cluster = state.cluster
    n = 24

    # expected values: the same deterministic recipe the generator used
    cfg = SimConfig(n=n, rc=1.0, final_time=10.0, seed=20260501,
                    dtype="f64", no_massive_star_requirement=True)
    ref, _, _ = init_cluster(cfg, as_numpy=True)
    rng = np.random.default_rng(20260501)
    expect_slr = {}
    ref_cols = cluster_to_particles(cluster_to_numpy(ref.cluster)).columns()
    for name in ref_cols:
        if name.startswith(("mass_26al", "mass_60fe")):
            expect_slr[name] = rng.uniform(1e-12, 1e-8, n)

    from al26.units import msol, myr, pc

    np.testing.assert_allclose(cluster.x.value_in(pc),
                               ref_cols["x"], rtol=1e-12)
    np.testing.assert_allclose(cluster.vy.value_in(pc / myr),
                               ref_cols["vy"], rtol=1e-12)
    np.testing.assert_allclose(cluster.mass.value_in(msol),
                               ref_cols["mass"], rtol=1e-12)
    np.testing.assert_allclose(cluster.tau_disk.value_in(myr),
                               ref_cols["tau_disk"], rtol=1e-12)
    for name, v in expect_slr.items():
        np.testing.assert_allclose(
            np.asarray(getattr(cluster, name).value_in(msol)), v,
            rtol=1e-12, err_msg=name)
    # metadata round-trips with units re-tagged
    from al26.units import myr

    assert abs(float(state.metadata.time.value_in(myr)) - 3.0) < 1e-12
    assert state.metadata.args.n == n
    # keys are the AMUSE-style random uint64 draw, preserved verbatim
    key = np.asarray(cluster.key)
    assert key.dtype == np.uint64 and len(np.unique(key)) == n
