"""Persistence-layer tests: UBJSON codec, compression, yields store,
checkpoint round-trip, reference-file compatibility (SURVEY.md §4f)."""
import os
import pickle
import struct

import numpy as np
import pytest

from al26.io import ubjson
from al26.io.compression import compress, decompress


# ---------------------------------------------------------------------------
# UBJSON
# ---------------------------------------------------------------------------
def test_ubjson_scalar_roundtrip():
    for v in [None, True, False, 0, 1, -1, 127, 128, -129, 2**15, 2**40,
              0.0, 1.5, -2.25e-12, "hello", "ünïcødé", ""]:
        assert ubjson.loadb(ubjson.dumpb(v)) == v


def test_ubjson_container_roundtrip():
    obj = {
        "time": [0.0, 0.01, 0.02],
        "names": ["a", "b"],
        "nested": [[1.0, 2.0], [3.0, 4.0]],
        "mixed": [1, "x", None, True, 2.5],
        "flag": True,
        "n": 1000,
        "empty": [],
        "emptydict": {},
    }
    assert ubjson.loadb(ubjson.dumpb(obj)) == obj
    # unoptimized form too
    assert ubjson.loadb(ubjson.dumpb(obj, optimized=False)) == obj


def test_ubjson_typed_array_wire_format():
    """Optimized float lists use the [$D# typed-array form with big-endian
    payload (readable by py-ubjson)."""
    data = ubjson.dumpb([1.0, 2.0])
    assert data.startswith(b"[$D#")
    # count as an int8/uint8 marker + 2, then two big-endian doubles
    assert data[4:5] in (b"i", b"U") and data[5] == 2
    assert struct.unpack(">2d", data[6:]) == (1.0, 2.0)


def test_ubjson_reads_plain_py_ubjson_form():
    """Hand-built unoptimized stream as py-ubjson's default emits it:
    {'t': [D 1.0 D 2.0], 's': S...}."""
    stream = (
        b"{"
        b"U\x01t" b"[" + b"D" + struct.pack(">d", 1.0) + b"D" + struct.pack(">d", 2.0) + b"]"
        b"U\x01s" b"S" b"U\x02" b"ok"
        b"U\x01n" b"l" + struct.pack(">i", 70000) +
        b"}"
    )
    assert ubjson.loadb(stream) == {"t": [1.0, 2.0], "s": "ok", "n": 70000}


def test_ubjson_numpy_arrays():
    a = np.arange(6, dtype=np.float64).reshape(2, 3)
    out = ubjson.loadb(ubjson.dumpb(a))
    assert out == [[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]]


def test_ubjson_large_payload_fast():
    """1000 x 1000 float payload encodes+decodes in linear-ish time (the
    reference's selling point for ubjson: ~0.2 s vs 5.3 s pickle,
    al26_nbody.py:250). This guards against an accidental quadratic codec
    (repeated bytes-concatenation etc.), which would take minutes — NOT an
    absolute-speed contract: the pure-Python decode is legitimately ~5 s
    on a 1-CPU box when the optional C++ accelerator isn't built, and
    wall-clock bounds flake under co-located load, so measure CPU time of
    THIS process with a bound well clear of the honest cost."""
    import time
    payload = {"series": [list(np.random.default_rng(0).uniform(size=1000))
                          for _ in range(1000)]}
    t0 = time.process_time()
    data = ubjson.dumpb(payload)
    enc = time.process_time() - t0
    t0 = time.process_time()
    back = ubjson.loadb(data)
    dec = time.process_time() - t0
    assert back["series"][500] == payload["series"][500]
    assert enc < 20.0 and dec < 20.0, (enc, dec)


def test_compression_roundtrip():
    blob = os.urandom(1000) + b"compressible" * 1000
    assert decompress(compress(blob)) == blob


# ---------------------------------------------------------------------------
# Yields store
# ---------------------------------------------------------------------------
def _small_run(tmp_path, n=48, seed=21, t_f=1.0, **kw):
    from al26.config import SimConfig
    from al26.sim.driver import run

    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        cfg = SimConfig(n=n, rc=0.5, final_time=t_f, seed=seed,
                        filename="testrun", n_plot=5, steps_per_plot=4,
                        **kw)
        return run(cfg, progress=False)
    finally:
        os.chdir(cwd)


def test_yields_files_and_csv_format(tmp_path):
    res = _small_run(tmp_path)
    base = os.path.join(tmp_path, "testrun")
    # 0 + 5 saves + final
    states = sorted(os.listdir(tmp_path))
    state_files = [f for f in states if "-state-" in f]
    assert state_files[0] == "testrun-state-00000.pkl.zst"
    assert len(state_files) == 7
    assert os.path.exists(base + "-yields.ubj.zst")
    csv = open(base + "-cluster-yields.csv").read().strip().splitlines()
    assert csv[0] == ("time,local_26al,global_26al,sne_26al,"
                      "local_60fe,global_60fe,sne_60fe")
    assert len(csv) == 1 + 7
    # rows are 7 scientific-notation floats
    row = csv[-1].split(",")
    assert len(row) == 7
    assert float(row[0]) == pytest.approx(1.0)


def test_yields_roundtrip(tmp_path):
    from al26.io.yields_store import Yields

    res = _small_run(tmp_path)
    y = Yields("reload")
    y.plate(os.path.join(tmp_path, "testrun-yields.ubj.zst"))
    assert len(y.time) == 7  # initial + 5 cadence saves + final
    assert y.time[-1] == pytest.approx(1.0)
    n_total = res.state.cluster.n
    assert len(y.local_26al[-1]) == n_total
    # sums consistent with per-star lists
    assert sum(y.local_26al[-1]) == pytest.approx(y.sum_local_26al[-1])


def test_checkpoint_roundtrip_state(tmp_path):
    from al26.io.checkpoint import load_state, most_recent_checkpoint
    from al26.units import msol, myr, pc

    res = _small_run(tmp_path)
    base = os.path.join(tmp_path, "testrun")
    n = most_recent_checkpoint(base)
    assert n == 6
    state = load_state(f"{base}-state-{n:05d}.pkl.zst")
    # postprocess.py access patterns
    assert state.metadata.args.n == 48
    assert state.metadata.args.rc == 0.5
    taus = state.cluster.tau_disk.value_in(myr)
    assert len(taus) == 48
    masses = state.cluster.mass.value_in(msol)
    np.testing.assert_allclose(masses, np.asarray(res.state.cluster.mass))
    ratio = state.cluster.mass_26al_local / state.cluster.mass_27al
    assert np.isfinite(ratio).all()
    # iteration like postprocess.py:90
    star0 = next(iter(state.cluster))
    assert star0.mass.value_in(msol) == pytest.approx(masses[0])


def test_resume_continues_identically(tmp_path):
    """Resume mid-run must reproduce the uninterrupted trajectory
    (al26_nbody.py:1647-1656 reload path)."""
    from al26.config import SimConfig
    from al26.sim.driver import run

    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        cfg = SimConfig(n=32, rc=0.5, final_time=1.0, seed=9,
                        filename="full", n_plot=5, steps_per_plot=4)
        full = run(cfg, progress=False)

        # rerun to checkpoint 3 only, then resume
        cfg2 = cfg.replace(filename="part", final_time=1.0)
        from al26.sim import init_cluster, run_steps
        state, aux, cfg2 = init_cluster(cfg2)
        # drive to 12 steps (checkpoint cadence 4) via driver on a shorter
        # horizon: simpler — run the full driver, then reload from an
        # EARLIER checkpoint and continue
        part = run(cfg2, progress=False)
        resumed = run(SimConfig(reload="part", n_checkpoint=3),
                      progress=False)
        np.testing.assert_allclose(
            np.asarray(resumed.state.cluster.pos),
            np.asarray(full.state.cluster.pos), rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(
            np.asarray(resumed.state.cluster.slr),
            np.asarray(full.state.cluster.slr), rtol=1e-8, atol=1e-30)
    finally:
        os.chdir(cwd)


def test_resume_from_checkpoint_pickled_under_earlier_package_name(tmp_path):
    """State files written before the package took the name `al26` name
    their classes `al26_<suffix>.<module>`; they load as this package's
    classes and the run resumes as if uninterrupted."""
    import glob

    from al26.config import SimConfig
    from al26.io.checkpoint import load_state
    from al26.io.compat import Particles, State, renamed_module
    from al26.sim.driver import run

    assert renamed_module("al26_old.io.compat") == "al26.io.compat"
    assert renamed_module("al26_nbody") == "al26_nbody"
    assert renamed_module("amuse.units.core") == "amuse.units.core"
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        cfg = SimConfig(n=32, rc=0.5, final_time=1.0, seed=9,
                        filename="old", n_plot=5, steps_per_plot=4)
        full = run(cfg, progress=False)
        for path in glob.glob("old-state-*.pkl.zst"):
            with open(path, "rb") as f:
                state = pickle.loads(decompress(f.read()))
            # protocol 2 names classes as text (GLOBAL: c<module>\n<name>\n)
            raw = pickle.dumps(state, protocol=2)
            assert b"cal26.io.compat\n" in raw
            raw = raw.replace(b"cal26.", b"cal26_old.")
            with pytest.raises(ModuleNotFoundError):
                pickle.loads(raw)
            with open(path, "wb") as f:
                f.write(compress(raw))
        state = load_state("old-state-00003.pkl.zst")
        assert type(state) is State and type(state.cluster) is Particles
        resumed = run(SimConfig(reload="old", n_checkpoint=3),
                      progress=False)
        np.testing.assert_allclose(
            np.asarray(resumed.state.cluster.pos),
            np.asarray(full.state.cluster.pos), rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(
            np.asarray(resumed.state.cluster.slr),
            np.asarray(full.state.cluster.slr), rtol=1e-8, atol=1e-30)
    finally:
        os.chdir(cwd)


# slow lane (round-5 re-tier): run-extension end-to-end (5 driver runs; the extended_to schedule algebra stays default in test_extended_to_*, resume itself in test_resume_continues_identically)
@pytest.mark.slow
def test_resume_extends_final_time(tmp_path):
    """`-r X -t_f T` extends a finished run (the reference re-reads -t_f
    from the fresh invocation on reload, al26_nbody.py:1638,786). Ours
    keeps the ORIGINAL dt and snaps T to the save grid
    (SimConfig.extended_to), so the extension bit-matches an
    uninterrupted run on the same grid; the extended schedule is written
    into the stored args so the NEXT resume continues it."""
    import pytest

    from al26.config import SimConfig
    from al26.sim.driver import run

    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        # original: 1.0 Myr on dt = 1.0/(5*4) = 0.05; uninterrupted
        # comparator: 2.0 Myr on the SAME grid (n_plot doubled)
        cfg = SimConfig(n=32, rc=0.5, final_time=1.0, seed=9,
                        filename="short", n_plot=5, steps_per_plot=4)
        run(cfg, progress=False)
        full = run(cfg.replace(filename="long", final_time=2.0, n_plot=10),
                   progress=False)

        # 1.93 snaps to the nearest whole save interval (0.2) -> 2.0
        res = run(SimConfig(reload="short", extend_final_time=1.93),
                  progress=False)
        assert res.cfg.final_time == pytest.approx(2.0)
        assert res.cfg.dt == pytest.approx(0.05)
        assert float(res.state.time) == pytest.approx(2.0)
        np.testing.assert_allclose(
            np.asarray(res.state.cluster.pos),
            np.asarray(full.state.cluster.pos), rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(
            np.asarray(res.state.cluster.slr),
            np.asarray(full.state.cluster.slr), rtol=1e-8, atol=1e-30)

        # the stored schedule now IS the extended one: a plain resume
        # from an interior checkpoint runs on to 2.0 Myr
        res2 = run(SimConfig(reload="short", n_checkpoint=7),
                   progress=False)
        assert res2.cfg.final_time == pytest.approx(2.0)
        assert float(res2.state.time) == pytest.approx(2.0)

        # a one-shot directive: the extended run's own cfg doesn't carry it
        assert res.cfg.extend_final_time is None

        # extension without reload fails loudly
        with pytest.raises(ValueError, match="resume directive"):
            run(SimConfig(n=8, extend_final_time=2.0), progress=False)

        # a target at/behind the resumed time is NOT a silent no-op:
        # truncation is the -nc path's job
        with pytest.raises(ValueError, match="does not extend"):
            run(SimConfig(reload="short", extend_final_time=1.0),
                progress=False)

        # NON-dyadic schedules keep the stored dt BIT-exactly across an
        # extension (dt_override; recomputing final_time/(n_plot*spp)
        # drifts by an ulp for grids like 0.7/20)
        cfg_nd = SimConfig(n=16, rc=0.5, final_time=0.7, seed=3,
                           filename="nd", n_plot=5, steps_per_plot=4,
                           no_massive_star_requirement=True)
        run(cfg_nd, progress=False)
        res_nd = run(SimConfig(reload="nd", extend_final_time=1.0),
                     progress=False)
        assert res_nd.cfg.dt == cfg_nd.dt  # bitwise, no approx
        assert res_nd.cfg.n_plot == 7
        # and the NEXT resume restores the same grid from the stored args
        from al26.sim.driver import load_run
        _, _, cfg_nd2, _, _, _ = load_run("nd")
        assert cfg_nd2.dt == cfg_nd.dt

        # -v follows the INVOCATION on reload, like the reference (whose
        # prints gate on the current argparse namespace), not the stored
        # run's flag
        res3 = run(SimConfig(reload="short", n_checkpoint=9,
                             verbose=True), progress=False)
        assert res3.cfg.verbose is True
    finally:
        os.chdir(cwd)


def test_cli_maps_t_f_to_extension_on_reload():
    """config_from_args: an explicit -t_f alongside -r becomes
    extend_final_time; a bare -r continues the stored schedule (no
    silent re-default to 10 Myr); cold starts default to 10."""
    from al26.cli import build_parser, config_from_args

    p = build_parser()
    cfg = config_from_args(p.parse_args(["-r", "x", "-t_f", "20"]))
    assert cfg.extend_final_time == 20.0
    cfg = config_from_args(p.parse_args(["-r", "x"]))
    assert cfg.extend_final_time is None
    cfg = config_from_args(p.parse_args(["-n", "8", "-rc", "1.0"]))
    assert cfg.final_time == 10.0 and cfg.extend_final_time is None


class _RefLikeClass:
    """Module-level donor class: its pickle bytes get rewritten to point at
    a module that does not exist here (mimicking an AMUSE class)."""


def test_tolerant_unpickler_reference_like_file(tmp_path):
    """A pickle whose classes live in modules we don't have (AMUSE,
    al26_nbody) must still load via class stubbing."""
    from al26.io.compat import tolerant_loads

    obj = _RefLikeClass()
    obj.number = [1.0, 2.0, 3.0]
    # protocol 2 encodes class refs as text GLOBAL opcodes (module\nname\n),
    # so a byte-level rename yields a pickle referencing a missing module
    raw = pickle.dumps({"q": obj, "x": 1.5}, protocol=2)
    raw = raw.replace(
        _RefLikeClass.__module__.encode() + b"\n_RefLikeClass\n",
        b"amuse.units.quantities\nVectorQuantity\n",
    )
    with pytest.raises((ImportError, AttributeError, ModuleNotFoundError)):
        pickle.loads(raw)
    out = tolerant_loads(raw)
    assert out["x"] == 1.5
    stub = out["q"]
    assert stub._stub_class == "amuse.units.quantities.VectorQuantity"
    assert stub.number == [1.0, 2.0, 3.0]


def test_cluster_particles_mapping_roundtrip():
    from al26.config import SimConfig
    from al26.io.compat import cluster_to_particles, particles_to_cluster
    from al26.sim import init_cluster
    import dataclasses

    cfg = SimConfig(n=20, rc=1.0, seed=2, no_massive_star_requirement=True)
    state, _, _ = init_cluster(cfg)
    p = cluster_to_particles(state.cluster)
    c2 = particles_to_cluster(p)
    for fld in dataclasses.fields(type(state.cluster)):
        a = np.asarray(getattr(state.cluster, fld.name))
        b = np.asarray(getattr(c2, fld.name))
        np.testing.assert_allclose(a, b, rtol=1e-12, err_msg=fld.name)


# slow lane (round-5 re-tier): full interloper trajectory run (file plumbing stays default in test_trajectory_file_reset_on_rerun_and_resume)
@pytest.mark.slow
def test_interloper_trajectory_file(tmp_path):
    """--interloper_trajectory writes per-step rows once the AGB clock is
    positive (al26_nbody.py:1030-1037 format: 6 CSV floats)."""
    res = _small_run(
        tmp_path, n=24, seed=12, t_f=0.5,
        interloper=True, interloper_mass=3.0, interloper_velocity=20.0,
        interloper_radius=0.02, interloper_offset_time=0.1,
        interloper_trajectory=True, no_massive_star_requirement=True,
    )
    traj = os.path.join(tmp_path, "interloper_trajectory.dat")
    assert os.path.exists(traj)
    rows = [l.split(",") for l in open(traj).read().strip().splitlines()]
    assert all(len(r) == 6 for r in rows)
    t_sim = [float(r[0]) for r in rows]
    t_agb = [float(r[1]) for r in rows]
    # rows only for t_agb > 0, monotonically increasing sim time
    assert all(t > 0 for t in t_agb)
    assert t_sim == sorted(t_sim)
    # offset respected: t_agb = t_sim - 0.1
    import numpy as _np
    _np.testing.assert_allclose(_np.array(t_sim) - 0.1, t_agb, atol=2e-3)


# ---------------------------------------------------------------------------
# Native (C++) codec — differential tests vs the pure-Python specification
# ---------------------------------------------------------------------------
natives = pytest.mark.skipif(
    ubjson._native is None,
    reason="native codec not built (scripts/build_native.py)")


@natives
def test_native_matches_python_wire():
    objs = [
        None, True, False, 0, -1, 255, -129, 2**40, -2**40, 1.5, -2.5e-30,
        "hello", "ünïcødé", {"a": [1.0, 2.0, 3.0], "b": {"c": [1, "x"]}},
        [[1.0, 2.0], [3.0]], [], {}, list(range(300)),
        [1.0] * 1000,
    ]
    for obj in objs:
        nat = ubjson._native.dumpb(obj)
        pyb = ubjson.dumpb_python(obj, optimized=True)
        assert nat == pyb, obj
        assert ubjson._native.loadb(pyb) == ubjson.loadb_python(nat) == obj


@natives
def test_native_handles_python_only_forms():
    # unoptimized containers and counted containers decode identically
    obj = {"t": [0.5, 1, "s", None], "u": [True, False]}
    plain = ubjson.dumpb_python(obj, optimized=False)
    assert ubjson._native.loadb(plain) == obj


@natives
def test_native_big_int_roundtrip():
    v = 2**100
    assert ubjson._native.loadb(ubjson._native.dumpb(v)) == v


@natives
def test_native_speed():
    import time
    payload = {"series": [list(np.random.default_rng(0).uniform(size=1000))
                          for _ in range(1000)]}
    t0 = time.time()
    data = ubjson._native.dumpb(payload)
    enc = time.time() - t0
    t0 = time.time()
    ubjson._native.loadb(data)
    dec = time.time() - t0
    # the reference quotes ~0.2 s for this payload via py-ubjson
    assert enc < 3.0 and dec < 3.0, (enc, dec)  # wall-clock, slack for loaded CI


@natives
def test_native_codec_robustness():
    """Review regressions: malformed inputs raise instead of crashing the
    interpreter (lone surrogates, pathological nesting, corrupt streams)."""
    # lone surrogate cannot encode to UTF-8 -> catchable exception
    with pytest.raises((UnicodeEncodeError, TypeError, ValueError)):
        ubjson._native.dumpb("\ud800")
    with pytest.raises((UnicodeEncodeError, TypeError, ValueError)):
        ubjson._native.dumpb({"\ud800": 1})
    # deep nesting: encoder
    deep = v = []
    for _ in range(10_000):
        inner = []
        v.append(inner)
        v = inner
    with pytest.raises(RecursionError):
        ubjson._native.dumpb(deep)
    # deep nesting: decoder (adversarial/corrupt stream)
    with pytest.raises(ValueError):
        ubjson._native.loadb(b"[" * 1_000_000)
    # truncated stream
    with pytest.raises(ValueError):
        ubjson._native.loadb(b"[D\x00\x00")


# ---------------------------------------------------------------------------
# Appendable framed yields store (round-2 extra; io/yields_store.py)
# ---------------------------------------------------------------------------
def test_yields_frames_match_blob(tmp_path):
    """A frames-mode run writes the framed store at every save plus the
    reference blob at the final save; both must decode to identical
    content."""
    from al26.io.yields_store import Yields

    _small_run(tmp_path)  # yields_frames defaults on
    base = os.path.join(tmp_path, "testrun")
    assert os.path.exists(base + "-yields.ubjf")
    assert os.path.exists(base + "-yields.ubj.zst")  # final blob for the
    #                                                  reference pipeline
    yf = Yields("")
    yf.plate_frames(base + "-yields.ubjf")
    yb = Yields("")
    yb.plate(base + "-yields.ubj.zst")
    assert yf.time == yb.time
    for attr, val in yb.__dict__.items():
        if isinstance(val, list):
            assert getattr(yf, attr) == val, attr


def test_yields_frames_torn_tail_is_dropped(tmp_path):
    from al26.io.yields_store import Yields

    _small_run(tmp_path)
    path = os.path.join(tmp_path, "testrun-yields.ubjf")
    whole = Yields("")
    whole.plate_frames(path)
    with open(path, "ab") as f:
        f.write(b"FRME" + (10**6).to_bytes(8, "little") + b"torn!")
    torn = Yields("")
    torn.plate_frames(path)  # must not raise
    assert torn.time == whole.time


def test_yields_frames_resume_prefers_frames(tmp_path):
    """Mid-run state + frames only (no blob yet): resume must reconstruct
    the store from frames. Simulates a crash by deleting the final blob."""
    from al26.io.checkpoint import load_checkpoint

    _small_run(tmp_path)
    base = os.path.join(tmp_path, "testrun")
    os.remove(base + "-yields.ubj.zst")
    _, _, yields, _ = load_checkpoint(base, 3)
    assert len(yields.time) == 7  # full history, reference plate semantics
    assert yields.time[-1] == pytest.approx(1.0)


def test_yields_rewrite_mode_is_reference_parity(tmp_path):
    _small_run(tmp_path, yields_frames=False)
    base = os.path.join(tmp_path, "testrun")
    assert not os.path.exists(base + "-yields.ubjf")
    assert os.path.exists(base + "-yields.ubj.zst")


def test_yields_frames_rerun_in_place(tmp_path):
    """Re-running a simulation with the same base filename must truncate
    the stale framed file, not append to it (advisor round-2 medium
    finding): otherwise resume/plotting silently read the previous run's
    snapshots prepended to the new series."""
    from al26.io.yields_store import Yields

    _small_run(tmp_path, seed=21)
    _small_run(tmp_path, seed=22)  # same base name, fresh run
    base = os.path.join(tmp_path, "testrun")
    yf = Yields("")
    yf.plate_frames(base + "-yields.ubjf")
    yb = Yields("")
    yb.plate(base + "-yields.ubj.zst")
    assert yf.time == yb.time  # second run only, not 2x the history
    assert yf.local_26al == yb.local_26al


def test_bounded_store_streams_identical_blob(tmp_path):
    """VERDICT r2 item 2: a bounded (frames-mode) store retains only the
    latest per-star snapshot in RAM, and its streamed blob reconstruction
    decodes IDENTICALLY to the unbounded in-memory marinate."""
    from al26.io.yields_store import _SERIES, Yields
    from al26.io import ubjson
    from al26.io.compression import decompress

    base_b = os.path.join(tmp_path, "bounded")
    base_u = os.path.join(tmp_path, "unbounded")
    yb = Yields(base_b, bounded=True)
    yu = Yields(base_u, bounded=False)
    frames = os.path.join(tmp_path, "b-yields.ubjf")
    for k in range(4):
        _feed_one(yb, k)
        yb.marinate_frame(frames)
        _feed_one(yu, k)
    # RAM bound: one snapshot per series regardless of save count
    for name in _SERIES:
        assert len(getattr(yb, name)) == 1
        assert len(getattr(yu, name)) == 4
    blob_b = os.path.join(tmp_path, "b.ubj.zst")
    blob_u = os.path.join(tmp_path, "u.ubj.zst")
    yb.marinate(blob_b, frames_path=frames)
    yu.marinate(blob_u)
    with open(blob_b, "rb") as f:
        db = ubjson.loadb(decompress(f.read()))
    with open(blob_u, "rb") as f:
        du = ubjson.loadb(decompress(f.read()))
    db.pop("filename")
    du.pop("filename")
    assert db == du
    # bounded without a frames path must refuse, not write a partial blob
    with pytest.raises(ValueError):
        yb.marinate(blob_b)


def _feed_one(store, k, n_star=5):
    """One synthetic update_state snapshot (deterministic in k)."""
    rng = np.random.default_rng(1000 + k)

    class _Q:
        def __init__(self, v):
            self.v = v

        def value_in(self, unit):
            return self.v

    class P:
        pass

    p = P()
    for iso in ("26al", "60fe"):
        for ch in ("local", "global", "sne", "agb", "agb_raw"):
            setattr(p, f"mass_{iso}_{ch}", _Q(rng.uniform(size=n_star)))
            if ch != "agb_raw":
                setattr(p, f"mass_{iso}_{ch}_final",
                        _Q(rng.uniform(size=n_star)))
    store.update_state(0.1 * k, p)


def test_truncate_frames_drops_stale_tail(tmp_path):
    """Resume from an earlier checkpoint: frames after the resume time are
    removed from both the store and the file."""
    from al26.io.yields_store import Yields

    base = os.path.join(tmp_path, "t")
    frames = base + "-yields.ubjf"
    y = Yields(base, bounded=True)
    for k in range(5):
        _feed_one(y, k)
        y.marinate_frame(frames)
    loaded = Yields(base)
    loaded.plate_frames(frames)
    loaded.truncate_frames(frames, 0.21)  # keeps t = 0.0, 0.1, 0.2
    assert loaded.time == pytest.approx([0.0, 0.1, 0.2])
    assert len(loaded.local_26al) == 3
    # the file itself is truncated, and the finals roll back to frame 2's
    probe = Yields(base)
    probe.plate_frames(frames)
    assert probe.time == pytest.approx([0.0, 0.1, 0.2])
    assert probe.local_26al == loaded.local_26al
    assert probe.local_26al_final == loaded.local_26al_final


def test_backfill_frames_seeds_full_history(tmp_path):
    """A blob-only (reference-written) resume seeds the framed file from
    the restored history so bounded mode sees the complete series."""
    from al26.io.yields_store import Yields

    base = os.path.join(tmp_path, "bf")
    y = Yields(base)
    for k in range(3):
        _feed_one(y, k)
    frames = base + "-yields.ubjf"
    y.backfill_frames(frames)
    back = Yields(base)
    back.plate_frames(frames)
    assert back.time == y.time
    assert back.local_26al == y.local_26al
    assert back.sne_60fe_final == y.sne_60fe_final


def test_read_yields_accepts_frames(tmp_path):
    from al26.plotting.lib import read_yields

    _small_run(tmp_path)
    base = os.path.join(tmp_path, "testrun")
    yf = read_yields(base + "-yields.ubjf")
    yb = read_yields(base + "-yields.ubj.zst")
    np.testing.assert_array_equal(yf.time, yb.time)
    np.testing.assert_array_equal(yf.local_26al, yb.local_26al)
    np.testing.assert_array_equal(yf.sne_60fe_final, yb.sne_60fe_final)


def test_truncate_frames_removes_torn_tail_on_resume(tmp_path):
    """Crash mid-append, then resume: the torn trailing fragment must be
    truncated before new frames are appended — otherwise every later read
    (and the final streamed blob) hits the garbage bytes (round-3 review
    finding)."""
    from al26.io.yields_store import Yields

    base = os.path.join(tmp_path, "tt")
    frames = base + "-yields.ubjf"
    y = Yields(base, bounded=True)
    for k in range(4):
        _feed_one(y, k)
        y.marinate_frame(frames)
    with open(frames, "ab") as f:  # simulate a crash mid-append
        f.write(b"FRME" + (10**6).to_bytes(8, "little") + b"torn!")
    loaded = Yields(base)
    loaded.plate_frames(frames)  # drops the torn tail in memory
    # resume at the LATEST time: nothing to drop, but the file tail must go
    loaded.truncate_frames(frames, loaded.time[-1])
    loaded.bound()
    _feed_one(loaded, 4)
    loaded.marinate_frame(frames)  # append after the (now clean) end
    again = Yields(base)
    again.plate_frames(frames)  # must read all 5 frames, no corruption
    assert again.time == pytest.approx([0.0, 0.1, 0.2, 0.3, 0.4])
    blob = base + ".ubj.zst"
    loaded.marinate(blob, frames_path=frames)  # streamed blob sees 5 too
    from al26.io import ubjson
    from al26.io.compression import decompress

    with open(blob, "rb") as f:
        d = ubjson.loadb(decompress(f.read()))
    assert len(d["local_26al"]) == 5


def test_blob_only_resume_truncates_future_before_backfill(tmp_path):
    """Resuming a blob-only (rewrite-mode / reference-written) run from an
    EARLIER checkpoint must not seed the framed file with the blob's
    future snapshots (round-3 review finding)."""
    from al26.io.checkpoint import load_checkpoint
    from al26.io.yields_store import Yields

    _small_run(tmp_path, yields_frames=False)  # blob-only, 7 saves to t=1
    base = os.path.join(tmp_path, "testrun")
    _, _, yields, md = load_checkpoint(base, 3)
    assert len(yields.time) == 7  # blob holds the whole history
    from al26.config import SimConfig
    from al26.sim.driver import _bound_resumed_yields

    cfg = SimConfig(n=48, rc=0.5, final_time=1.0, yields_frames=True)
    t_resume = yields.time[3]
    _bound_resumed_yields(yields, base, cfg, t_resume)
    assert len(yields.time) == 4  # 0.0 .. t_resume, future snapshots gone
    back = Yields(base)
    back.plate_frames(base + "-yields.ubjf")
    assert len(back.time) == 4  # no stale future frames
    assert back.time[-1] == pytest.approx(t_resume)


def test_truncate_csv_keeps_f32_boundary_row(tmp_path):
    """The CSV's time column is written at %.6e (7 significant digits), so
    an f32 checkpoint time like float(np.float32(9.995)) = 9.99499988...
    appears in the file as 9.995000e+00 — ABOVE the truncation time.
    truncate_csv's tolerance must cover that quantisation or the boundary
    row at the resume time itself is dropped on ~half of f32 resumes
    (round-3 review finding); genuinely stale rows sit a full dt above."""
    from al26.io.yields_store import Yields

    y = Yields(str(tmp_path / "f32b"))
    path = f"{y.filename}-cluster-yields.csv"
    t_ckpt = float(np.float32(9.995))  # 9.994999885559082
    with open(path, "w") as f:
        f.write("time,local_26al,global_26al,sne_26al,"
                "local_60fe,global_60fe,sne_60fe\n")
        f.write("{:.6e},0,0,0,0,0,0\n".format(t_ckpt))         # boundary
        f.write("{:.6e},0,0,0,0,0,0\n".format(t_ckpt + 0.01))  # stale
    y.truncate_csv(t_ckpt)
    rows = open(path).read().strip().splitlines()
    assert len(rows) == 2, "boundary row dropped or stale row kept"
    assert float(rows[1].split(",")[0]) == pytest.approx(9.995)


def test_resume_truncates_stale_csv_rows(tmp_path):
    """Resume from an earlier checkpoint must drop the CSV's future rows
    before the re-simulated run appends fresh ones (round-3 review
    finding; the frames file and blob already truncate)."""
    from al26.config import SimConfig
    from al26.sim.driver import run

    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        cfg = SimConfig(n=32, rc=0.5, final_time=1.0, seed=9,
                        filename="csvr", n_plot=5, steps_per_plot=4)
        run(cfg, progress=False)
        run(SimConfig(reload="csvr", n_checkpoint=3), progress=False)
        rows = open("csvr-cluster-yields.csv").read().strip().splitlines()
        times = [float(r.split(",")[0]) for r in rows[1:]]
        assert times == sorted(times)
        assert len(times) == len(set(times)), "duplicated stale tail"
        assert times[-1] == pytest.approx(1.0)
    finally:
        os.chdir(cwd)


def test_resume_path_qualified_stays_in_place(tmp_path):
    """'-r out/testrun' issued from the PARENT directory must keep writing
    into out/ (round-3 review: base was metadata.filename — the bare
    original name — so a path-qualified resume split the run's artifacts
    across two directories and skipped frames truncation)."""
    from al26.config import SimConfig
    from al26.sim.driver import run

    out = tmp_path / "out"
    out.mkdir()
    _small_run(out)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        run(SimConfig(reload="out/testrun", n_checkpoint=3), progress=False)
    finally:
        os.chdir(cwd)
    stray = [f for f in os.listdir(tmp_path) if f != "out"]
    assert stray == [], f"resume artifacts leaked into the cwd: {stray}"
    states = [f for f in os.listdir(out) if "-state-" in f]
    assert len(states) == 7  # rewritten in place, same count as the run
    rows = open(out / "testrun-cluster-yields.csv").read().splitlines()
    times = [float(r.split(",")[0]) for r in rows[1:]]
    assert times == sorted(times) and len(times) == len(set(times))


def test_rewrite_mode_nc_resume_blob_monotonic(tmp_path):
    """Rewrite (blob-only) mode restores the FULL history on load: a -nc
    resume must drop the future snapshots from the in-memory store too,
    or update_state appends the re-simulated ones after them and every
    marinate writes a non-monotonic time series (round-3 review)."""
    from al26.config import SimConfig
    from al26.io.yields_store import Yields
    from al26.sim.driver import run

    _small_run(tmp_path, yields_frames=False)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        run(SimConfig(reload="testrun", n_checkpoint=2), progress=False)
    finally:
        os.chdir(cwd)
    y = Yields("")
    y.plate(os.path.join(tmp_path, "testrun-yields.ubj.zst"))
    assert y.time == sorted(y.time)
    assert len(y.time) == len(set(y.time)) == 7
    # every artifact carries the run's base name (no None-/empty-base files)
    assert all(f.startswith("testrun") for f in os.listdir(tmp_path))


def test_no_duplicate_final_snapshot(tmp_path):
    """steps_per_plot=1 lands the loop's last cadence save exactly on
    n_steps — the driver must not append a SECOND t_f snapshot; and a
    resume of an already-complete run takes zero steps and must not
    append one either (round-3 review)."""
    from al26.config import SimConfig
    from al26.sim.driver import run

    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        run(SimConfig(n=24, rc=0.5, final_time=0.05, seed=3,
                      filename="dup", n_plot=5, steps_per_plot=1,
                      star_max_mass=3.0, no_massive_star_requirement=True),
            progress=False)
        rows = open("dup-cluster-yields.csv").read().splitlines()
        times = [float(r.split(",")[0]) for r in rows[1:]]
        assert len(times) == len(set(times)), "duplicated final snapshot"
        n_states = len([f for f in os.listdir(".") if "-state-" in f])
        run(SimConfig(reload="dup"), progress=False)  # already complete
        rows2 = open("dup-cluster-yields.csv").read().splitlines()
        assert len(rows2) == len(rows)
        assert len([f for f in os.listdir(".") if "-state-" in f]) == n_states
    finally:
        os.chdir(cwd)


def test_nc_resume_drops_stale_state_files(tmp_path):
    """A -nc K resume truncates the yields artifacts to t_K; the abandoned
    timeline's higher-numbered STATE files must go too, or a later plain
    resume restarts from the stale global max while the yields track the
    new timeline (round-3 review)."""
    import shutil

    from al26.config import SimConfig
    from al26.sim.driver import run

    _small_run(tmp_path)
    base = os.path.join(tmp_path, "testrun")
    # fabricate an abandoned-timeline file above the real ones
    shutil.copy(base + "-state-00006.pkl.zst", base + "-state-00011.pkl.zst")
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        run(SimConfig(reload="testrun", n_checkpoint=2), progress=False)
    finally:
        os.chdir(cwd)
    states = sorted(f for f in os.listdir(tmp_path) if "-state-" in f)
    assert "testrun-state-00011.pkl.zst" not in states
    assert len(states) == 7


def test_trajectory_file_reset_on_rerun_and_resume(tmp_path):
    """interloper_trajectory.dat gets the same rerun/resume hygiene as the
    CSV: a cold rerun in the same cwd starts fresh, and a -nc resume drops
    rows at/after the resumed time (each row carries the PREVIOUS step's
    time, so the boundary row is re-emitted by the resumed run)."""
    from al26.config import SimConfig
    from al26.sim.driver import run

    kw = dict(n=24, rc=0.5, final_time=0.2, seed=6,
              filename="tr", n_plot=4, steps_per_plot=5,
              star_max_mass=3.0, no_massive_star_requirement=True,
              interloper=True, interloper_mass=3.0,
              interloper_velocity=20.0, interloper_radius=0.05,
              interloper_offset_time=0.0, interloper_trajectory=True)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        run(SimConfig(**kw), progress=False)
        rows1 = open("interloper_trajectory.dat").read().splitlines()
        run(SimConfig(**kw), progress=False)  # cold rerun: fresh file
        rows2 = open("interloper_trajectory.dat").read().splitlines()
        assert len(rows2) == len(rows1), "cold rerun appended to stale file"
        run(SimConfig(reload="tr", n_checkpoint=2), progress=False)
        rows3 = open("interloper_trajectory.dat").read().splitlines()
        times = [float(r.split(",")[0]) for r in rows3]
        assert times == sorted(times)
        assert len(times) == len(set(times)), "duplicated boundary row"
        assert len(rows3) == len(rows1)
    finally:
        os.chdir(cwd)


def test_interloper_resume_keeps_depositing(tmp_path):
    """A resumed interloper run continues AGB deposition and bit-matches
    the uninterrupted run. Deliberate divergence from the reference,
    which arms the AGB lookup only on a COLD start (al26_nbody.py:1660
    gates read_AGBs() on args.reload == \"\"), so its resumed -i runs
    carry AGB=None and silently stop depositing; our resume rebuilds the
    AGB wind tables from the restored config (_rebuild_aux). See
    docs/MIGRATION.md \"Resume\"."""
    from al26.config import SimConfig
    from al26.sim.driver import run
    from al26.units import msol

    kw = dict(n=24, rc=0.5, final_time=0.2, seed=6,
              filename="ir", n_plot=4, steps_per_plot=5,
              star_max_mass=3.0, no_massive_star_requirement=True,
              interloper=True, interloper_mass=3.0,
              interloper_velocity=20.0, interloper_radius=0.05,
              interloper_offset_time=0.0)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        full = run(SimConfig(**kw), progress=False)
        agb_full = np.asarray(full.state.cluster.agb_raw)
        assert agb_full.sum() > 0.0, "fixture flyby never deposited"

        # resume just BEFORE the flyby window (deposition lands between
        # checkpoints 1 and 2 for this fixture); the AGB channel must
        # still be GROWING afterwards (the reference's would freeze here)
        res = run(SimConfig(reload="ir", n_checkpoint=1), progress=False)
        from al26.io.checkpoint import load_checkpoint

        parts, _, _, _ = load_checkpoint("ir", 1)
        agb_at_resume = (np.asarray(parts.mass_26al_agb_raw.value_in(msol))
                         + np.asarray(parts.mass_60fe_agb_raw.value_in(msol)))
        agb_res = np.asarray(res.state.cluster.agb_raw)
        np.testing.assert_array_equal(agb_res, agb_full)
        assert agb_res.sum() > agb_at_resume.sum()
    finally:
        os.chdir(cwd)


def test_particles_index_bounds():
    """Particles integer indexing supports negatives but RAISES on
    out-of-range instead of silently wrapping to a wrong star
    (round-3 review finding)."""
    from al26.io.compat import Particles
    from al26.units import msol

    p = Particles({"mass": np.asarray([1.0, 2.0, 3.0])})
    assert p[-1].mass.value_in(msol) == 3.0
    assert p[0].mass.value_in(msol) == 1.0
    with pytest.raises(IndexError):
        p[3]
    with pytest.raises(IndexError):
        p[-4]
    # iteration terminates at len (uses __iter__, not wrapping getitem)
    assert len(list(p)) == 3


def test_ubjson_unsigned_bool_bytes():
    """Round-3 review findings, all reproduced before the fix: uint32/
    uint64 arrays above the signed range wrapped NEGATIVE through the
    typed-array astype; np.bool_ scalars raised TypeError; bytes decoded
    as a list of ints instead of py-ubjson's bytes semantics."""
    from al26.io.ubjson import (
        _native, dumpb, dumpb_python, loadb, loadb_python,
    )

    big32 = 2**31 + 5
    big64 = 2**63 + 7
    assert loadb_python(dumpb_python(np.array([big32], np.uint32))) == [big32]
    assert loadb_python(dumpb_python(np.array([big64], np.uint64))) == [big64]
    assert loadb_python(dumpb_python(np.array([], np.uint64))) == []
    assert loadb_python(dumpb_python(np.bool_(True))) is True
    assert loadb_python(dumpb_python(np.bool_(False))) is False
    assert loadb_python(dumpb_python(b"abc")) == b"abc"
    assert loadb_python(dumpb_python(b"")) == b""
    if _native is not None:
        # native decoder agrees on the bytes semantics
        assert loadb(dumpb_python(b"abc")) == b"abc"
        assert _native.loadb(dumpb_python(np.array([big64],
                                                   np.uint64))) == [big64]


# slow lane (round-5 re-tier): rerun edge-case of the frames store (framed-store round-trip tests stay default)
@pytest.mark.slow
def test_rewrite_rerun_clears_stale_frames_file(tmp_path):
    """A cold rewrite-mode run under a base previously used by a
    frames-mode run must delete the stale .ubjf (load_checkpoint used to
    prefer ANY frames file, restoring the OLD run's yields history on
    resume — round-3 review finding), and the preference is additionally
    gated on the checkpoint's own yields_frames arg."""
    from al26.io.checkpoint import load_checkpoint
    from al26.io.yields_store import _FRAMES_MAGIC

    _small_run(tmp_path, seed=31, yields_frames=True)
    base = os.path.join(tmp_path, "testrun")
    assert os.path.exists(base + "-yields.ubjf")
    _small_run(tmp_path, seed=32, yields_frames=False)
    assert not os.path.exists(base + "-yields.ubjf"), "stale frames kept"
    # belt-and-braces: even if a stale .ubjf reappears, the rewrite-mode
    # checkpoint's metadata gates the preference back to the blob
    with open(base + "-yields.ubjf", "wb") as f:
        f.write(_FRAMES_MAGIC)  # valid but EMPTY framed store
    _, _, y, _ = load_checkpoint(base, 3)
    assert len(y.time) == 7  # run B's full blob history, not the empty file
