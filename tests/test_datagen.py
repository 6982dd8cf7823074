"""Offline data-generation script tests (components #24-26: yield-table
reduction, AGB table generation, wind-ratio analysis)."""
import os
import sys

import numpy as np
import pytest

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
sys.path.insert(0, SCRIPTS)


def test_yield_table_reduction_matches_shipped(tmp_path):
    """Regenerating wind-/sne-yields.csv from the raw LC18 tables must
    reproduce the shipped values for every isotope/mass."""
    import gen_yield_tables as g

    from al26.models.yields import DATA_DIR, _read_yield_table

    raw = os.path.join(DATA_DIR, "limongi_chieffi_2018", "raw")
    g.main(raw, str(tmp_path))

    wanted_files = [("wind-yields.csv", {"Al26", "Fe60"}),
                    ("sne-yields.csv", {"Al26", "Fe60"})]
    # the sub-solar and non-300-velocity sets (supersets of the
    # reference) regenerate identically
    for feh in (-1, -2, -3):
        wanted_files += [(f"wind-yields-feh{feh}.csv", {"Al26", "Fe60"}),
                         (f"sne-yields-feh{feh}.csv", {"Al26", "Fe60"})]
    for vel in (150, 0):
        wanted_files += [(f"wind-yields-vel{vel}.csv", {"Al26", "Fe60"}),
                         (f"sne-yields-vel{vel}.csv", {"Al26", "Fe60"})]
    for fname, wanted in wanted_files:
        new = _read_yield_table(str(tmp_path / fname), wanted)
        shipped = _read_yield_table(
            os.path.join(DATA_DIR, "limongi_chieffi_2018", fname), wanted)
        for iso in wanted:
            np.testing.assert_array_equal(new[iso][0], shipped[iso][0])
            np.testing.assert_allclose(new[iso][1], shipped[iso][1],
                                       rtol=1e-10, err_msg=f"{fname}:{iso}")


def test_yield_table_full_isotope_count(tmp_path):
    import gen_yield_tables as g

    from al26.models.yields import DATA_DIR

    raw = os.path.join(DATA_DIR, "limongi_chieffi_2018", "raw")
    isotopes, wind_rows, sne_rows = g.reduce_tables(raw)
    # the LC18 wind table carries ~300 isotopes (reference CSV has 333 rows)
    assert len(isotopes) > 250
    assert "Al26" in isotopes and "Fe60" in isotopes
    # physical sanity: SN ejecta non-negative
    for iso in ("Al26", "Fe60"):
        assert all(v >= 0 for v in sne_rows[iso])


def test_agb_table_generation(tmp_path):
    import gen_agb_tables as g

    out = g.generate(3.0, str(tmp_path))
    rows = open(out).read().strip().splitlines()
    header = rows[0].split(",")
    assert header == ["t", "star_mass", "26al_mass_loss_rate",
                      "60fe_mass_loss_rate", "star_mass_loss_rate",
                      "26al_total_mass_loss", "60fe_total_mass_loss",
                      "star_total_mass_loss"]
    assert len(rows) == 1 + 1024
    data = np.array([[float(v) for v in r.split(",")] for r in rows[1:]])
    # time starts at 0 (phase-relative), rates non-negative, star mass
    # decreases to near the WD mass
    assert data[0, 0] == 0.0
    assert (data[:, 2] >= 0).all() and (data[:, 4] >= 0).all()
    assert data[-1, 1] < data[0, 1]
    assert 0.5 < data[-1, 1] < 1.2  # ~WD mass for 3 Msun
    # generated table is loadable by the runtime AGB reader
    from al26.models.agb import read_agbs

    # read_agbs expects data_dir/agb_wind/
    agbdir = tmp_path / "agb_wind"
    agbdir.mkdir()
    os.rename(out, str(agbdir / "agb_slr_3_msol.csv"))
    tables = read_agbs(str(tmp_path))
    assert tables[0].mass_msun == 3.0


def test_wind_ratio_script(tmp_path, capsys):
    import wind_ratio

    out = str(tmp_path / "wr.pdf")
    wind_ratio.main(out)
    captured = capsys.readouterr().out
    assert "t_SN" in captured
    assert os.path.exists(out)


def test_wind_shape_regenerates():
    """The SeBa MS-wind timing calibration (wind-shape.csv) regenerates
    byte-identically from the reference tarball's vector figure — the
    full PDF polyline extraction + axis calibration + knee/ramp fits
    (scripts/gen_wind_shape.py), including its internal collapse-time
    cross-validation against the binev.data events."""
    import gen_wind_shape as g

    if not os.path.exists(g.DEFAULT_TARBALL):
        pytest.skip("reference tarball not available")
    rows = g.derive(g.DEFAULT_TARBALL)
    text = g.HEADER + "".join(
        ",".join(str(v) for v in r) + "\n" for r in rows)
    with open(g.OUT) as fh:
        assert fh.read() == text
