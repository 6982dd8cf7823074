"""Reduce the Limongi & Chieffi (2018) machine-readable yield tables to the
wind-yields.csv / sne-yields.csv consumed at runtime.

Equivalent of the reference's limongi-chieffi-2018/fit-data.py:55-120:
  * table 8 = total (wind + SN ejecta) yields, table 9 = wind-only yields,
    both over initial masses 13..120 Msun at several rotation velocities
    and metallicities;
  * select v_rot = 300 km/s, [Fe/H] = 0;
  * wind  = table9 for 13-25 Msun  +  table8 for 30-120 Msun (stars above
    ~25 Msun collapse directly in the LC18 recommended set R, so their
    total IS the wind);
  * SNe   = table8 - table9 for 13-25 Msun only.

Usage: python scripts/gen_yield_tables.py [raw_dir] [out_dir]
Defaults regenerate al26/data/limongi_chieffi_2018/*.csv from raw/.
The regeneration is validated against the shipped CSVs in
tests/test_datagen.py.
"""
from __future__ import annotations

import os
import sys

MASSES = ["13m", "15m", "20m", "25m", "30m", "40m", "60m", "80m", "120m"]
SNE_MASSES = MASSES[:4]

_DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "al26", "data", "limongi_chieffi_2018",
)


def parse_table(path: str) -> dict:
    """Parse a CDS machine-readable table into
    {(vel, feh, isotope): [9 yields]}. The data rows are whitespace-
    separated: vel feh isotope y13 y15 y20 y25 y30 y40 y60 y80 y120."""
    out = {}
    with open(path) as f:
        for line in f:
            cells = line.split()
            # table 8 rows carry 9 yields (13-120 Msun), table 9 (wind-only)
            # carries 4 (13-25 Msun: heavier stars' total IS their wind)
            if len(cells) not in (7, 12):
                continue
            try:
                vel = int(cells[0])
                feh = int(cells[1])
                yields = [float(c) for c in cells[3:]]
            except ValueError:
                continue
            out[(vel, feh, cells[2])] = yields
    if not out:
        raise IOError(f"no data rows parsed from {path}")
    return out


def reduce_tables(raw_dir: str, vel: int = 300, feh: int = 0):
    tot = parse_table(os.path.join(raw_dir, "limongi-table-8.txt"))
    wind = parse_table(os.path.join(raw_dir, "limongi-table-9.txt"))
    # preserve table-9 row order for the isotope list (fit-data.py keeps the
    # wind table's frame)
    isotopes = [iso for (v, f, iso) in wind if v == vel and f == feh]
    wind_rows = {}
    sne_rows = {}
    for iso in isotopes:
        w = wind[(vel, feh, iso)]
        t = tot.get((vel, feh, iso))
        if t is None:
            # zero-filling here would silently corrupt the emitted yields
            # (all-zero 30-120 Msun wind columns and SNe rows)
            raise KeyError(
                f"isotope {iso!r} (vel={vel}, [Fe/H]={feh}) present in the "
                f"wind table (9) but missing from the total table (8)"
            )
        wind_rows[iso] = w[:4] + t[4:]
        sne_rows[iso] = [max(tv - wv, 0.0) for tv, wv in zip(t[:4], w[:4])]
    return isotopes, wind_rows, sne_rows


def write_csv(path: str, isotopes, rows, mass_cols, vel=300, feh=0) -> None:
    with open(path, "w") as f:
        f.write("vel,fe/h,isotope," + ",".join(mass_cols) + "\n")
        for iso in isotopes:
            vals = ",".join(repr(v) for v in rows[iso])
            f.write(f"{vel},{feh},{iso},{vals}\n")


def main(raw_dir: str | None = None, out_dir: str | None = None) -> None:
    # The velocity grid and file-name suffix convention are owned by the
    # runtime reader so generator and reader cannot drift apart.
    from al26.models.yields import _FEH_GRID, LC18_VELS, lc18_suffix

    raw_dir = raw_dir or os.path.join(_DEFAULT_DIR, "raw")
    out_dir = out_dir or _DEFAULT_DIR
    # [Fe/H] = 0 at vel = 300 keeps the reference file names (fit-data.py
    # emits only that set); the sub-solar grid gets a -feh<N> suffix
    # (selected by cfg.metallicity) and the non-300 rotation velocities a
    # -vel<V> suffix (selected by cfg.yields_vel, for self-consistent
    # pairing with the lc18_vel0/150 mass-track families) —
    # models/yields.py:read_slrs.
    for vel in LC18_VELS:
        for feh in _FEH_GRID:
            if vel != 300 and feh != 0:
                continue  # non-solar non-300 sets: regenerate on demand
            suffix = lc18_suffix(vel, feh)
            isotopes, wind_rows, sne_rows = reduce_tables(raw_dir, vel=vel,
                                                          feh=feh)
            write_csv(os.path.join(out_dir, f"wind-yields{suffix}.csv"),
                      isotopes, wind_rows, MASSES, vel=vel, feh=feh)
            write_csv(os.path.join(out_dir, f"sne-yields{suffix}.csv"),
                      isotopes, sne_rows, SNE_MASSES, vel=vel, feh=feh)
            print(f"wrote {len(isotopes)} isotopes (vel={vel}, "
                  f"[Fe/H]={feh}) to {out_dir}")


if __name__ == "__main__":
    main(*sys.argv[1:])
