"""Extract the SeBa compact-remnant event dumps shipped inside the
reference repository into al26/data/seba/binev-events.csv.

The reference repo commits `limongi-2006.tar.gz`, whose
`limongi-chieffi-2006/binev.data` is the raw event log SeBa appends to
the working directory every time a star it evolves reaches a
compact-remnant stage. The file was produced by the reference author's
own SeBa runs (the `fit.ipynb` / `yield.py` scripts in the same tarball
evolve 20-80 Msun grids at Z = 0.02 through `stellar.evolve_model`), so
it is the one place in the build where the ACTUAL SeBa mass tracks the
reference consumed (al26_nbody.py:467-493, 886-895, 945-948) are
recorded as data: supernova times, pre-SN masses and remnant masses at
solar metallicity.

Record layout (SeBa star_state dump, one event = 3 lines):

    1
    <stellar_type> 0 0 0 0 0 0
    <f0> <Z> <t_myr> <rel_age> <mass> <m_core> <m_core2> <radius> ...

Only the first five numeric fields of the state line are consumed
downstream (al26.models.stellar.seba_anchors):
Z, the event time (Myr), the stellar mass at the dump (the PRE-supernova
mass for remnant-type dumps: SeBa collapses the mass to the remnant on
the step AFTER the dump) and the core/remnant mass. Stellar types seen:
8 = (super)giant just before collapse, 18 = neutron-star remnant,
19 = black-hole remnant.

SeBa re-dumps the same event on every subsequent evolve_model call, so
the log is hugely redundant; this script keeps the unique records in
first-appearance order.

Usage: python scripts/gen_seba_anchors.py [--reference PATH] [--check]
  --check: re-derive and diff against the shipped CSV instead of writing.
"""
from __future__ import annotations

import argparse
import io
import os
import tarfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_TARBALL = "/root/reference/limongi-2006.tar.gz"
MEMBER = "limongi-chieffi-2006/binev.data"
OUT = os.path.join(REPO, "al26", "data", "seba", "binev-events.csv")

HEADER = "stellar_type,z,t_myr,rel_age,mass,m_core\n"


def extract_records(binev_text: str) -> list[tuple[str, str]]:
    """Unique (type-line, state-line) pairs in first-appearance order."""
    lines = binev_text.split("\n")
    seen: set = set()
    order: list[tuple[str, str]] = []
    i = 0
    while i + 2 < len(lines):
        if lines[i].strip() == "1":
            rec = (lines[i + 1].strip(), lines[i + 2].strip())
            if rec not in seen:
                seen.add(rec)
                order.append(rec)
            i += 3
        else:
            i += 1
    return order


def records_to_csv(records: list[tuple[str, str]]) -> str:
    rows = [HEADER]
    for type_line, state_line in records:
        stype = type_line.split()[0]
        f = state_line.split()
        # f = [f0, Z, t, rel_age, mass, m_core, ...]
        rows.append(f"{stype},{f[1]},{f[2]},{f[3]},{f[4]},{f[5]}\n")
    return "".join(rows)


def derive(tarball: str) -> str:
    with tarfile.open(tarball, "r:gz") as tf:
        data = tf.extractfile(MEMBER)
        assert data is not None, f"{MEMBER} missing from {tarball}"
        text = io.TextIOWrapper(data).read()
    return records_to_csv(extract_records(text))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reference", default=DEFAULT_TARBALL)
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    csv = derive(args.reference)
    if args.check:
        with open(OUT) as fh:
            shipped = fh.read()
        assert csv == shipped, "shipped binev-events.csv diverges from tarball"
        print(f"OK: {OUT} matches {args.reference}")
        return
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as fh:
        fh.write(csv)
    print(f"wrote {OUT} ({csv.count(chr(10)) - 1} events)")


if __name__ == "__main__":
    main()
