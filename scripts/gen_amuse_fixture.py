"""Generate the CHECKED-IN byte-frozen AMUSE-format state pickle
(tests/golden/amuse/pt-0-state-00003.pkl.zst).

VERDICT r4 item 5: the tolerant unpickler (al26.io.compat) was only
ever exercised against fixture bytes built in the same test process — a
builder/loader co-drift could pass silently. This script freezes one
deterministic fixture byte stream into the repo: a reference-layout
`State{amuse Particles, nbody_to_si converter, Metadata}` pickle
(al26_nbody.py:281-293, 347-378) with the genuine AMUSE module paths,
class layouts, random uint64 particle keys, sorted-key storage
ancillaries and protocol-2 opcode stream (tests/amuse_fixture.py),
zstd-compressed exactly like a reference checkpoint. The loading test
(tests/test_amuse_compat.py::test_checked_in_reference_state_loads)
then runs against bytes that CANNOT drift with the builder.

Deterministic: pinned seed, pinned timestamps, pinned cluster content
(init_cluster seed 20260501 on CPU/f64).

Usage: python scripts/gen_amuse_fixture.py [--check]
"""
from __future__ import annotations

import argparse
import os
import sys
from datetime import datetime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

OUT_DIR = os.path.join(REPO, "tests", "golden", "amuse")
OUT = os.path.join(OUT_DIR, "pt-0-state-00003.pkl.zst")

N_FIX = 24
SEED_FIX = 20260501
TIME_MYR = 3.0


def build() -> bytes:
    os.environ.pop("JAX_PLATFORMS", None)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from al26.config import SimConfig
    from al26.io.compat import cluster_to_particles
    from al26.io.compression import compress
    from al26.sim import init_cluster
    from al26.state import cluster_to_numpy
    from amuse_fixture import build_state_pickle

    cfg = SimConfig(n=N_FIX, rc=1.0, final_time=10.0, seed=SEED_FIX,
                    dtype="f64", no_massive_star_requirement=True)
    state, _, cfg = init_cluster(cfg, as_numpy=True)
    cols = cluster_to_particles(cluster_to_numpy(state.cluster)).columns()
    # give the SLR accumulators non-trivial deterministic values so the
    # loading test checks real data flow, not just zeros
    rng = np.random.default_rng(SEED_FIX)
    for name in cols:
        if name.startswith(("mass_26al", "mass_60fe")):
            cols[name] = rng.uniform(1e-12, 1e-8, N_FIX)
    # drop the shim's sequential keys so the fixture carries the
    # AMUSE-style random uint64 key draw (amuse_fixture key_seed)
    cols.pop("key", None)
    blob = build_state_pickle(
        cols, N_FIX, 1.0, TIME_MYR, 10.0, "pt-0", key_seed=SEED_FIX,
        now=datetime(2026, 5, 1, 12, 0, 0),
    )
    return compress(blob), cols


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    data, _ = build()
    if args.check:
        with open(OUT, "rb") as fh:
            if fh.read() != data:
                raise SystemExit("MISMATCH vs shipped fixture")
        print("OK")
        return
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(OUT, "wb") as fh:
        fh.write(data)
    print(f"wrote {OUT} ({len(data)} bytes)")


if __name__ == "__main__":
    main()
