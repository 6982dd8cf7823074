"""Shared helper for the golden N=1k end-to-end statistics (the concrete
form of the BASELINE 'bit-reproducible SLR abundance statistics at N=1k'
row): one seeded CPU/float64 run, summarised into a small dict of exact
float values.

Used by tests/test_golden_stats.py (exact-match assertions) and
scripts/gen_golden_stats.py (regeneration after an INTENDED physics
change — regenerating to paper over an unintended diff defeats the test).
"""
from __future__ import annotations

import numpy as np

N_GOLDEN = 1000
SEED_GOLDEN = 20260816


def run_golden(sn_parity_mode: bool = False, mass_tracks: str = "lc18"):
    """The pinned configuration: N=1000, rc=1.0 pc, t_f=10 Myr (the
    reference's dt = t_f/1000, al26_nbody.py:786), hermite4 + dense f64
    forces on CPU — the deterministic 'science precision' path
    (docs/precision.md). mass_tracks="seba" + sn_parity_mode is the
    reference-OUTCOME configuration (round 4): the golden seed's 19.66
    Msun star collapses at 9.89 Myr holding 19.5 Msun, so its
    parity-gated supernova FIRES and the sne sums are non-trivial."""
    import jax

    assert jax.config.jax_enable_x64, "golden stats require x64 (conftest)"
    from al26.config import SimConfig
    from al26.sim import init_cluster, run_steps

    cfg = SimConfig(n=N_GOLDEN, rc=1.0, final_time=10.0, seed=SEED_GOLDEN,
                    dtype="f64", sn_parity_mode=sn_parity_mode,
                    mass_tracks=mass_tracks)
    state, aux, cfg = init_cluster(cfg)
    state = run_steps(state, aux, cfg, cfg.n_steps)
    return state, cfg


def summarize(state, cfg) -> dict:
    """Summary statistics, matching the reference's observables: the
    per-channel cluster sums the CSV rows carry (al26_nbody.py:221-241) and
    the final-enrichment ratio percentiles postprocess.py derives
    (plotting/postprocess.py:90-118)."""
    from al26.state import CHANNEL_NAMES, ISO_NAMES

    c = state.cluster
    slr = np.asarray(c.slr, np.float64)
    slr_final = np.asarray(c.slr_final, np.float64)
    out = {
        "time": float(state.time),
        "n_kicked": int(np.asarray(c.kicked).sum()),
        "n_disk_alive": int(np.asarray(c.disk_alive).sum()),
    }
    for s, iso in enumerate(ISO_NAMES):
        for ci, ch in enumerate(CHANNEL_NAMES[:3]):   # local, global, sne
            out[f"sum_{ch}_{iso}"] = float(slr[:, s, ci].sum())
            out[f"sum_{ch}_{iso}_final"] = float(slr_final[:, s, ci].sum())
    # final (disc-death) enrichment ratios over disc-bearing stars.
    # Round 3 (VERDICT r2 weak item 2): percentiles are taken over the
    # ENRICHED (nonzero) discs with the enriched count pinned separately —
    # at rc=1.0 >90% of discs die unenriched, so whole-population
    # percentiles were all 0.0 and guarded nothing.
    lm = (np.asarray(c.mass) >= cfg.low_mass_min) & \
         (np.asarray(c.mass) <= cfg.low_mass_max) & \
         ~np.asarray(c.is_interloper)
    stable = {
        "26al": np.asarray(c.mass_27al, np.float64),
        "60fe": np.asarray(c.mass_56fe, np.float64),
    }
    for s, iso in enumerate(ISO_NAMES):
        tot = slr_final[:, s, 0] + slr_final[:, s, 2]   # local + sne
        ratio = tot[lm] / stable[iso][lm]
        nz = ratio[ratio > 0.0]
        out[f"n_enriched_{iso}"] = int(nz.size)
        out[f"ratio_{iso}_max"] = float(nz.max()) if nz.size else 0.0
        for q in (10, 50, 90):
            out[f"ratio_{iso}_p{q}"] = (
                float(np.percentile(nz, q)) if nz.size else 0.0
            )
    return out
