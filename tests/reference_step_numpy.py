"""Independent pure-numpy transcription of the reference's PER-STEP
physics (evolve_simulation, al26_nbody.py:704-1113) — VERDICT r2 item 3.

This module is written FROM THE REFERENCE SOURCE, line by line, using
plain Python loops exactly as the numba kernels do — deliberately NOT
from al26's vectorised ops — so diffing `step()` against it converts
kernel-level parity (tests/test_deposition.py golden tests) into
STEP-level parity: the composed ordering, gating and accumulation of

    1. high/low-mass indexing at step start  (al26_nbody.py:767, 1194-1216)
    2. virial radius from the step-start state (:770, AMUSE builtin)
    3. stellar evolution -> new masses + wind rates (:841, 871-876)
    4. calc_wind_abs x4 (2 isotopes x {global, local})   (:883-941, 642-702)
    5. SN detection + 1/d^2 injection loop   (:943-967, 1291-1334)
    6. radioactive decay                      (:1045-1068)
    7. disc condensation / death              (:1070-1086)

The N-body advance itself (:833) is held frozen (fixed positions) — its
parity is covered separately by the integrator/energy tests — and the
stellar mass/rate tracks come from al26's stellar module (shared
input data: the reference gets them from the out-of-process SeBa code,
which does not exist here; docs/stellar_model.md).

Used by tests/test_step_transcription.py at N=32 / 50 steps / float64
under cfg.sn_parity_mode (the reference's current-mass gate).
"""
from __future__ import annotations

import numpy as np

# reference constants (al26_nbody.py:53-79, 1048-1051, 1327-1329)
R_BUB_LOCAL_WIND = 0.1          # pc   (al26_nbody.py:66)
LN2_REF = 0.693147              # truncated ln2 (al26_nbody.py:1050-1051)
HALF_LIFE_26AL = 0.717          # Myr  (al26_nbody.py:1048)
HALF_LIFE_60FE = 2.600          # Myr  (al26_nbody.py:1049, NOT the csv 2.62)
SN_COS60 = 0.5                  # cos(60 deg)      (al26_nbody.py:1327-1329)
SN_ETA_COND = 0.5
SN_ETA_INJ = 0.7
G_PC_MSUN_MYR = 0.004498502151575286   # G in pc^3 / (Msun Myr^2)


def high_low_mass_indices(mass, threshold=13.0, lm_lo=0.1, lm_hi=3.0):
    """get_high_mass_star_indices (al26_nbody.py:1194-1216): O(N) scan of
    CURRENT masses."""
    hm_id, lm_id = [], []
    for i in range(len(mass)):
        if mass[i] >= threshold:
            hm_id.append(i)
        elif lm_lo <= mass[i] <= lm_hi:
            lm_id.append(i)
    return hm_id, lm_id


def virial_radius(pos, mass):
    """AMUSE particles.virial_radius() (al26_nbody.py:770): pairwise
    potential sum, r_vir = G M^2 / (2 |U|) -- equivalently
    0.5 * M^2 / sum_{i<j} m_i m_j / r_ij."""
    n = len(mass)
    s = 0.0
    for i in range(n):
        for j in range(i + 1, n):
            r = np.sqrt(np.sum((pos[i] - pos[j]) ** 2))
            s += mass[i] * mass[j] / r
    return 0.5 * float(np.sum(mass)) ** 2 / s


def calc_wind_abs(lm_id, hm_id, pos, v_lm, r_disk, mdot, wind_ratio,
                  bubble_radius, dt, distance_limit):
    """calc_wind_abs (al26_nbody.py:642-702): one isotope, one mixing
    model. `distance_limit != 0` is the LOCAL model — skip pairs with
    bubble_radius <= separation (:688-690). Returns absorbed mass per
    lm star (indexed like lm_id)."""
    wind_abs = np.zeros(len(lm_id))
    for a, i in enumerate(lm_id):
        eta = 0.75 * (r_disk[i] ** 2) * (v_lm[i] * dt) / (bubble_radius ** 3)
        acc = 0.0
        for j in hm_id:
            if distance_limit != 0.0:
                d = np.sqrt(np.sum((pos[i] - pos[j]) ** 2))
                if bubble_radius <= d:
                    continue
            acc += wind_ratio[j] * mdot[j] * eta * dt
        wind_abs[a] = acc
    return wind_abs


def reference_step(sim, t_new, dt):
    """One physics step of evolve_simulation at frozen positions.

    `sim` is a dict of plain numpy arrays (modified in place):
      pos[N,3], vel[N,3], mass[N] (current), m0[N],
      wind_ratio_26al/60fe[N], sn_yield_26al/60fe[N],
      mass_{26al,60fe}_{local,global,sne}[N] (+ *_final), r_disk[N],
      tau_disk[N], disk_alive[N], kicked[N]
    plus `evolve(m0, t) -> (mass, mdot)` — the stellar-track callable.
    Interloper physics off (the transcription covers the reference's
    default run mode).
    """
    # 1. index the sets from the STEP-START masses (al26_nbody.py:767)
    hm_id, lm_id = high_low_mass_indices(sim["mass"])
    # 2. virial radius from the step-start state (:770)
    r_vir = virial_radius(sim["pos"], sim["mass"])
    # 3. stellar evolution to t_new; channel copies (:841, 871-876)
    mass_new, mdot_new = sim["evolve"](sim["m0"], t_new)
    sim["mass"] = np.asarray(mass_new, np.float64)
    mdot = np.asarray(mdot_new, np.float64)

    pos = sim["pos"]
    v_lm = np.sqrt(np.sum(sim["vel"] ** 2, axis=1))

    # 4. wind deposition x4 (:883-941): global then local, per isotope
    if len(hm_id) > 0:
        for iso in ("26al", "60fe"):
            wr = sim[f"wind_ratio_{iso}"]
            g = calc_wind_abs(lm_id, hm_id, pos, v_lm, sim["r_disk"],
                              mdot, wr, r_vir, dt, distance_limit=0.0)
            l = calc_wind_abs(lm_id, hm_id, pos, v_lm, sim["r_disk"],
                              mdot, wr, R_BUB_LOCAL_WIND, dt,
                              distance_limit=R_BUB_LOCAL_WIND)
            for a, i in enumerate(lm_id):
                sim[f"mass_{iso}_global"][i] += g[a]
                sim[f"mass_{iso}_local"][i] += l[a]

    # 5. supernovae (:943-967): hm star, wind rate exactly zero, not kicked
    for j in hm_id:
        if mdot[j] == 0.0 and not sim["kicked"][j]:
            for i in lm_id:
                d2 = np.sum((pos[i] - pos[j]) ** 2)
                eta = (SN_ETA_COND * SN_ETA_INJ
                       * (SN_COS60 * sim["r_disk"][i] ** 2) / (4.0 * d2))
                sim["mass_26al_sne"][i] += sim["sn_yield_26al"][j] * eta
                sim["mass_60fe_sne"][i] += sim["sn_yield_60fe"][j] * eta
            sim["kicked"][j] = True

    # 6. decay (:1045-1068); AGB channel skipped (interloper off, :1062-64)
    f_al = np.exp(-dt * LN2_REF / HALF_LIFE_26AL)
    f_fe = np.exp(-dt * LN2_REF / HALF_LIFE_60FE)
    for ch in ("local", "global", "sne"):
        sim[f"mass_26al_{ch}"] *= f_al
        sim[f"mass_60fe_{ch}"] *= f_fe

    # 7. condensation (:1070-1086)
    for i in lm_id:
        if not sim["disk_alive"][i]:
            continue
        if sim["tau_disk"][i] >= t_new:
            for iso in ("26al", "60fe"):
                for ch in ("local", "global", "sne"):
                    sim[f"mass_{iso}_{ch}_final"][i] = \
                        sim[f"mass_{iso}_{ch}"][i]
        else:
            sim["disk_alive"][i] = False
    return r_vir
