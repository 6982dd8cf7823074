"""Generate AGB interloper wind tables: agb_slr_{3,5,6,7}_msol.csv.

Equivalent of the reference's agb_wind/agb-wind-calc.py (which drives SeBa
out of process): 1024 time samples across each star's AGB phase, with SLR
mass-loss rates = stellar wind rate x constant isotopic wind fraction from
Karakas & Lugaro (2016). The AGB phase boundaries and superwind profile
come from al26.models.stellar.evolution (agb_t_start/agb_t_end/
agb_mdot) instead of SeBa's stellar_type 5->7 transitions; since round 4
every phase anchor is CALIBRATED on the shipped SeBa-derived tables
(models.stellar.agb_calibration) and the regeneration is tested against
them with stated tolerances (tests/test_agb_calibration.py): phase
duration and envelope loss exact by construction, cumulative-loss
quantiles within 0.01, SLR lifetime totals within 0.1%.

Matching the shipped-table semantics exactly: the `t` column is
phase-relative, `star_mass` starts at the AGB-ENTRY mass (SeBa stars
arrive having already shed pre-AGB wind), and the *_total_mass_loss
cumulative columns start at that nonzero pre-AGB loss (m0 - m_enter),
with the SLR fractions applied to the FULL cumulative loss — exactly as
agb-wind-calc.py records them.

NOTE: the default runtime data (al26/data/agb_wind/*.csv) is the
reference-shipped SeBa-derived set; this script regenerates the same file
schema from the calibrated model (useful for new masses, where anchors
clamp to the calibrated [3, 7] Msun grid).

Usage: python scripts/gen_agb_tables.py [out_dir]
"""
from __future__ import annotations

import os
import sys

# force CPU + x64: a host-side table generator must not take an
# accelerator (f32 by default there) while the calibration tolerances pinned in
# tests/test_agb_calibration.py assume the conftest's CPU/x64 regime —
# the k~54 superwind exponential at s=(t-t0)/dur, t~hundreds of Myr,
# genuinely needs f64 (same pin as scripts/gen_golden_stats.py)
os.environ.pop("JAX_PLATFORMS", None)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

# Karakas & Lugaro (2016) metal-rich AGB models: elemental wind yield times
# isotopic mix fraction gives the constant SLR wind fraction
# (agb-wind-calc.py:20-26 uses the same quantities)
FRACTIONS = {
    # mass: (al26_frac, fe60_frac) = (al_yield * al26_mix, fe_yield * fe60_mix)
    3.0: (2.68906e-04 * 2.28e-03, 6.35719e-03 * 6.74e-06),
    5.0: (5.05140e-04 * 9.47e-03, 1.14482e-02 * 9.55e-04),
    6.0: (6.25450e-04 * 4.24e-02, 1.41060e-02 * 1.14e-03),
    7.0: (7.34474e-04 * 7.29e-02, 1.67203e-02 * 7.11e-04),
}
N_SAMPLES = 1024


def generate(mass: float, out_dir: str) -> str:
    import jax.numpy as jnp

    from al26.models.stellar import evolution as st
    from al26.units import MYR_TO_YR

    m0 = jnp.asarray(mass)
    t0 = float(st.agb_t_start(m0))
    t1 = float(st.agb_t_end(m0))
    m_enter = float(st.agb_m_enter(m0))
    times = np.linspace(t0, t1, N_SAMPLES)
    rates = np.asarray(st.agb_mdot(m0, jnp.asarray(times)))  # Msun/Myr
    rates_yr = rates / MYR_TO_YR                              # Msun/yr
    # cumulative PHASE loss by trapezoid (sampled-total semantics); the
    # recorded cumulative columns add the pre-AGB loss m0 - m_enter, as
    # the shipped tables do (their star_total_mass_loss starts nonzero)
    cum_phase = np.concatenate([[0.0], np.cumsum(
        0.5 * (rates[1:] + rates[:-1]) * np.diff(times))])
    cum = (mass - m_enter) + cum_phase
    star_mass = m_enter - cum_phase
    f_al, f_fe = FRACTIONS[mass]

    # :g keeps the shipped integer names (3 -> "3") while a future
    # non-integer mass (6.5) gets its own file instead of silently
    # truncating onto the 6 Msun table
    path = os.path.join(out_dir, f"agb_slr_{mass:g}_msol.csv")
    cols = ["t", "star_mass", "26al_mass_loss_rate", "60fe_mass_loss_rate",
            "star_mass_loss_rate", "26al_total_mass_loss",
            "60fe_total_mass_loss", "star_total_mass_loss"]
    with open(path, "w") as f:
        f.write(",".join(cols) + "\n")
        for i in range(N_SAMPLES):
            row = [times[i] - t0, star_mass[i],
                   rates_yr[i] * f_al, rates_yr[i] * f_fe, rates_yr[i],
                   cum[i] * f_al, cum[i] * f_fe, cum[i]]
            f.write(",".join(repr(float(v)) for v in row) + "\n")
    return path


def main(out_dir: str = "agb_wind_generated") -> None:
    os.makedirs(out_dir, exist_ok=True)
    for mass in FRACTIONS:
        print("wrote", generate(mass, out_dir))


if __name__ == "__main__":
    main(*sys.argv[1:])
