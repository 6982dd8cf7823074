"""Cumulative 26Al wind yield vs stellar age for a grid of massive stars.

Equivalent of the reference's root wind-ratio.py / limongi-chieffi-2018/
wind-ratio.py analysis scripts (SeBa-driven there): for each initial mass,
integrate wind_ratio * mdot(t) over time and plot/print the cumulative SLR
release alongside the lifetime total from the LC18 tables.

Usage: python scripts/wind_ratio.py [out.pdf] [mass_tracks] [yields_vel]
(also prints a text table; mass_tracks selects the stellar track
family — lc18 default, or e.g. seba for the reference-outcome runs,
whose wind budgets are orders of magnitude smaller. yields_vel selects
the LC18 yield-table reduction like cfg.yields_vel: 300 by default for
EVERY track family — the reference itself pairs vel=300 yields with
SeBa tracks — pass 0/150 alongside lc18_vel0/lc18_vel150 for the fully
self-consistent non-rotating/150 km/s analysis)
"""
from __future__ import annotations

import os
import sys

# force CPU + x64: a host-side analysis table has no business compiling
# on the accelerator (same pin as gen_golden_stats/gen_agb_tables)
os.environ.pop("JAX_PLATFORMS", None)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

# `python scripts/wind_ratio.py` puts scripts/ (not the repo root) on
# sys.path — same bootstrap as scripts/gen_golden_stats.py
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(outname: str = "wind-ratio.pdf",
         mass_tracks: str = "lc18", yields_vel: int | str = 300) -> None:
    import jax.numpy as jnp

    from al26.models.stellar import evolution as st
    from al26.models.yields import calc_slr_yield, read_slrs

    slrs = read_slrs(vel=int(yields_vel))
    al = slrs["Al26"]
    masses = [20.0, 25.0, 30.0, 40.0, 60.0]
    curves = {}
    print(f"{'mass':>6} {'t_SN (Myr)':>11} {'wind 26Al (Msun)':>17} "
          f"{'ratio of table':>15}")
    for m in masses:
        m0 = jnp.asarray(m)
        t_cc = float(st.t_sn(m0, tracks=mass_tracks))
        wy = calc_slr_yield(m, al.wind_mass, al.wind_yield)
        twl = float(st.total_wind_loss(m0, tracks=mass_tracks))
        ratio = wy / twl if twl > 0 else 0.0
        ts = np.linspace(0.0, t_cc * 0.99999, 2048)
        rates = np.asarray(
            st.wind_mdot(m0, jnp.asarray(ts), tracks=mass_tracks)
        ) * ratio
        cum = np.concatenate([[0.0], np.cumsum(
            0.5 * (rates[1:] + rates[:-1]) * np.diff(ts))])
        curves[m] = (ts, cum)
        print(f"{m:6.1f} {t_cc:11.2f} {cum[-1]:17.4e} {cum[-1] / wy:15.3f}")

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure(figsize=(5, 3.5))
        for m, (ts, cum) in curves.items():
            plt.semilogy(ts, np.maximum(cum, 1e-12),
                         label=rf"{int(m)} $M_\odot$")
        plt.xlabel("Age (Myr)")
        plt.ylabel(r"Cumulative $^{26}$Al wind yield ($M_\odot$)")
        plt.legend()
        plt.grid(which="both", linestyle=":", alpha=0.3)
        plt.savefig(outname, bbox_inches="tight")
        print("wrote", outname)
    except ImportError:
        pass


if __name__ == "__main__":
    main(*sys.argv[1:])
