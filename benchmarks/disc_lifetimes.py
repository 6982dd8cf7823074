"""Disc-lifetime distribution check (working replacement for the
reference's stale bench/disc.py): histogram of draws vs the analytic
exponential pdf with mean 2.885 Myr."""
import os
import sys

# `python benchmarks/<script>.py` puts benchmarks/ (not the repo root) on
# sys.path — same bootstrap as the scripts/ entry points
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import numpy as np


def main(outname: str = "disc-lifetimes.png", n: int = 100_000) -> None:
    n = int(n)  # CLI passes a string
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from al26.models.discs import DISK_LIFETIME_MEAN_MYR, draw_disk_lifetimes

    rng = np.random.default_rng(0)
    tau = draw_disk_lifetimes(rng, n)
    x = np.linspace(0, 20, 400)
    pdf = np.exp(-x / DISK_LIFETIME_MEAN_MYR) / DISK_LIFETIME_MEAN_MYR
    plt.figure(figsize=(5, 3.5))
    plt.hist(tau, bins=100, range=(0, 20), density=True, alpha=0.6,
             label="draws")
    plt.plot(x, pdf, "k-", label=f"Exp({DISK_LIFETIME_MEAN_MYR} Myr)")
    plt.xlabel("Disc lifetime (Myr)")
    plt.ylabel("pdf")
    plt.legend()
    plt.savefig(outname, dpi=130, bbox_inches="tight")
    print("wrote", outname, f"(mean {tau.mean():.3f} Myr)")


if __name__ == "__main__":
    main(*sys.argv[1:])
