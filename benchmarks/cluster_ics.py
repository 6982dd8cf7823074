"""Visual check of cluster initial conditions (working replacement for the
reference's stale bench/cluster.py, which imports pre-rename symbols).
Renders Plummer and fractal realizations side by side."""
import os
import sys

# `python benchmarks/<script>.py` puts benchmarks/ (not the repo root) on
# sys.path — same bootstrap as the scripts/ entry points
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import numpy as np


def main(outname: str = "cluster-ics.png", n: int = 2000) -> None:
    n = int(n)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from al26.models.fractal import fractal_positions_velocities
    from al26.models.plummer import plummer_positions_velocities

    rng = np.random.default_rng(0)
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    p_pos, _ = plummer_positions_velocities(rng, n, 1.0, n * 0.5)
    axes[0].scatter(p_pos[:, 0], p_pos[:, 1], s=1)
    axes[0].set_title("Plummer")
    for ax, d in ((axes[1], 1.6), (axes[2], 2.6)):
        f_pos, _ = fractal_positions_velocities(rng, n, 1.0, n * 0.5, d)
        ax.scatter(f_pos[:, 0], f_pos[:, 1], s=1)
        ax.set_title(f"Fractal D={d}")
    for ax in axes:
        ax.set_aspect("equal")
        ax.set_xlim(-3, 3)
        ax.set_ylim(-3, 3)
    plt.savefig(outname, dpi=130, bbox_inches="tight")
    print("wrote", outname)


if __name__ == "__main__":
    main(*sys.argv[1:])
