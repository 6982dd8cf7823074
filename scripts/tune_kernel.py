"""Time the Pallas sweep kernel's tile configurations, and XLA's plain
sweep, at the three shapes the simulator calls it with (run on the GPU):

  full   N=131072, every star a row (acc + jerk + raw potential)
  rows   512 scattered rows x N=102400 (the hermite4_block subcycle)
  group  64 realizations x 1024 stars, one flattened block-diagonal sweep

Each candidate is compiled, checked against the float64 reference on
sampled rows, and timed (best of 5, warm). Prints one line per candidate.

    python scripts/tune_kernel.py
"""
from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import (  # noqa: E402
    best_time, card_line, f64_rows, scaled_err, system,
)

CANDIDATES = [
    # (block_i, block_j, num_warps, num_stages)
    (16, 16, 2, 2), (16, 32, 2, 2), (16, 32, 4, 2), (32, 16, 4, 2),
    (32, 32, 4, 2), (32, 32, 8, 2), (16, 64, 4, 2), (32, 32, 4, 3),
    (64, 32, 8, 2),
]
SPLITS = [264, 528, 1056, 2112, 4224]   # min_programs for the rows shape


def main() -> int:
    card = card_line()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from al26.ops.nbody import _row_block_acc_jerk_pot, acc_jerk_pot_chunked
    from al26.ops.pallas_nbody import (
        TILES, Tiles, call_kind, pallas_acc_jerk_pot_rows,
    )
    from al26.units import G_INTERNAL

    dev = jax.devices()[0]
    print(f"card: {card}; jax {dev.platform} {dev.device_kind} "
          f"x{len(jax.devices())}", flush=True)
    rng = np.random.default_rng(0)

    def sweep(t, eps2, group_size, pos, vel, mass, ids):
        """The kernel with tiles `t` on rows `ids`, gathers inside one
        jitted call (an eager gather costs milliseconds of host time).
        TILES is read at trace time, so the entry is swapped and JAX's
        caches cleared first."""
        TILES[call_kind(ids.shape[0], pos.shape[0], group_size)] = t
        jax.clear_caches()
        g = jax.jit(lambda p, v, m, i: pallas_acc_jerk_pot_rows(
            p[i], v[i], i, p, v, m, eps2=eps2, group_size=group_size,
            pot_eps2=1e-30))
        return lambda: g(pos, vel, mass, ids)

    def shape_case(name, n, rows, group_size, eps2, min_programs_list):
        pos, vel, mass = system(n, seed=1)
        if group_size:
            pos = pos + jnp.repeat(
                jnp.asarray(rng.normal(size=(n // group_size, 3)) * 50.0,
                            jnp.float32), group_size, axis=0)
        ids = jnp.asarray(rows, jnp.int32)
        sample = np.sort(rng.choice(len(rows), size=min(256, len(rows)),
                                    replace=False))
        ref = f64_rows(pos, vel, mass, np.asarray(rows)[sample], eps2,
                       pot_eps2=1e-30, group_size=group_size)
        pairs = len(rows) * (group_size if group_size else n)
        for c in CANDIDATES:
            for mp in min_programs_list:
                t = Tiles(*c, mp)
                f = sweep(t, eps2, group_size, pos, vel, mass, ids)

                try:
                    a, j, p = f()
                    err = [scaled_err(np.asarray(x)[sample], r)
                           for x, r in zip((a, j, p), ref)]
                    sec = best_time(f)
                except Exception as e:  # a refused config is a result here
                    print(f"{name} {t}: FAILED {type(e).__name__}: "
                          f"{str(e).splitlines()[0][:200]}", flush=True)
                    continue
                rate = pairs / sec / 1e9
                print(f"{name} {tuple(t)}: {sec * 1e3:.3f} ms "
                      f"{rate:.1f} Gpairs/s err acc {err[0]:.2e} jerk "
                      f"{err[1]:.2e} pot {err[2]:.2e}", flush=True)
        return pos, vel, mass, ids

    n = 131072
    pos, vel, mass, _ = shape_case("full", n, np.arange(n), 0, 0.125, [264])
    xla = jax.jit(lambda p, v, m: acc_jerk_pot_chunked(p, v, m, 0.125))
    sec = best_time(lambda: xla(pos, vel, mass))
    print(f"full XLA chunked f32: {sec * 1e3:.3f} ms "
          f"{n * n / sec / 1e9:.1f} Gpairs/s", flush=True)

    n = 102400
    rows = np.sort(rng.choice(n, size=512, replace=False))
    pos, vel, mass, ids = shape_case("rows", n, rows, 0, 0.125, SPLITS)
    xla_rows = jax.jit(lambda i, p, v, m: _row_block_acc_jerk_pot(
        p[i], v[i], p, v, m, 0.125, G_INTERNAL, i, with_pot=False))
    sec = best_time(lambda: xla_rows(ids, pos, vel, mass))
    print(f"rows XLA f32: {sec * 1e3:.3f} ms", flush=True)

    shape_case("group", 65536, np.arange(65536), 1024, 0.125, [264])
    return 0


if __name__ == "__main__":
    sys.exit(main())
