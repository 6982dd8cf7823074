"""Benchmark phases: pairwise force throughput (Gpairs/s) and wall-clock
per simulated Myr, measured on an NVIDIA GPU.

The orchestrator (`python bench.py`) never imports JAX: it runs every
measurement as a subprocess PHASE (`python bench.py --phase NAME k=v ...`)
under its own timeout, one at a time, so only one process holds the card.
It prints ONE JSON line to stdout for the headline (the Pallas kernel's
acc+jerk+pot throughput at N=131072, row-sharded over all cards when more
than one is attached), naming the platform, device kind, card and power
limit; secondary rows stream to stderr, the last stderr line being a
machine-readable `# SUMMARY {json}`. It exits non-zero when the headline
phase fails or JAX finds no GPU: a measurement that finds no card fails,
it does not fall back.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N_BENCH = 131072
ITERS = 5


# ===========================================================================
# Worker phases (subprocess side; jax imported lazily here only)
# ===========================================================================

def _jax_setup():
    sys.path.insert(0, REPO)
    from al26.ops.backend import enable_compile_cache

    enable_compile_cache()
    import jax
    return jax


def _sync(x) -> None:
    import jax
    jax.block_until_ready(x)


def phase_headline(n: int = N_BENCH) -> dict:
    """Best-iteration force throughput of the Pallas tiled acc+jerk+pot
    kernel at N_BENCH (row-sharded over all attached devices when more
    than one is present). `n` is overridable so the fake-mesh CPU dryrun
    (tests) can exercise the sharded branch at toy size."""
    jax = _jax_setup()
    import jax.numpy as jnp
    import numpy as np

    n_dev = len(jax.devices())
    rng = np.random.default_rng(0)
    if n_dev > 1:
        from al26.parallel.sharded import make_mesh, sharded_acc_jerk_pot

        n = -(-n // n_dev) * n_dev
        mesh = make_mesh(n_dev)
        f = lambda: sharded_acc_jerk_pot(pos, vel, mass, mesh, 0.125)
    else:
        from al26.ops.pallas_nbody import pallas_acc_jerk_pot

        # eps2=0.125: the simulation's own softening (BHTree parity, rc=1)
        f = lambda: pallas_acc_jerk_pot(pos, vel, mass, 0.125)
    pos = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    vel = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    mass = jnp.asarray(rng.uniform(0.1, 2.0, n), jnp.float32)
    _sync(f())
    best = float("inf")
    for _ in range(ITERS):
        t0 = time.perf_counter()
        _sync(f())
        best = min(best, time.perf_counter() - t0)
    dev = jax.devices()[0]
    return {"gpairs": n * n / best / 1e9, "ndev": n_dev,
            "platform": dev.platform, "device_kind": dev.device_kind}


def phase_wallclock(n: int, steps: int, integrator: str = "auto",
                    stride: int = 1, softened: int = 0,
                    force_impl: str = "auto", model: str = "plummer",
                    rc: float = 1.0) -> dict:
    """Full-physics step cadence at the reference dt (t_f=10 -> dt=0.01),
    on the production run_steps path for the given backend (force_impl=
    "tree" benches the Barnes-Hut tier end to end)."""
    _jax_setup()
    from al26.config import SimConfig
    from al26.sim import init_cluster, run_steps

    cfg = SimConfig(n=n, rc=rc, final_time=10.0, seed=1, dtype="f32",
                    model=model, integrator=integrator,
                    gravity_stride=stride, softened_virial=bool(softened),
                    force_impl=force_impl)
    t0 = time.time()
    state, aux, cfg = init_cluster(cfg)
    print(f"# init {time.time() - t0:.1f}s (integ={cfg.integrator} "
          f"kavg={cfg.tree_kavg})", flush=True)
    # warm with the SAME scan length (a different length is a new compile)
    t0 = time.time()
    s = run_steps(state, aux, cfg, steps, force_impl=cfg.force_impl)
    _sync(s)
    print(f"# warm+compile {time.time() - t0:.1f}s", flush=True)
    t0 = time.time()
    s = run_steps(s, aux, cfg, steps, force_impl=cfg.force_impl)
    _sync(s)
    wall = time.time() - t0
    return {"s_per_myr": wall / (steps * cfg.dt)}


def phase_tree_accuracy(n: int = 65536, theta: float = 0.75,
                        model: str = "fractal") -> dict:
    """On-device accuracy spot check of the tree tier vs the exact Pallas
    sweep: median and p99 of |a_tree - a_exact| / |a_exact| on the
    realised ICs."""
    _jax_setup()
    import jax.numpy as jnp
    import numpy as np

    from al26.config import SimConfig
    from al26.ops.pallas_nbody import pallas_acc_jerk_pot
    from al26.ops.tree import tree_acc_pot
    from al26.sim import init_cluster

    cfg = SimConfig(n=n, rc=1.0, final_time=10.0, seed=1, dtype="f32",
                    model=model, force_impl="tree", tree_theta=theta)
    state, aux, cfg = init_cluster(cfg)
    pos, mass = state.cluster.pos, state.cluster.mass
    a_x, _, _ = pallas_acc_jerk_pot(pos, pos * 0.0, mass, cfg.eps2)
    _sync(a_x)
    a_t, _, ovf = tree_acc_pot(pos, mass, cfg.eps2, theta=theta,
                               leaf=cfg.tree_leaf, kavg=cfg.tree_kavg)
    _sync(a_t)
    rel = np.linalg.norm(np.asarray(a_t - a_x), axis=1) / np.maximum(
        np.linalg.norm(np.asarray(a_x), axis=1), 1e-30)
    return {"median": float(np.median(rel)),
            "p99": float(np.percentile(rel, 99.0)),
            "overflow": bool(ovf)}


def phase_ensemble(n_real: int = 16, n: int = 1024,
                   steps: int = 20) -> dict:
    """Vmapped ensemble cadence (block-diagonal flattened sweep)."""
    _jax_setup()
    import jax

    from al26.config import SimConfig
    from al26.parallel.ensemble import (
        ensemble_run_steps, init_ensemble, make_ensemble_mesh,
        shard_ensemble,
    )

    cfg = SimConfig(n=n, rc=1.0, final_time=10.0, seed=1, dtype="f32")
    bs, ba, cfgs = init_ensemble(cfg, n_real)
    mesh = None
    if n_real % len(jax.devices()) == 0:
        mesh = make_ensemble_mesh()
        bs, ba = shard_ensemble(bs, ba, mesh)
    out = ensemble_run_steps(bs, ba, cfgs[0], steps, mesh=mesh)
    _sync(out.cluster.pos)
    t0 = time.time()
    out = ensemble_run_steps(out, ba, cfgs[0], steps, mesh=mesh)
    _sync(out.cluster.pos)
    return {"s_per_myr": (time.time() - t0) / (steps * cfg.dt)}


def phase_ensemble2d(n: int = 8192, steps: int = 10) -> dict:
    """2-D (ens x rows) mesh cadence at its design point (few members x
    large N per member), cached production path. Needs > 1 device."""
    _jax_setup()
    import jax

    from al26.config import SimConfig
    from al26.parallel.ensemble import (
        ensemble2d_fresh_cache, ensemble_run_steps_2d_cached, init_ensemble,
        make_ensemble2d_mesh, shard_ensemble_2d,
    )

    n_rows = len(jax.devices()) // 2
    n = -(-n // n_rows) * n_rows
    cfg = SimConfig(n=n, rc=1.0, final_time=10.0, seed=1, dtype="f32")
    bs, ba, cfgs = init_ensemble(cfg, 2)
    cfg = cfgs[0]
    mesh = make_ensemble2d_mesh(2, n_rows)
    bs, ba = shard_ensemble_2d(bs, ba, mesh)
    cache = ensemble2d_fresh_cache(bs, cfg, mesh)
    out, cache = ensemble_run_steps_2d_cached(bs, cache, ba, cfg, steps,
                                              mesh)
    _sync(out.cluster.pos)
    t0 = time.time()
    out, cache = ensemble_run_steps_2d_cached(out, cache, ba, cfg, steps,
                                              mesh)
    _sync(out.cluster.pos)
    return {"s_per_myr": (time.time() - t0) / (steps * cfg.dt)}


def phase_ndev() -> dict:
    _jax_setup()
    import jax
    return {"ndev": len(jax.devices())}


PHASES = {
    "headline": phase_headline,
    "wallclock": phase_wallclock,
    "tree_accuracy": phase_tree_accuracy,
    "ensemble": phase_ensemble,
    "ensemble2d": phase_ensemble2d,
    "ndev": phase_ndev,
}

_COERCE = {"n": int, "steps": int, "stride": int, "softened": int,
           "n_real": int, "theta": float, "rc": float}


def run_worker(argv: list) -> None:
    """Run one phase and print its RESULT line; exit non-zero (before any
    measurement) when JAX finds no GPU."""
    jax = _jax_setup()
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"bench: no GPU (JAX runs on {platform})")
    print_result(argv)


def print_result(argv: list) -> None:
    """The worker protocol: phase NAME k=v ... -> ONE `RESULT {json}`."""
    name, kv = argv[0], argv[1:]
    kwargs = {}
    for item in kv:
        k, v = item.split("=", 1)
        kwargs[k] = _COERCE.get(k, str)(v)
    out = PHASES[name](**kwargs)
    print("RESULT " + json.dumps(out), flush=True)


# ===========================================================================
# Orchestrator (no jax; every measurement is a timeout-bounded subprocess)
# ===========================================================================

def run_phase(phase_args: list, timeout: float):
    """Run one worker phase under `timeout` seconds; relay its non-RESULT
    output to stderr; return the parsed RESULT dict or None."""
    cmd = [sys.executable, os.path.abspath(__file__), "--phase"] + phase_args
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, timeout=timeout, capture_output=True,
                              text=True, cwd=REPO)
    except subprocess.TimeoutExpired:
        print(f"# phase {phase_args[0]} TIMED OUT after {timeout:.0f}s",
              file=sys.stderr)
        return None
    result = None
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            result = json.loads(line[len("RESULT "):])
        elif line.strip():
            print(f"# [{phase_args[0]}] {line}", file=sys.stderr)
    if result is None:
        errtail = proc.stderr.strip().splitlines()[-4:]
        print(f"# phase {phase_args[0]} FAILED rc={proc.returncode} "
              f"({time.time() - t0:.0f}s):", file=sys.stderr)
        for ln in errtail:
            print(f"#   {ln}", file=sys.stderr)
    return result


def main() -> int:
    from chip_smoke import card_line

    card = card_line()
    r = run_phase(["headline"], 600.0)
    if r is None:
        print("bench: the headline phase failed (see stderr)",
              file=sys.stderr)
        return 1
    n_dev = r["ndev"]
    print(json.dumps({
        "metric": (f"pairwise force throughput (acc+jerk+pot, N={N_BENCH}, "
                   f"{n_dev} device(s), row-sharded when > 1)"),
        "value": round(r["gpairs"], 2),
        "unit": "Gpairs/s",
        "platform": r["platform"],
        "device_kind": r["device_kind"],
        "card": card,
    }), flush=True)
    summary: dict = {"gpairs": round(r["gpairs"], 2), "ndev": n_dev,
                     "card": card}

    # ---- secondaries (each its own phase and timeout) --------------------
    rows = [
        ("tree_ladder_fractal_409600", ["wallclock", "n=409600",
                                        "steps=8", "force_impl=tree",
                                        "stride=4", "softened=1",
                                        "model=fractal"], 900.0,
         "s_per_myr",
         "N=409600 fractal, tree tier + full opt-in ladder (stride 4, "
         "softened virial)"),
        ("exact_ladder_fractal_409600", ["wallclock", "n=409600",
                                         "steps=8", "stride=4",
                                         "softened=1", "model=fractal"],
         600.0, "s_per_myr",
         "N=409600 fractal, exact full opt-in ladder (stride 4, "
         "softened virial) — same ICs as the tree rows"),
        ("tree_fractal_409600", ["wallclock", "n=409600", "steps=5",
                                 "force_impl=tree", "model=fractal"],
         900.0, "s_per_myr",
         "N=409600 fractal, tree tier auto defaults"),
        ("tree_409600", ["wallclock", "n=409600", "steps=5",
                         "force_impl=tree"], 900.0, "s_per_myr",
         "N=409600 Plummer, tree tier (the MAC-hostile IC)"),
        ("exact_ladder_409600", ["wallclock", "n=409600", "steps=8",
                                 "stride=4", "softened=1"], 600.0,
         "s_per_myr",
         "N=409600 Plummer, exact full opt-in ladder (stride 4, softened "
         "virial)"),
        ("tree_acc_65536", ["tree_accuracy", "n=65536"], 420.0, "median",
         "tree-vs-exact relative force error at N=65536 (median; fractal "
         "ICs, theta=0.75)"),
        ("auto_1024", ["wallclock", "n=1024", "steps=100"], 300.0,
         "s_per_myr", "N=1024 auto defaults"),
        ("auto_10240", ["wallclock", "n=10240", "steps=50"], 300.0,
         "s_per_myr", "N=10240 auto defaults"),
        ("auto_102400", ["wallclock", "n=102400", "steps=10"], 420.0,
         "s_per_myr", "N=102400 auto defaults"),
        ("ladder_102400", ["wallclock", "n=102400", "steps=10", "stride=4",
                           "softened=1"], 300.0, "s_per_myr",
         "N=102400 full opt-in ladder (stride 4, softened virial)"),
        ("exact_409600", ["wallclock", "n=409600", "steps=5"], 600.0,
         "s_per_myr", "N=409600 auto defaults (exact, one device)"),
        ("ens_16", ["ensemble", "n_real=16"], 300.0, "s_per_myr",
         "16-realization ensemble (N=1024)"),
        ("ens_64", ["ensemble", "n_real=64"], 300.0, "s_per_myr",
         "64-realization ensemble (N=1024, the campaign row)"),
        ("tree_1m", ["wallclock", "n=1048576", "steps=3",
                     "force_impl=tree", "model=fractal"], 900.0,
         "s_per_myr", "N=1048576 fractal, tree tier auto (one device)"),
        ("tree_ladder_1m", ["wallclock", "n=1048576", "steps=4",
                            "force_impl=tree", "stride=4", "softened=1",
                            "model=fractal"], 900.0, "s_per_myr",
         "N=1048576 fractal, tree tier + full opt-in ladder (one device)"),
        ("exact_1m", ["wallclock", "n=1048576", "steps=2",
                      "model=fractal"], 900.0, "s_per_myr",
         "N=1048576 fractal, exact auto"),
    ]
    if n_dev > 1:
        rows.append(("ens2d", ["ensemble2d"], 420.0, "s_per_myr",
                     f"2-D (2 ens x {n_dev // 2} rows) mesh, N=8192/member"))

    for key, args, est, field, label in rows:
        r = run_phase(args, est)
        if r is None:
            continue
        if field == "median":
            print(f"# {label}: median {r['median']:.2e}, p99 "
                  f"{r['p99']:.2e}, overflow={r['overflow']}",
                  file=sys.stderr)
            summary[key] = r
        else:
            print(f"# {label}: {r[field]:.3f} s/Myr", file=sys.stderr)
            summary[key] = round(r[field], 3)
    print("# SUMMARY " + json.dumps(summary), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--phase":
        run_worker(sys.argv[2:])
    else:
        sys.exit(main())
