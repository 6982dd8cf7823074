"""Smoke run of the simulator on one NVIDIA GPU, through the entry points
a user calls.

    python chip_smoke.py            # one card: phases 1-5 below
    python chip_smoke.py --multi    # four cards: the sharded paths only

Phases (one card):
  1. the tests marked `gpu`, in a child process that exits before this
     process first touches JAX (one JAX process per card);
  2. the Pallas sweep kernel at real widths against a float64 numpy
     reference on sampled rows, then its time against XLA's plain sweep;
  3. one large cluster through sim.driver.run (hermite4_block, the
     kernel, the force cache) with checkpoints, and a resume;
  4. the 64 x 1024 campaign through run_ensemble (flat group-window
     kernel) with saves in the pt-* layout;
  5. the tree tier (XLA near field) at N=65536: its force error against
     the exact kernel, printed only.

With --multi (four cards): the row-sharded exact path (force_impl
sharded and ring, N=131072, hermite4_block, 10 steps) and the 64 x 1024
ensemble sharded over the cards (cached leapfrog, and hermite4_block
without the cache), each compared with the same run on device 0 alone in
the same process.

The script exits non-zero if JAX finds no GPU or any phase fails; its
last line is one JSON object naming the device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
# max-norm-scaled error ceiling of the f32 kernel against float64: f32
# accumulation over ~1.3e5 terms, no TF32 anywhere
KERNEL_TOL = 1e-4
# max-norm-scaled difference of a 4-card run from the one-card run after
# 10-20 steps: the same f32 arithmetic summed in another order, grown by
# the integration
MULTI_TOL = 1e-3


def card_line() -> str:
    """`name, power.limit` of the card(s), read without touching JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    lines = out.stdout.strip().splitlines()
    return lines[0] if len(set(lines)) == 1 else "; ".join(lines)


def f64_rows(pos, vel, mass, rows, eps2, pot_eps2=None, group_size=0,
             chunk=16):
    """Plain float64 reference: (acc, jerk, pot) on the star indices
    `rows` from all of (pos, vel, mass), numpy on the host."""
    import numpy as np

    from al26.units import G_INTERNAL as G

    from concurrent.futures import ThreadPoolExecutor

    pos = np.asarray(pos, np.float64)
    vel = np.asarray(vel, np.float64)
    mass = np.asarray(mass, np.float64)
    cols = np.arange(pos.shape[0])

    def block(r):
        dx = pos[None] - pos[r][:, None]
        dv = vel[None] - vel[r][:, None]
        d2 = np.sum(dx * dx, axis=-1)
        ok = cols[None] != r[:, None]
        if group_size:
            ok &= cols[None] // group_size == r[:, None] // group_size
        inv_r = np.where(ok, 1.0 / np.sqrt(np.where(ok, d2, 1.0) + eps2), 0.0)
        w = mass * inv_r ** 3
        s = 3.0 * np.sum(dx * dv, axis=-1) * inv_r ** 2
        if pot_eps2 is not None:
            inv_r = np.where(ok, 1.0 / np.sqrt(np.where(ok, d2, 1.0)
                                               + pot_eps2), 0.0)
        return (np.sum(w[..., None] * dx, axis=1),
                np.sum(w[..., None] * (dv - s[..., None] * dx), axis=1),
                -np.sum(mass * inv_r, axis=1))

    chunks = [np.asarray(rows[k:k + chunk])
              for k in range(0, len(rows), chunk)]
    with ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 1)) as ex:
        parts = list(ex.map(block, chunks))
    return tuple(G * np.concatenate([p[i] for p in parts]) for i in range(3))


def scaled_err(x, ref) -> float:
    """max |x - ref| / max |ref| (the max-norm-scaled error)."""
    import numpy as np

    x = np.asarray(x, np.float64)
    return float(np.max(np.abs(x - ref)) / np.max(np.abs(ref)))


def best_time(fn, reps: int = 5) -> float:
    """Best wall time of `reps` calls of `fn` (warm: one call first),
    each ending in jax.block_until_ready."""
    import jax

    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def system(n: int, seed: int):
    """A Plummer-like test system (unit scale) as f32 device arrays."""
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.default_rng(seed)
    u = rng.uniform(0.01, 0.99, n)
    r = 1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0)      # Plummer radii
    d = rng.normal(size=(n, 3))
    pos = d * (r / np.linalg.norm(d, axis=1))[:, None]
    vel = 0.5 * rng.normal(size=(n, 3))
    mass = rng.uniform(0.1, 2.0, n)
    f32 = jnp.float32
    return (jnp.asarray(pos, f32), jnp.asarray(vel, f32),
            jnp.asarray(mass, f32))


def sample_rows(n: int, k: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n, size=min(k, n), replace=False))


def check_kernel(label, card, out, ref, with_jerk=True) -> dict:
    """Max-norm-scaled errors of (acc, jerk, pot) against the f64 rows."""
    names = ("acc", "jerk", "pot")
    errs = {nm: scaled_err(o, r) for nm, o, r in zip(names, out, ref)
            if with_jerk or nm != "jerk"}
    print(f"kernel {label}: max-norm-scaled error vs f64 "
          + " ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (ceiling {KERNEL_TOL:g}) [{card}]", flush=True)
    bad = {k: v for k, v in errs.items() if not v < KERNEL_TOL}
    if bad:
        raise AssertionError(f"kernel {label}: error above {KERNEL_TOL}: "
                             f"{bad}")
    return errs


def phase_gpu_tests(card: str) -> None:
    """The `gpu`-marked tests, in a child that exits before this process
    first touches JAX."""
    import glob

    env = dict(os.environ, JAX_PLATFORMS="cuda")
    # only the modules that hold gpu tests: the rest may import packages
    # this machine does not have
    files = [f for f in sorted(glob.glob(os.path.join(REPO, "tests",
                                                      "test_*.py")))
             if "pytest.mark.gpu" in open(f).read()]
    r = subprocess.run(
        [sys.executable, "-m", "pytest", *files, "-m", "gpu", "-q",
         "-p", "no:cacheprovider"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    print(f"gpu tests: {tail} [{card}]", flush=True)
    if r.returncode != 0 or "passed" not in tail or "skipped" in tail:
        print(r.stdout[-4000:], r.stderr[-4000:], sep="\n")
        raise AssertionError(f"gpu-marked tests failed (rc={r.returncode})")


def phase_kernel(card: str) -> None:
    """The kernel at real widths against the f64 reference, then its time
    against XLA's plain sweep, and one hermite4_block step end to end."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from al26.ops.nbody import _row_block_acc_jerk_pot, acc_jerk_pot_chunked
    from al26.ops.pallas_nbody import pallas_acc_jerk_pot_rows
    from al26.units import G_INTERNAL

    def kernel(eps2, group_size=0, with_jerk=True):
        return jax.jit(lambda i, p, v, m: pallas_acc_jerk_pot_rows(
            p[i], v[i], i, p, v, m, eps2=eps2, with_jerk=with_jerk,
            group_size=group_size, pot_eps2=1e-30))

    # full sweep, N=131072
    n = 131072
    pos, vel, mass = system(n, seed=1)
    ids = jnp.arange(n, dtype=jnp.int32)
    rows = sample_rows(n, 2048, seed=2)
    k1 = kernel(0.125)
    for eps2 in (0.125, 1e-4):
        ref = f64_rows(pos, vel, mass, rows, eps2, pot_eps2=1e-30)
        for wj in (True, False):
            f = k1 if (eps2, wj) == (0.125, True) else kernel(eps2,
                                                              with_jerk=wj)
            out = f(ids, pos, vel, mass)
            check_kernel(f"full N={n} eps2={eps2:g} with_jerk={wj}", card,
                         [np.asarray(o)[rows] for o in out], ref, wj)
    t_k1 = best_time(lambda: k1(ids, pos, vel, mass))
    xla = jax.jit(lambda p, v, m: acc_jerk_pot_chunked(p, v, m, 0.125))
    t_xla = best_time(lambda: xla(pos, vel, mass))
    print(f"time full N={n} acc+jerk+pot: kernel {t_k1 * 1e3:.3f} ms "
          f"({n * n / t_k1 / 1e9:.1f} Gpairs/s), XLA chunked f32 "
          f"{t_xla * 1e3:.3f} ms ({n * n / t_xla / 1e9:.1f} Gpairs/s), "
          f"best of 5 [{card}]", flush=True)

    # the hermite4_block subcycle: 512 scattered rows of N=102400
    n = 102400
    pos, vel, mass = system(n, seed=3)
    rows = sample_rows(n, 512, seed=4)
    ids = jnp.asarray(rows, jnp.int32)
    ref = f64_rows(pos, vel, mass, rows, 0.125, pot_eps2=1e-30)
    k1 = kernel(0.125)
    check_kernel(f"rows 512 of N={n}", card, k1(ids, pos, vel, mass), ref)
    t_k1 = best_time(lambda: k1(ids, pos, vel, mass))
    xla = jax.jit(lambda i, p, v, m: _row_block_acc_jerk_pot(
        p[i], v[i], p, v, m, 0.125, G_INTERNAL, i, with_pot=False))
    t_xla = best_time(lambda: xla(ids, pos, vel, mass))
    print(f"time rows 512 x {n}: kernel {t_k1 * 1e3:.3f} ms, XLA f32 "
          f"{t_xla * 1e3:.3f} ms, best of 5 [{card}]", flush=True)

    # the flattened ensemble: 64 x 1024, group window
    gs, b = 1024, 64
    pos, vel, mass = system(gs * b, seed=5)
    rng = np.random.default_rng(6)
    pos = pos + jnp.repeat(jnp.asarray(rng.normal(size=(b, 3)) * 50.0,
                                       jnp.float32), gs, axis=0)
    ids = jnp.arange(gs * b, dtype=jnp.int32)
    rows = sample_rows(gs * b, 2048, seed=7)
    ref = f64_rows(pos, vel, mass, rows, 0.125, pot_eps2=1e-30,
                   group_size=gs)
    out = kernel(0.125, group_size=gs)(ids, pos, vel, mass)
    check_kernel(f"group {b} x {gs}", card,
                 [np.asarray(o)[rows] for o in out], ref)


def phase_step_timing(card: str) -> None:
    """One hermite4_block step at N=102400 through run_steps: the kernel
    with and without the force cache against XLA's plain sweep
    (force_impl='default', which has no cache), then a profile of the
    kernel step: kernel time per call shape and the rest."""
    import jax

    from al26.config import SimConfig
    from al26.sim import init_cluster, run_steps
    from al26.utils.trace import device_op_times

    cfg = SimConfig(n=102400, rc=1.0, final_time=0.2, n_plot=2,
                    steps_per_plot=10, seed=1, dtype="f32")
    state, aux, cfg = init_cluster(cfg)
    runs = {"kernel+cache": (cfg, "auto"),
            "kernel, no cache": (cfg.replace(force_cache=False), "pallas"),
            "XLA plain (no cache)": (cfg, "default")}
    times = {}
    for label, (c, impl) in runs.items():
        f = lambda: run_steps(state, aux, c, 1, force_impl=impl)
        times[label] = best_time(f, reps=3)
    print("time one hermite4_block step N=102400 through run_steps: "
          + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in times.items())
          + f", best of 3 [{card}]", flush=True)
    # only the sweep differs between these two
    if not times["kernel, no cache"] < times["XLA plain (no cache)"]:
        raise AssertionError("the kernel step is not faster than XLA's")
    with tempfile.TemporaryDirectory(prefix="al26-trace-") as d:
        with jax.profiler.trace(d):
            jax.block_until_ready(run_steps(state, aux, cfg, 1))
        ops, (t0, t1, busy) = device_op_times(d)
    kern = {k: v for k, v in ops.items() if k.startswith("nbody_")}
    rest = sum(v[1] for k, v in ops.items() if not k.startswith("nbody_"))
    print(f"profile of that kernel step: window {(t1 - t0) / 1e6:.3f} ms, "
          f"device busy {busy / 1e6:.3f} ms; "
          + ", ".join(f"{k} x{c} {t / 1e6:.3f} ms"
                      for k, (c, t) in sorted(kern.items()))
          + f"; other ops {rest / 1e6:.3f} ms [{card}]", flush=True)
    top = sorted(((t, k) for k, (c, t) in ops.items()
                  if not k.startswith("nbody_")), reverse=True)[:8]
    print("  largest other ops: " + ", ".join(
        f"{k} {t / 1e6:.3f} ms" for t, k in top), flush=True)


def phase_driver(card: str, workdir: str) -> None:
    """One large cluster through sim.driver.run with checkpoints, then a
    resume extended from 0.2 to 0.3 Myr."""
    import glob

    from al26.config import SimConfig
    from al26.sim.driver import run
    from al26.sim.step import _cacheable, _pallas_here

    cfg = SimConfig(n=102400, rc=1.0, final_time=0.2, n_plot=2,
                    steps_per_plot=10, seed=1, dtype="f32")
    os.chdir(workdir)
    t0 = time.time()
    res = run(cfg, progress=False)
    c = res.state.cluster
    if res.cfg.integrator != "hermite4_block":
        raise AssertionError(f"integrator {res.cfg.integrator}")
    if not (_pallas_here(res.cfg, c.n, c.pos.dtype, None, "auto")
            and _cacheable(res.cfg, c.n, c.pos.dtype, None, "auto")):
        raise AssertionError("auto did not resolve to the cached kernel")
    base = res.metadata.filename
    check_run(res, 20, base)
    print(f"driver N=102400 hermite4_block kernel+cache: 20 steps to "
          f"t={float(res.state.time)} Myr in {time.time() - t0:.1f} s "
          f"(init and compile included) [{card}]", flush=True)
    t0 = time.time()
    res2 = run(cfg.replace(reload=base, extend_final_time=0.3),
               progress=False)
    check_run(res2, 30, base)
    print(f"driver resume to t={float(res2.state.time)} Myr: "
          f"{time.time() - t0:.1f} s; files "
          f"{sorted(os.path.basename(p) for p in glob.glob(base + '-*'))[:6]}"
          f" [{card}]", flush=True)


def check_run(res, n_steps: int, base: str) -> None:
    import glob

    import numpy as np

    c = res.state.cluster
    steps = int(res.state.step_count)
    t = np.asarray(res.state.time)
    want_t = np.float32(n_steps) * np.float32(res.cfg.dt)
    if steps != n_steps or t != want_t:
        raise AssertionError(f"step_count {steps}, time {t!r}; want "
                             f"{n_steps}, {want_t!r}")
    for name in ("pos", "slr"):
        if not np.isfinite(np.asarray(getattr(c, name))).all():
            raise AssertionError(f"non-finite {name}")
    need = [base + "-yields.ubj.zst", base + "-cluster-yields.csv"]
    missing = [p for p in need if not os.path.exists(p)]
    if missing or not glob.glob(base + "-state-*.pkl.zst"):
        raise AssertionError(f"missing output files: {missing}")


def phase_ensemble(card: str, workdir: str) -> None:
    """The 64 x 1024 campaign through run_ensemble (flat group-window
    kernel, force cache) with saves in the pt-* layout."""
    import glob

    import numpy as np

    from al26.config import SimConfig
    from al26.parallel.ensemble import ensemble_cacheable
    from al26.sim.driver import run_ensemble

    cfg = SimConfig(n=1024, rc=1.0, final_time=0.2, n_plot=2,
                    steps_per_plot=10, seed=1, dtype="f32", ensemble=64)
    t0 = time.time()
    bs, dirs, wall = run_ensemble(cfg, progress=False, root=workdir)
    if not ensemble_cacheable(bs, cfg):
        raise AssertionError("the ensemble did not take the kernel path")
    want = [os.path.join(workdir, "pt-1.0-1024", "pt-1.0-1024", f"pt-{k}")
            for k in range(64)]
    if sorted(dirs) != sorted(want):
        raise AssertionError(f"unexpected layout: {dirs[:2]} ...")
    for d in dirs:
        k = os.path.basename(d)
        if not (glob.glob(os.path.join(d, f"{k}-state-*.pkl.zst"))
                and os.path.exists(os.path.join(d, f"{k}-yields.ubj.zst"))):
            raise AssertionError(f"missing files in {d}")
    if not (np.asarray(bs.step_count) == 20).all():
        raise AssertionError("step counts")
    for name in ("pos", "vel", "slr"):
        if not np.isfinite(np.asarray(getattr(bs.cluster, name))).all():
            raise AssertionError(f"non-finite {name}")
    print(f"ensemble 64 x 1024: 20 steps with saves in {wall:.1f} s "
          f"({time.time() - t0:.1f} s with init) [{card}]", flush=True)


def phase_tree(card: str) -> None:
    """The tree tier (XLA near field) at N=65536 fractal for 5 steps; its
    acceleration error against the exact kernel is printed, not bounded."""
    import numpy as np

    from al26.config import SimConfig
    from al26.ops.pallas_nbody import pallas_acc_jerk_pot
    from al26.ops.tree import tree_acc_pot
    from al26.sim import init_cluster, run_steps

    cfg = SimConfig(n=65536, rc=1.0, final_time=10.0, seed=1, dtype="f32",
                    model="fractal", force_impl="tree")
    t0 = time.time()
    state, aux, cfg = init_cluster(cfg)
    state = run_steps(state, aux, cfg, 5, force_impl="tree")
    pos, mass = state.cluster.pos, state.cluster.mass
    if not np.isfinite(np.asarray(pos)).all():
        raise AssertionError("tree run: non-finite positions")
    a_x, _, _ = pallas_acc_jerk_pot(pos, pos * 0.0, mass, cfg.eps2)
    a_t, _, ovf = tree_acc_pot(pos, mass, cfg.eps2, theta=cfg.tree_theta,
                               leaf=cfg.tree_leaf, kavg=cfg.tree_kavg)
    rel = (np.linalg.norm(np.asarray(a_t - a_x), axis=1)
           / np.maximum(np.linalg.norm(np.asarray(a_x), axis=1), 1e-30))
    print(f"tree N=65536 fractal, 5 steps ({cfg.integrator}, kavg "
          f"{cfg.tree_kavg}, overflow {bool(ovf)}): relative acc error vs "
          f"kernel median {np.median(rel):.3e}, p99 "
          f"{np.percentile(rel, 99):.3e}; {time.time() - t0:.1f} s "
          f"[{card}]", flush=True)


def phase_multi(card: str) -> None:
    """Four cards: the row-sharded exact path (sharded and ring) and the
    sharded 64 x 1024 ensemble, each against the same run on device 0."""
    import jax
    import numpy as np

    from al26.config import SimConfig
    from al26.parallel.ensemble import (
        ensemble_fresh_cache, ensemble_run_steps, ensemble_run_steps_cached,
        init_ensemble, make_ensemble_mesh, shard_ensemble,
    )
    from al26.parallel.sharded import make_mesh, shard_state_rows
    from al26.sim import init_cluster, run_steps

    devs = jax.devices()
    if len(devs) != 4:
        raise AssertionError(f"--multi needs 4 devices, found {len(devs)}")

    def scaled(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))

    def spread(x) -> int:
        return len(x.sharding.device_set)

    cfg = SimConfig(n=131072, rc=1.0, final_time=10.0, seed=1, dtype="f32",
                    integrator="hermite4_block")
    state, aux, cfg = init_cluster(cfg)
    t0 = time.time()
    one = jax.block_until_ready(run_steps(state, aux, cfg, 10))
    print(f"one card: N=131072 hermite4_block 10 steps "
          f"{time.time() - t0:.1f} s (compile included) [{card}]",
          flush=True)
    mesh = make_mesh(4)
    for impl in ("sharded", "ring"):
        st4 = shard_state_rows(state, mesh)
        t0 = time.time()
        out = jax.block_until_ready(
            run_steps(st4, aux, cfg.replace(mesh_shape=(4,)), 10, mesh=mesh,
                      force_impl=impl))
        ep = scaled(out.cluster.pos, one.cluster.pos)
        ev = scaled(out.cluster.vel, one.cluster.vel)
        print(f"4 cards {impl}: {time.time() - t0:.1f} s (compile "
              f"included); vs one card pos {ep:.3e} vel {ev:.3e} "
              f"(tolerance {MULTI_TOL:g}); output on {spread(out.cluster.pos)}"
              f" devices [{card}]", flush=True)
        if not (ep < MULTI_TOL and ev < MULTI_TOL) or spread(
                out.cluster.pos) != 4:
            raise AssertionError(f"{impl}: mesh run disagrees")

    ecfg = SimConfig(n=1024, rc=1.0, final_time=0.2, n_plot=2,
                     steps_per_plot=10, seed=1, dtype="f32")
    bs, ba, cfgs = init_ensemble(ecfg, 64)
    ecfg = cfgs[0]
    one, _ = ensemble_run_steps_cached(bs, ensemble_fresh_cache(bs, ecfg),
                                       ba, ecfg, 20)
    emesh = make_ensemble_mesh()
    bs4, ba4 = shard_ensemble(bs, ba, emesh)
    t0 = time.time()
    out, _ = ensemble_run_steps_cached(
        bs4, ensemble_fresh_cache(bs4, ecfg, emesh), ba4, ecfg, 20, emesh)
    jax.block_until_ready(out)
    ep = scaled(out.cluster.pos, one.cluster.pos)
    es = scaled(out.cluster.slr, one.cluster.slr)
    print(f"4 cards ensemble 64 x 1024, 20 steps: {time.time() - t0:.1f} s "
          f"(compile included); vs one card pos {ep:.3e} slr {es:.3e} "
          f"(tolerance {MULTI_TOL:g}); output on {spread(out.cluster.pos)} "
          f"devices [{card}]", flush=True)
    if not (ep < MULTI_TOL and es < MULTI_TOL) or spread(out.cluster.pos) != 4:
        raise AssertionError("ensemble: mesh run disagrees")

    # the uncached flat path (ensemble_run_steps): hermite4_block without
    # the force cache, so the full sweeps and the subcycle's row sweeps
    # both run over the sharded batch
    hcfg = ecfg.replace(integrator="hermite4_block", force_cache=False)
    one = ensemble_run_steps(bs, ba, hcfg, 10)
    t0 = time.time()
    out = jax.block_until_ready(
        ensemble_run_steps(bs4, ba4, hcfg, 10, mesh=emesh))
    ep = scaled(out.cluster.pos, one.cluster.pos)
    es = scaled(out.cluster.slr, one.cluster.slr)
    print(f"4 cards ensemble 64 x 1024 hermite4_block, no cache, 10 steps: "
          f"{time.time() - t0:.1f} s (compile included); vs one card pos "
          f"{ep:.3e} slr {es:.3e} (tolerance {MULTI_TOL:g}); output on "
          f"{spread(out.cluster.pos)} devices [{card}]", flush=True)
    if not (ep < MULTI_TOL and es < MULTI_TOL) or spread(out.cluster.pos) != 4:
        raise AssertionError("uncached ensemble: mesh run disagrees")
    for d in devs:
        peak = (d.memory_stats() or {}).get("peak_bytes_in_use", 0)
        print(f"  {d}: peak {peak / 2**30:.2f} GiB", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="four cards: the sharded paths only")
    args = ap.parse_args()
    card = card_line()
    print(f"card: {card}", flush=True)
    if not args.multi:
        run_phase("1 gpu tests", phase_gpu_tests, card)

    sys.path.insert(0, REPO)
    from al26.ops.backend import enable_compile_cache

    enable_compile_cache()
    import jax

    dev = jax.devices()[0]
    print(f"jax: platform {dev.platform}, device_kind {dev.device_kind}, "
          f"count {len(jax.devices())}", flush=True)
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {dev.platform}")
    if args.multi:
        run_phase("multi", phase_multi, card)
    else:
        run_phase("2 kernel", phase_kernel, card)
        run_phase("2 step timing", phase_step_timing, card)
        with tempfile.TemporaryDirectory(prefix="al26-smoke-") as work:
            try:
                run_phase("3 driver", lambda c: phase_driver(c, work), card)
                run_phase("4 ensemble", lambda c: phase_ensemble(c, work),
                          card)
            finally:
                os.chdir(REPO)
        run_phase("5 tree", phase_tree, card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


def run_phase(label: str, fn, card: str) -> None:
    t0 = time.time()
    print(f"== phase {label} [{card}]", flush=True)
    fn(card)
    print(f"== phase {label}: ok ({time.time() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    sys.exit(main())
