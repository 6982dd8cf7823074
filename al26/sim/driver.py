"""Run driver: checkpointed simulation loop + resume.

Mirrors the reference `main()` control flow (al26_nbody.py:1612-1766):
initialise (or reload) -> initial checkpoint #0 -> loop with a save every
`steps_per_plot` iterations -> final checkpoint. Between saves the physics
runs entirely on device via a scanned `run_steps`; the host only touches
data at checkpoint boundaries (the reference instead crosses 4 process
boundaries per step).

Save cadence parity: the reference saves on iterations where
n_iter % steps_per_plot == 0 (al26_nbody.py:1754-1758), i.e. after steps
1, 11, 21, ... — 100 checkpoints plus the initial one. We keep that cadence
and additionally write a final checkpoint at exactly t_f (the reference only
does so when float accumulation overshoots t_f and triggers a clamped
zero-length step, al26_nbody.py:820-825 — writing it always is strictly
more useful and format-identical).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..config import SimConfig
from ..io import checkpoint as ckpt
from ..io.compat import (Args, Converter, Metadata, Quantity,
                         cluster_to_particles, particles_to_cluster)
from ..io.yields_store import Yields
from ..state import SimState
from ..units import myr
from ..utils.timing import PhaseTimers, maybe_start_trace, maybe_stop_trace
from .init import SimAux, init_cluster
from .step import run_steps, run_steps_traj


@dataclass
class RunResult:
    state: SimState
    aux: SimAux
    cfg: SimConfig
    metadata: Metadata
    yields: Yields
    wall_time_s: float


def _metadata_from_cfg(cfg: SimConfig) -> Metadata:
    args = Args(**cfg.to_dict(),
                final_time_myr=cfg.final_time)
    md = Metadata(args, cfg.final_time, filename=cfg.filename)
    return md


def _yields_mode(cfg, final: bool) -> str:
    """Frames mode appends one O(N) frame per save and only writes the
    reference-format blob at the final save (io.yields_store docstring)."""
    if not getattr(cfg, "yields_frames", False):
        return "rewrite"
    return "both" if final else "frames"


def _save(base, metadata, converter, yields, state, cfg,
          increment=True, verbose=False, final=False):
    t_myr = float(state.time)
    metadata.update(t_myr, increment_checkpoint=increment)
    from ..state import cluster_to_numpy

    cluster_np = cluster_to_numpy(state.cluster)
    if getattr(cfg, "validate", True):
        from ..utils.validate import validate_cluster_dict

        validate_cluster_dict(cluster_np, t_myr,
                              cfg.low_mass_min, cfg.low_mass_max)
    particles = cluster_to_particles(cluster_np)
    yields.update_state(t_myr, particles)
    ckpt.save_checkpoint(
        base, metadata.most_recent_checkpoint, particles, converter,
        yields, metadata, verbose=verbose,
        yields_mode=_yields_mode(cfg, final),
    )


def _append_trajectory(rows: np.ndarray,
                       path: str = "interloper_trajectory.dat") -> None:
    """Append per-step interloper rows, reference format
    (al26_nbody.py:1030-1037): t_sim, t_agb, x, y, z, bary_dist — written
    only once the AGB clock is positive. (The reference accidentally writes
    its y coordinate into the z column, al26_nbody.py:1034; we write the
    real z.)"""
    active = rows[rows[:, 1] > 0.0]
    if len(active) == 0:
        return
    with open(path, "a") as f:
        for r in active:
            f.write("{:.3e},{:.3e},{:.3e},{:.3e},{:.3e},{:.3e}\n".format(*r))


def _rebuild_aux(cfg: SimConfig, cluster, data_dir=None) -> SimAux:
    """Reconstruct the fixed-shape aux bundle after a reload."""
    from .init import build_aux

    return build_aux(cfg, np.asarray(cluster.m0), cluster.pos.dtype,
                     data_dir, np.asarray(cluster.is_interloper))


def _drop_stale_state_files(base: str, k: int) -> None:
    """Delete state files numbered ABOVE the resumed checkpoint. A -nc K
    resume truncates the CSV/frames/blob to t_K, but the higher-numbered
    state files of the abandoned timeline would survive — and a LATER
    plain resume picks the global max (most_recent_checkpoint), silently
    restarting from the stale timeline while the yields artifacts track
    the new one."""
    import glob
    import re

    rx = re.compile(re.escape(base) + r"-state-(\d+)\.pkl\.zst$")
    for f in glob.glob(base + "-state-*"):
        m = rx.search(f)
        if m and int(m.group(1)) > k:
            os.remove(f)


def _reset_trajectory(resume_t: Optional[float],
                      path: str = "interloper_trajectory.dat") -> None:
    """Trajectory-file analogue of the CSV/frames truncation. Cold run:
    remove a stale file from a previous run in this cwd (the reference
    appends blindly across runs, al26_nbody.py:1030-1037; same-base
    reruns already truncate the CSV/frames/blob). Resume: drop rows with
    t_sim >= the resumed checkpoint time — STRICT, unlike the CSV's
    boundary-keeping truncation, because each row carries the PREVIOUS
    step's time (_traj_row uses s_old.time), so the resumed run's first
    step re-emits the row AT t_resume. Rows are written at %.3e (4
    significant digits); the compare happens in that quantised domain."""
    if resume_t is None:
        if os.path.exists(path):
            os.remove(path)
        return
    if not os.path.exists(path):
        return
    t_cut = float(f"{resume_t:.3e}")
    eps = 1e-9 * max(1.0, abs(t_cut))
    with open(path) as f:
        lines = f.readlines()
    keep = []
    for ln in lines:
        try:
            t = float(ln.split(",", 1)[0])
        except ValueError:
            keep.append(ln)
            continue
        if t < t_cut - eps:
            keep.append(ln)
    if len(keep) != len(lines):
        with open(path, "w") as f:
            f.writelines(keep)


def _bound_resumed_yields(yields: Yields, base: str, cfg: SimConfig,
                          t_myr: float) -> None:
    """Prepare a resumed yields store for writing: truncate the CSV's
    stale future rows (resume from an earlier checkpoint, -nc K; all
    modes), then in frames mode truncate stale future frames, seed the
    framed file from the blob history when only the reference-format
    blob exists (e.g. a reference-written run), and drop the per-star
    history from RAM (io.yields_store bounded mode)."""
    yields.truncate_csv(t_myr)
    if not getattr(cfg, "yields_frames", False):
        # rewrite mode restored the FULL history from the blob: a -nc
        # resume must drop the future snapshots here too, or update_state
        # appends the re-simulated ones after them and every rewrite
        # emits a non-monotonic time series (round-3 review finding)
        yields.truncate_memory(t_myr)
        return
    frames_path = ckpt.yields_frames_filename(base)
    if os.path.exists(frames_path):
        yields.truncate_frames(frames_path, t_myr)
    else:
        # blob-only resume: a -nc resume from an earlier checkpoint must
        # not seed the framed file with the blob's FUTURE snapshots (the
        # re-simulated run appends fresh ones — the series would go
        # non-monotonic)
        yields.truncate_memory(t_myr)
        yields.backfill_frames(frames_path)
    yields.bound()


def load_run(base: str, n_checkpoint: Optional[int] = None,
             override_cfg: Optional[SimConfig] = None,
             data_dir: Optional[str] = None):
    """Resume from checkpoint files (al26_nbody.py:1647-1656, 1734-1737).
    Returns (state, aux, cfg, metadata, yields, converter). `data_dir`
    reaches the aux rebuild (AGB wind tables) — an interloper run started
    with a custom table directory must resume from the SAME tables."""
    if n_checkpoint is None:
        n_checkpoint = ckpt.most_recent_checkpoint(base)
    particles, converter, yields, metadata = ckpt.load_checkpoint(
        base, n_checkpoint
    )
    metadata.update_access_time()
    cfg = override_cfg or SimConfig.from_checkpoint_dict(vars(metadata.args))
    dtype = jnp.float64 if cfg.dtype == "f64" else jnp.float32
    cluster = particles_to_cluster(particles, dtype=dtype)
    if not isinstance(converter, Converter):
        # reference-written file: the AMUSE nbody_to_si converter loads as
        # an opaque stub — rebuild ours so the next save can re-pickle it
        converter = Converter(
            cfg.rc, float(np.asarray(cluster.mass).sum())
        )
    t_myr = float(metadata.time.value_in(myr))
    state = SimState(
        cluster=cluster,
        time=jnp.asarray(t_myr, dtype),
        step_count=jnp.asarray(round(t_myr / cfg.dt), jnp.int32),
    )
    # resolve the integrator knobs exactly like a cold start: OUR
    # checkpoints store the resolved values (this is a no-op), but
    # reference-written metadata carries no integrator/k_fast/
    # leapfrog_n_sub keys — without this the step's last-ditch fallbacks
    # would pick e.g. k_fast = n//16 = 6400 at n=102400 instead of the
    # cold-start 512: a silently different trajectory and ~12x subcycle
    # cost after resume (round-3 review finding)
    from .init import resolve_integrator

    cfg = resolve_integrator(cfg, float(np.asarray(cluster.mass).sum()))
    aux = _rebuild_aux(cfg, cluster, data_dir)
    return state, aux, cfg, metadata, yields, converter


def run(cfg: SimConfig, progress: bool = True,
        data_dir: Optional[str] = None) -> RunResult:
    """Full checkpointed run (cold start or resume)."""
    t_wall0 = time.time()

    # capture BEFORE load_run replaces cfg with the checkpoint's restored
    # config (reference semantics, al26_nbody.py:1647) — whose own reload
    # field is empty
    reload_base = cfg.reload
    extend_t = cfg.extend_final_time
    fresh_verbose = cfg.verbose
    if extend_t is not None and not reload_base:
        raise ValueError(
            "extend_final_time is a resume directive: set reload too "
            "(a cold start takes its schedule from final_time/n_plot)"
        )
    if reload_base:
        state, aux, cfg, metadata, yields, converter = load_run(
            reload_base, cfg.n_checkpoint, data_dir=data_dir
        )
        # -v is a property of the INVOCATION, not the stored run: the
        # reference reads it from the fresh args on reload (its prints
        # all gate on the current argparse namespace). Physics/store
        # knobs stay restored.
        cfg = cfg.replace(verbose=fresh_verbose)
        if extend_t is not None:
            # `-r X -t_f T` extends the resumed run to ~T on the
            # ORIGINAL step grid (reference: al26_nbody.py:1638,786
            # reads t_f from the fresh invocation; see
            # SimConfig.extended_to for the dt-preserving divergence).
            # Write the new schedule into the stored args so the NEXT
            # resume continues the extended run, not the original one.
            cfg = cfg.extended_to(extend_t)
            if cfg.n_steps <= int(state.step_count):
                # a target at/behind the resumed time would be a silent
                # no-op (the loop takes zero steps and persists nothing)
                # — refuse loudly; the -nc path IS the truncation tool
                raise ValueError(
                    f"-t_f {extend_t} does not extend this resume: the "
                    f"checkpoint is already at t = {float(state.time)} "
                    f"Myr. To shorten a run, resume from an earlier "
                    f"checkpoint with -nc instead"
                )
            metadata.args.final_time = cfg.final_time
            metadata.args.n_plot = cfg.n_plot
            metadata.args.dt_override = cfg.dt_override
            metadata.t_f = Quantity(cfg.final_time, myr)
            if abs(cfg.final_time - extend_t) > 1e-9 * max(1.0, extend_t):
                print(f"# extend: final time snapped to the save grid: "
                      f"{extend_t} -> {cfg.final_time} Myr")
        # continue writing at the PATH the user pointed at, not at
        # metadata.filename: the metadata records only the original base
        # NAME, so a path-qualified resume ('-r out/sim' from another cwd)
        # would otherwise split the run's artifacts across two directories
        base = reload_base
        _bound_resumed_yields(yields, base, cfg, float(state.time))
        # a -nc K resume rewrites checkpoints K+1... — drop the abandoned
        # timeline's higher-numbered state files now, as the yields
        # artifacts were just truncated
        _drop_stale_state_files(base, metadata.most_recent_checkpoint)
        if cfg.orbax_dir:
            # same for the orbax tree, or its latest_step resumes the
            # abandoned timeline
            from ..io.orbax_backend import drop_steps_above

            drop_steps_above(cfg.orbax_dir, int(state.step_count))
    else:
        state, aux, cfg = init_cluster(cfg, data_dir)
        metadata = _metadata_from_cfg(cfg)
        base = metadata.filename
        converter = Converter(cfg.rc, float(np.asarray(state.cluster.mass).sum()))
        yields = Yields(base, bounded=bool(getattr(cfg, "yields_frames",
                                                   False)))
        # initial checkpoint #0 (al26_nbody.py:1741-1745)
        _save(base, metadata, converter, yields, state, cfg,
              increment=False, verbose=cfg.verbose)

    n_done = int(state.step_count)
    n_steps = cfg.n_steps
    spp = cfg.steps_per_plot

    bar = None
    if progress:
        try:
            from tqdm import tqdm
            bar = tqdm(total=cfg.final_time, desc="Simulation", unit="Myr",
                       initial=float(state.time))
        except ImportError:
            pass

    timers = PhaseTimers()
    maybe_start_trace()
    write_traj = cfg.interloper and cfg.interloper_trajectory
    if write_traj:
        # cold run: clear a previous run's rows in this cwd; resume: drop
        # rows beyond the resumed checkpoint (the trajectory analogue of
        # the CSV/frames truncation)
        _reset_trajectory(float(state.time) if reload_base else None)

    # optional multi-chip row sharding of a single large run
    mesh = None
    if cfg.mesh_shape:
        # round 5: force_impl='tree' runs under the mesh too
        # (parallel.tree_mesh: replicated tree, sharded far-field
        # targets + near-field pair list; hermite4_block-only,
        # validated at init)
        from ..parallel.sharded import make_mesh, shard_state_rows

        n_dev = int(np.prod(cfg.mesh_shape))
        n_total = state.cluster.n
        if n_total % n_dev != 0:
            raise ValueError(
                f"mesh_shape={cfg.mesh_shape}: star count {n_total} must "
                f"divide across {n_dev} devices (pad n or change the mesh)"
            )
        mesh = make_mesh(n_dev)
        state = shard_state_rows(state, mesh)

    # thread the force cache across checkpoint chunks so even a chunk's
    # first step reuses the previous chunk's closing O(N^2) evaluation
    from .step import (
        _cacheable, _resolve_integ, fresh_cache, run_steps_cached,
        run_steps_cached_strided, stride_active,
    )

    use_cache = _cacheable(
        cfg, state.cluster.n, state.cluster.pos.dtype, mesh, cfg.force_impl
    )
    # the stride's interior physics steps have no per-step row collection,
    # so trajectory runs stay unstrided (cached, though — round 3)
    use_stride = (not write_traj) and stride_active(
        cfg, state.cluster.n, state.cluster.pos.dtype, mesh, cfg.force_impl
    )
    cache = [None]

    def seed_cache(s):
        if cache[0] is None:
            cache[0] = fresh_cache(s, cfg,
                                   _resolve_integ(cfg, s.cluster.n), mesh,
                                   cfg.force_impl)

    def advance_steps(s, n):
        if write_traj:
            if use_cache:
                from .step import run_steps_traj_cached

                seed_cache(s)
                s, cache[0], rows = run_steps_traj_cached(
                    s, cache[0], aux, cfg, n, mesh, cfg.force_impl)
            else:
                s, rows = run_steps_traj(s, aux, cfg, n, mesh=mesh,
                                         force_impl=cfg.force_impl)
            _append_trajectory(np.asarray(rows))
            return s
        if use_cache:
            seed_cache(s)
            if use_stride:
                s, cache[0] = run_steps_cached_strided(
                    s, cache[0], aux, cfg, n, mesh, cfg.force_impl)
            else:
                s, cache[0] = run_steps_cached(s, cache[0], aux, cfg, n,
                                               mesh, cfg.force_impl)
            return s
        return run_steps(s, aux, cfg, n, mesh=mesh,
                         force_impl=cfg.force_impl)

    # background checkpoint writer: host serialisation overlaps the next
    # chunk's device compute (ordering-preserving; errors re-raised here)
    writer = None
    if getattr(cfg, "async_saves", True):
        from ..io.async_writer import AsyncCheckpointWriter

        writer = AsyncCheckpointWriter()

    def do_save(s, increment=True, final=False):
        if cfg.orbax_dir:
            # device-state tree FIRST, from the ORIGINAL (possibly
            # sharded) state: shards store per-host, nothing gathered —
            # handing it the gathered host copy below would defeat the
            # backend's no-gather contract (and device_get outright fails
            # on non-fully-addressable arrays on a multi-host slice)
            from ..io.orbax_backend import save_sharded_state

            save_sharded_state(cfg.orbax_dir, int(s.step_count), s, cfg)
        if writer is not None and mesh is not None:
            # gather the sharded state on the MAIN thread: a background
            # device->host pull racing the next chunk's collectives starves
            # XLA's in-process CPU rendezvous (20 s timeout -> hard abort)
            # on the virtual mesh; serialisation/compression still overlap
            import jax

            s = jax.device_get(s)
        job = lambda: _save(base, metadata, converter, yields, s, cfg,
                            increment=increment, verbose=cfg.verbose,
                            final=final)
        if writer is not None:
            writer.submit(job)
        else:
            job()

    try:
        k = n_done
        saved_final = False
        while k < n_steps:
            # one step, then save (reference cadence: save after steps
            # 1, 11, ...)
            if k % spp == 0:
                with timers.phase("physics"):
                    state = advance_steps(state, 1)
                k += 1
                with timers.phase("checkpoint"):
                    # a cadence save landing exactly on the last step
                    # (steps_per_plot=1, or n_steps % spp == 1) IS the
                    # final save — a second one would duplicate the t_f
                    # snapshot in the CSV/frames/blob
                    saved_final = k == n_steps
                    do_save(state, final=saved_final)
            else:
                chunk = min(spp - (k % spp), n_steps - k)
                with timers.phase("physics"):
                    state = advance_steps(state, chunk)
                k += chunk
            if bar is not None:
                bar.n = round(float(state.time), 6)
                bar.refresh()

        # final checkpoint at exactly t_f (skipped when the loop's last
        # cadence save already was it, or when a resume of an ALREADY
        # COMPLETE run took zero steps — its final artifacts exist)
        with timers.phase("checkpoint"):
            if not saved_final and k > n_done:
                do_save(state, final=True)
            if writer is not None:
                writer.close()
                writer = None
    finally:
        if writer is not None:  # unwinding on an exception: stop the worker
            try:
                writer.close()
            except RuntimeError:
                pass
    if bar is not None:
        bar.close()
    maybe_stop_trace()
    if cfg.verbose:
        print("phase timings:")
        print(timers.report())

    return RunResult(
        state=state, aux=aux, cfg=cfg, metadata=metadata, yields=yields,
        wall_time_s=time.time() - t_wall0,
    )


def load_ensemble(tag_root: str, n_checkpoint: Optional[int] = None,
                  data_dir: Optional[str] = None):
    """Reload every realization of a pt-grid ensemble (the directories
    run_ensemble writes): returns (states, auxes, cfgs, metas, yieldses,
    converters, sim_dirs), realizations sorted by their pt-<k> index.

    Extends the reference's single-run resume semantics
    (al26_nbody.py:1647-1656) across the ensemble axis."""
    import glob
    import re

    cand = sorted(glob.glob(os.path.join(tag_root, "**", "pt-*", ""),
                            recursive=True))
    rx = re.compile(r"pt-(\d+)[/\\]?$")
    sim_dirs = sorted(
        (d for d in cand
         if rx.search(d) and glob.glob(os.path.join(d, "*-state-*"))),
        key=lambda d: int(rx.search(d).group(1)),
    )
    if not sim_dirs:
        raise IOError(f"no pt-<k> realization folders under {tag_root!r}")
    states, auxes, cfgs, metas, yieldses, converters = [], [], [], [], [], []
    for d in sim_dirs:
        state_file = sorted(glob.glob(os.path.join(d, "*-state-*")))[0]
        base = re.sub(r"-state-\d+\.pkl\.zst$", "", state_file)
        s, a, c, md, ys, conv = load_run(base, n_checkpoint,
                                         data_dir=data_dir)
        states.append(s)
        auxes.append(a)
        cfgs.append(c)
        metas.append(md)
        yieldses.append(ys)
        converters.append(conv)
    integs = {(c.integrator, c.leapfrog_n_sub) for c in cfgs}
    if len(integs) != 1:
        raise ValueError(
            f"ensemble realizations disagree on integrator config: {integs}"
        )
    return states, auxes, cfgs, metas, yieldses, converters, sim_dirs


def run_ensemble(cfg: SimConfig, progress: bool = True,
                 data_dir: Optional[str] = None, root: str = "."):
    """Run `cfg.ensemble` independent cluster realizations as ONE vmapped
    batched program, sharded across the available chips, writing each
    realization's checkpoint files into the reference's grid folder layout
    `pt-<rc>-<n>/pt-<rc>-<n>/pt-<k>/` (the layout plotting/postprocess.py
    walks; the reference runs these as separate shell jobs instead,
    SURVEY.md §2c item 4). With cfg.reload set (a tag directory or any root
    containing the pt-<k> folders), every realization resumes from its most
    recent checkpoint (or cfg.n_checkpoint)."""
    import jax

    from ..parallel.ensemble import (
        ensemble_cacheable, ensemble_fresh_cache, ensemble_run_steps,
        ensemble_run_steps_cached, init_ensemble, make_ensemble_mesh,
        shard_ensemble, stack_ensemble,
    )

    t_wall0 = time.time()
    if cfg.gravity_stride > 1 or cfg.softened_virial or cfg.k_ultra:
        # the opt-in perf ladder is a single-run (hermite4_block Pallas /
        # mesh) capability; both ensemble paths run BHTree-parity leapfrog
        # with the raw-potential virial radius. Raise rather than silently
        # dropping an explicit opt-in (ADVICE r3).
        raise ValueError(
            "the perf-ladder flags (--gravity_stride / --softened_virial "
            "/ --k_ultra) apply to single runs only; ensembles resolve to "
            "BHTree-parity leapfrog with the raw-potential virial radius "
            "(docs/precision.md)"
        )
    if cfg.force_impl == "tree":
        # the ensemble paths run group-masked fused sweeps (flat block
        # diagonal / 2-D mesh); a Morton tree would mix realizations
        raise ValueError(
            "force_impl='tree' is a single-run backend; ensembles use "
            "the group-masked fused sweeps (see docs/precision.md)"
        )
    extend_t = cfg.extend_final_time
    fresh_verbose = cfg.verbose
    if extend_t is not None and not cfg.reload:
        raise ValueError(
            "extend_final_time is a resume directive: set reload too "
            "(a cold start takes its schedule from final_time/n_plot)"
        )
    if cfg.reload:
        states, auxes, cfgs, metas, yieldses, converters, sim_dirs = (
            load_ensemble(cfg.reload, cfg.n_checkpoint, data_dir)
        )
        n_real = len(sim_dirs)
        batch_state, batch_aux = stack_ensemble(states, auxes)
        cfg = cfgs[0].replace(verbose=fresh_verbose)  # see run(): -v is
        #   a property of the invocation, like the reference's
        if extend_t is not None:
            # same `-r X -t_f T` extension semantics as run(): one grid-
            # preserving schedule shared by every realization, carried
            # into each stored args for the next resume
            cfg = cfg.extended_to(extend_t)
            t0 = float(np.asarray(batch_state.time[0]))
            if cfg.n_steps <= int(round(t0 / cfg.dt)):
                raise ValueError(
                    f"-t_f {extend_t} does not extend this resume: the "
                    f"checkpoints are already at t = {t0} Myr. To "
                    f"shorten a run, resume from an earlier checkpoint "
                    f"with -nc instead"
                )
            for md in metas:
                md.args.final_time = cfg.final_time
                md.args.n_plot = cfg.n_plot
                md.args.dt_override = cfg.dt_override
                md.t_f = Quantity(cfg.final_time, myr)
        for k in range(n_real):
            base_k = os.path.join(sim_dirs[k], metas[k].filename)
            _bound_resumed_yields(
                yieldses[k], base_k, cfg,
                float(np.asarray(states[k].time)),
            )
            _drop_stale_state_files(base_k,
                                    metas[k].most_recent_checkpoint)
        k_step = int(round(float(np.asarray(batch_state.time[0])) / cfg.dt))
        save_initial = False
    else:
        n_real = cfg.ensemble
        batch_state, batch_aux, cfgs = init_ensemble(cfg, n_real, data_dir)
        cfg = cfgs[0]
        tag = f"pt-{cfg.rc}-{cfg.n}"
        sim_dirs, metas, yieldses, converters = [], [], [], []
        for k in range(n_real):
            d = os.path.join(root, tag, tag, f"pt-{k}")
            os.makedirs(d, exist_ok=True)
            sim_dirs.append(d)
            md = _metadata_from_cfg(cfgs[k].replace(filename=f"pt-{k}"))
            metas.append(md)
            yieldses.append(Yields(
                os.path.join(d, md.filename),
                bounded=bool(getattr(cfg, "yields_frames", False)),
            ))
            m_total_k = float(np.asarray(batch_state.cluster.mass[k]).sum())
            converters.append(Converter(cfg.rc, m_total_k))
        k_step = 0
        save_initial = True
    mesh2d = None
    mesh = None
    if cfg.mesh_shape and len(cfg.mesh_shape) != 2:
        # an explicit mesh request must not be silently ignored: ensembles
        # take the 2-D (ens x rows) form only
        raise ValueError(
            f"mesh_shape={cfg.mesh_shape} with --ensemble: use a 2-tuple "
            "'E,R' (realizations across E chips, each realization's force "
            "sweep row-sharded across R), or unset it for pure "
            "ensemble sharding across all devices"
        )
    if cfg.mesh_shape and len(cfg.mesh_shape) == 2:
        # explicit 2-D (ens x rows) mesh: realizations across the first
        # axis, EACH realization's force sweep row-sharded across the
        # second (parallel.ensemble.ensemble_step_2d) — for ensembles with
        # fewer members than chips
        from ..parallel.ensemble import (
            ensemble_run_steps_2d, ensemble_run_steps_2d_cached,
            ensemble2d_fresh_cache, make_ensemble2d_mesh, shard_ensemble_2d,
        )

        n_ens_ax, n_rows_ax = cfg.mesh_shape
        n_dev = n_ens_ax * n_rows_ax
        if len(jax.devices()) < n_dev:
            raise ValueError(
                f"mesh_shape={cfg.mesh_shape} needs {n_dev} devices, "
                f"have {len(jax.devices())}"
            )
        # the ACTUAL per-realization star count (cfg.n + 1 with an
        # interloper) is what the rows axis shards
        n_stars = int(batch_state.cluster.mass.shape[1])
        if n_real % n_ens_ax != 0 or n_stars % n_rows_ax != 0:
            raise ValueError(
                f"mesh_shape={cfg.mesh_shape}: ensemble size {n_real} must "
                f"divide across {n_ens_ax} and star count {n_stars} across "
                f"{n_rows_ax}"
            )
        mesh2d = make_ensemble2d_mesh(n_ens_ax, n_rows_ax)
        batch_state, batch_aux = shard_ensemble_2d(batch_state, batch_aux,
                                                   mesh2d)
    elif n_real % len(jax.devices()) == 0:
        mesh = make_ensemble_mesh()
        batch_state, batch_aux = shard_ensemble(batch_state, batch_aux, mesh)

    # thread the block-diagonal force cache across checkpoint chunks
    # (run()'s run_steps_cached semantics): without this every
    # cadence-boundary chunk re-pays the opening sweep
    use_ens_cache = mesh2d is None and ensemble_cacheable(batch_state, cfg)
    # the 2-D path caches too (leapfrog-only, so the closing eval is exact
    # at the final positions; kicks leave the position/mass-only acc+pot
    # cache exact)
    use_2d_cache = (mesh2d is not None
                    and getattr(cfg, "force_cache", True))
    ens_cache = [None]

    def advance_ens(bs, n):
        if mesh2d is not None:
            if use_2d_cache:
                if ens_cache[0] is None:
                    ens_cache[0] = ensemble2d_fresh_cache(bs, cfg, mesh2d)
                bs, ens_cache[0] = ensemble_run_steps_2d_cached(
                    bs, ens_cache[0], batch_aux, cfg, n, mesh2d)
                return bs
            return ensemble_run_steps_2d(bs, batch_aux, cfg, n, mesh2d)
        if use_ens_cache:
            if ens_cache[0] is None:
                ens_cache[0] = ensemble_fresh_cache(bs, cfg, mesh)
            bs, ens_cache[0] = ensemble_run_steps_cached(
                bs, ens_cache[0], batch_aux, cfg, n, mesh)
            return bs
        return ensemble_run_steps(bs, batch_aux, cfg, n, mesh=mesh)

    def _save_all_sync(bs, increment=True, final=False):
        # ONE batched device_get per save (slicing per realization would
        # issue ~45 x n_real small transfers), then the
        # SAME per-run save protocol as run() — _save keeps the validate
        # gate / yields-mode plumbing in one place
        host = jax.device_get(bs)
        for k in range(n_real):
            st = jax.tree.map(lambda x: x[k], host)
            _save(os.path.join(sim_dirs[k], metas[k].filename), metas[k],
                  converters[k], yieldses[k], st, cfg,
                  increment=increment, final=final)

    writer = None
    if getattr(cfg, "async_saves", True):
        from ..io.async_writer import AsyncCheckpointWriter

        writer = AsyncCheckpointWriter()

    def save_all(bs, increment=True, final=False):
        if writer is not None:
            # pull on the MAIN thread before handing to the writer (see
            # do_save in run(): a background pull racing sharded compute
            # can starve the CPU backend's collective rendezvous); the
            # writer-thread device_get then no-ops on numpy leaves
            bs = jax.device_get(bs)
            writer.submit(lambda: _save_all_sync(bs, increment, final))
        else:
            _save_all_sync(bs, increment, final)

    try:
        if save_initial:
            save_all(batch_state, increment=False)

        bar = None
        if progress:
            try:
                from tqdm import tqdm
                bar = tqdm(total=cfg.final_time, desc=f"Ensemble x{n_real}",
                           unit="Myr", initial=round(k_step * cfg.dt, 6))
            except ImportError:
                pass

        spp = cfg.steps_per_plot
        k_start = k_step
        saved_final = False
        while k_step < cfg.n_steps:
            if k_step % spp == 0:
                batch_state = advance_ens(batch_state, 1)
                k_step += 1
                # same final-save dedup as run(): a cadence save landing
                # on the last step IS the final save
                saved_final = k_step == cfg.n_steps
                save_all(batch_state, final=saved_final)
            else:
                chunk = min(spp - (k_step % spp), cfg.n_steps - k_step)
                batch_state = advance_ens(batch_state, chunk)
                k_step += chunk
            if bar is not None:
                bar.n = round(k_step * cfg.dt, 6)
                bar.refresh()
        if not saved_final and k_step > k_start:
            save_all(batch_state, final=True)
        if writer is not None:
            writer.close()
            writer = None
        if bar is not None:
            bar.close()
    finally:
        if writer is not None:
            try:
                writer.close()
            except RuntimeError:
                pass
    return batch_state, sim_dirs, time.time() - t_wall0
