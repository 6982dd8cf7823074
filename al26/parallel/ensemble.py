"""Ensemble (Monte-Carlo) parallelism: whole-cluster realizations vmapped
over a batch axis and sharded across chips.

This is the scientifically dominant parallel axis of the domain
(SURVEY.md §2c item 4): the reference runs many independent cluster
realizations as separate shell-level jobs in `pt-*/` folders and aggregates
them offline. Here an ensemble is a single batched SimState — one program,
one launch, N_ens clusters — with the batch axis laid across the device
mesh so each chip integrates its own subset of realizations with zero
communication.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SimConfig
from ..ops import backend
from ..sim.init import init_cluster
from ..sim.step import step

ENS_AXIS = "ens"
ROWS_AXIS = "rows"


def make_ensemble_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (ENS_AXIS,))


def make_ensemble2d_mesh(n_ens: int, n_rows: Optional[int] = None) -> Mesh:
    """2-D (ensemble x rows) device mesh: independent realizations lay
    across `n_ens` mesh columns while EACH realization's O(N^2) force sweep
    row-shards across `n_rows` chips (parallel.sharded semantics). This is
    the composition of the domain's two production parallel axes
    (SURVEY.md §2c items 1+4) — the DP x TP analog — for ensembles whose
    member count is below the device count (e.g. 4 realizations of N=1e5
    on 8 devices: mesh (4, 2))."""
    devs = jax.devices()
    if n_ens < 1:
        raise ValueError(f"mesh needs n_ens >= 1 (got {n_ens})")
    if n_rows is None:
        n_rows = len(devs) // n_ens
    if n_rows < 1:
        # the n_rows default is len(devs) // n_ens, which is 0 when more
        # realizations than devices are requested — a silent empty Mesh
        # otherwise
        raise ValueError(
            f"mesh ({n_ens} ens x {n_rows} rows) is degenerate: need at "
            f"least 1 device per axis ({len(devs)} attached; with "
            f"n_ens > device count use the 1-D ensemble mesh instead)"
        )
    if n_ens * n_rows > len(devs):
        # library callers bypass run_ensemble's pre-check; without this an
        # opaque 'cannot reshape array' surfaces from np.reshape
        raise ValueError(
            f"mesh ({n_ens} ens x {n_rows} rows) needs {n_ens * n_rows} "
            f"devices but only {len(devs)} are attached"
        )
    devs = np.array(devs[: n_ens * n_rows]).reshape(n_ens, n_rows)
    return Mesh(devs, (ENS_AXIS, ROWS_AXIS))


def init_ensemble(cfg: SimConfig, n_realizations: int,
                  data_dir: Optional[str] = None):
    """Initialise `n_realizations` independent clusters (seeds
    cfg.seed, cfg.seed+1, ...) and stack them into one batched
    (SimState, SimAux). Massive-star slot arrays are padded to a common
    width so shapes match.

    integrator="auto" is resolved HERE, at the ensemble boundary, to
    BHTree-parity leapfrog for every realization (per-realization
    init_cluster would resolve it to hermite4 for n <= 8192, which
    collapses on flattened evolved ensembles: one hardened softened binary
    anywhere in the batch drags every realization onto ~dt/1000 substeps —
    the reference's own default solver is the fixed-substep BHTree
    leapfrog, al26_nbody.py:59). The shared resolution also guarantees all
    realizations record the SAME integrator/substep config in their
    checkpoints as the one that actually stepped them (run_ensemble steps
    with cfgs[0])."""
    states, auxes, cfgs = [], [], []
    m_totals = []
    for k in range(n_realizations):
        # host-side init: one batched device transfer at the end instead of
        # ~45 small ones per realization
        s, a, c = init_cluster(cfg.replace(seed=cfg.seed + k), data_dir,
                               as_numpy=True)
        states.append(s)
        auxes.append(a)
        cfgs.append(c)
        m_totals.append(float(np.asarray(s.cluster.mass).sum()))
    if cfg.integrator == "auto" or (cfg.integrator == "leapfrog"
                                    and cfg.leapfrog_n_sub is None):
        # shared resolution covers EXPLICIT leapfrog with unset n_sub too:
        # per-realization resolution derives n_sub from each realization's
        # IMF-drawn m_total, so realizations straddling a power-of-2
        # boundary would record different configs than the one that stepped
        # them (cfgs[0]) — and load_ensemble would refuse the resume
        from ..sim.init import resolve_integrator

        shared = resolve_integrator(
            cfg.replace(integrator="leapfrog"), float(np.mean(m_totals))
        )
        cfgs = [
            c.replace(integrator="leapfrog",
                      leapfrog_n_sub=shared.leapfrog_n_sub)
            for c in cfgs
        ]
    batch_state, batch_aux = stack_ensemble(states, auxes)
    return batch_state, batch_aux, cfgs


def stack_ensemble(states, auxes):
    """Stack per-realization (SimState, SimAux) lists into one batched
    pytree pair: massive-star slot arrays are padded to a common width
    (with False validity, so padded slots never contribute), then every
    array is stacked on the host and transferred once."""
    states = [jax.device_get(s) for s in states]
    auxes = [jax.device_get(a) for a in auxes]
    width = max(a.hm_idx.shape[0] for a in auxes)
    width_m = max(a.msrc_idx.shape[0] for a in auxes)
    auxes = [
        dataclasses.replace(
            a,
            hm_idx=np.pad(np.asarray(a.hm_idx),
                          (0, width - a.hm_idx.shape[0])),
            hm_slot_valid=np.pad(
                np.asarray(a.hm_slot_valid),
                (0, width - a.hm_slot_valid.shape[0])
            ),
            msrc_idx=np.pad(np.asarray(a.msrc_idx),
                            (0, width_m - a.msrc_idx.shape[0])),
            msrc_valid=np.pad(
                np.asarray(a.msrc_valid),
                (0, width_m - a.msrc_valid.shape[0])
            ),
            kick_vel=np.pad(
                np.asarray(a.kick_vel),
                ((0, width - a.kick_vel.shape[0]), (0, 0))
            ),
        )
        for a in auxes
    ]
    # AGB grids may differ in length only if data files differ; they don't.
    batch_state = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *states)
    batch_aux = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *auxes)
    return batch_state, batch_aux


def shard_ensemble(batch_state, batch_aux, mesh: Mesh):
    """Lay the realization axis across the mesh (pure data parallelism)."""

    def place(x):
        spec = P(ENS_AXIS, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(place, batch_state), jax.tree.map(place, batch_aux)


def shard_ensemble_2d(batch_state, batch_aux, mesh: Mesh):
    """Place a stacked ensemble on a 2-D (ens x rows) mesh: the realization
    axis shards over ENS_AXIS; per-star arrays additionally shard their
    star axis over ROWS_AXIS (the aux slot/table arrays stay ens-only —
    their widths are small and GSPMD reshards gathers as needed)."""
    n = batch_state.cluster.mass.shape[1]

    def place_state(x):
        if x.ndim >= 2 and x.shape[1] == n:
            spec = P(ENS_AXIS, ROWS_AXIS, *([None] * (x.ndim - 2)))
        elif x.ndim >= 1:
            spec = P(ENS_AXIS, *([None] * (x.ndim - 1)))
        else:
            spec = P()
        return jax.device_put(x, NamedSharding(mesh, spec))

    def place_aux(x):
        spec = P(ENS_AXIS, *([None] * (x.ndim - 1))) if x.ndim >= 1 else P()
        return jax.device_put(x, NamedSharding(mesh, spec))

    return (jax.tree.map(place_state, batch_state),
            jax.tree.map(place_aux, batch_aux))


def ensemble2d_acc_pot(pos, vel, mass, mesh: Mesh, eps2,
                       pot_eps2=None, with_pot: bool = True):
    """Row-sharded per-realization (acc, pot) over a 2-D (ens x rows) mesh.

    `pos/vel/mass` are [B, N, ...]; each device holds a [B/ens, N/rows]
    block, all-gathers its realizations' full column sets over ROWS_AXIS
    only (realizations never mix — the batch axis IS the isolation), and
    computes the row-block forces for its rows (parallel.sharded dataflow,
    lifted over a local realization batch)."""
    from ..ops.nbody import _row_block_acc_jerk_pot
    from ..units import G_INTERNAL

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(ENS_AXIS, ROWS_AXIS), P(ENS_AXIS, ROWS_AXIS),
                  P(ENS_AXIS, ROWS_AXIS)),
        out_specs=(P(ENS_AXIS, ROWS_AXIS), P(ENS_AXIS, ROWS_AXIS)),
    )
    def _f(pos_l, vel_l, mass_l):
        # pos_l: [b_l, n_l, 3] — this device's row block of b_l realizations
        pos_c = jax.lax.all_gather(pos_l, ROWS_AXIS, axis=1, tiled=True)
        vel_c = jax.lax.all_gather(vel_l, ROWS_AXIS, axis=1, tiled=True)
        mass_c = jax.lax.all_gather(mass_l, ROWS_AXIS, axis=1, tiled=True)
        n_l = pos_l.shape[1]
        rows = (jax.lax.axis_index(ROWS_AXIS) * n_l
                + jnp.arange(n_l)).astype(jnp.int32)

        def one(pr, vr, pc, vc, mc):
            a, _, p = _row_block_acc_jerk_pot(
                pr, vr, pc, vc, mc, eps2, G_INTERNAL, rows,
                pot_eps2=pot_eps2, with_jerk=False, with_pot=with_pot,
            )
            return a, p

        return jax.vmap(one)(pos_l, vel_l, pos_c, vel_c, mass_c)

    return _f(pos, vel, mass)


def ensemble_step_2d(batch_state, batch_aux, cfg: SimConfig, mesh: Mesh,
                     cache=None, want_cache: bool = False):
    """One physics step on a 2-D (ens x rows) sharded ensemble: the
    leapfrog advance's force substeps run through the row-sharded
    per-realization sweep; the (pairwise-light) deposition/decay physics
    stays vmapped per realization under GSPMD. Leapfrog only — the
    ensemble boundary resolves "auto" to exactly that (init_ensemble).

    `cache=(a0 [B,N,3], pot [B,N])` replaces the opening fused sweep with
    the previous step's closing evaluation (sim/step.py force-cache
    semantics — exact for leapfrog: the closing eval is at the final
    positions, and the mass-delta correction accounts for this step's
    stellar mass loss). With `want_cache=True` the step returns
    (state, new_cache)."""
    from ..ops.integrators import leapfrog_advance
    from ..sim.step import physics_after_advance
    from ..units import G_INTERNAL

    integ = _resolve_ens_integ(cfg)
    if integ != "leapfrog":
        raise ValueError(
            f"ensemble_step_2d supports the ensemble-default leapfrog only "
            f"(got integrator={integ!r}); run with integrator='auto' or "
            "'leapfrog'"
        )
    c = batch_state.cluster
    b, n = c.mass.shape
    dtype = c.pos.dtype
    dt = jnp.asarray(cfg.dt, dtype)
    eps2 = jnp.asarray(cfg.eps2, dtype)

    # ONE fused sweep: step-start forces (softened) + the raw potential for
    # the per-realization virial radius (sim/step.py convention) — or, with
    # a cache, the previous step's closing evaluation
    if cache is not None:
        a0, pot = cache
    else:
        a0, pot = ensemble2d_acc_pot(c.pos, c.vel, c.mass, mesh, cfg.eps2,
                                     pot_eps2=1e-30)
    u = 0.5 * jnp.sum(c.mass * pot, axis=1)                         # [B]
    mtot = jnp.sum(c.mass, axis=1)                                  # [B]
    r_vir = -G_INTERNAL * mtot * mtot / (2.0 * u)

    def acc_fn(p):
        a, _ = ensemble2d_acc_pot(p, jnp.zeros_like(p), c.mass, mesh,
                                  cfg.eps2, with_pot=False)
        return a

    final_eval_fn = None
    if want_cache:
        def final_eval_fn(p):
            return ensemble2d_acc_pot(p, jnp.zeros_like(p), c.mass, mesh,
                                      cfg.eps2, pot_eps2=1e-30)

    out_lf = leapfrog_advance(
        c.pos, c.vel, c.mass, dt, n_sub=cfg.leapfrog_n_sub or 16,
        eps2=eps2, acc_fn=acc_fn, init_acc=a0,
        final_eval_fn=final_eval_fn,
    )
    if want_cache:
        pos_new, vel_new, (a1, _, pot1) = out_lf
    else:
        pos_new, vel_new = out_lf
    out_state = jax.vmap(
        lambda s, a, po, p, v, rv: physics_after_advance(
            s, a, cfg, po, p, v, rv)
    )(batch_state, batch_aux, c.pos, pos_new, vel_new, r_vir)
    if not want_cache:
        return out_state
    # mass-delta correction over the flattened mass-evolving sources (the
    # same linearity argument and GSPMD reasoning as ensemble_step_flat:
    # block=0 keeps the sharded rows dense)
    from ..ops.nbody import mass_delta_correction

    src_global = (batch_aux.msrc_idx
                  + (jnp.arange(b, dtype=jnp.int32) * n)[:, None]
                  ).reshape(-1)
    valid = batch_aux.msrc_valid.reshape(-1)
    mass_f = c.mass.reshape(b * n)
    dm = (out_state.cluster.mass.reshape(b * n)[src_global]
          - mass_f[src_global]) * valid
    a1f, _, pot1f = mass_delta_correction(
        a1.reshape(b * n, 3), None, pot1.reshape(b * n),
        pos_new.reshape(b * n, 3), vel_new.reshape(b * n, 3),
        src_global, dm, eps2, group_size=n, block=0,
    )
    return out_state, (a1f.reshape(b, n, 3), pot1f.reshape(b, n))


def ensemble2d_fresh_cache(batch_state, cfg: SimConfig, mesh: Mesh):
    """Opening fused (acc, pot) sweep to seed the 2-D path's force cache."""
    c = batch_state.cluster
    return ensemble2d_acc_pot(c.pos, c.vel, c.mass, mesh, cfg.eps2,
                              pot_eps2=1e-30)


@functools.partial(jax.jit, static_argnames=("cfg", "n_steps", "mesh"))
def ensemble_run_steps_2d_cached(batch_state, cache, batch_aux,
                                 cfg: SimConfig, n_steps: int, mesh: Mesh):
    """Scan n_steps over the 2-D ensemble carrying the force cache ACROSS
    calls (the driver threads (state, cache) between checkpoint chunks):
    each step costs ONE fused row-sharded sweep + the leapfrog's interior
    substep sweeps, never a fresh opening one. Returns (state, cache)."""
    def body(carry, _):
        s, ch = carry
        return ensemble_step_2d(s, batch_aux, cfg, mesh, ch,
                                want_cache=True), None

    (out, cache), _ = jax.lax.scan(body, (batch_state, cache), None,
                                   length=n_steps)
    return out, cache


@functools.partial(jax.jit, static_argnames=("cfg", "n_steps", "mesh"))
def ensemble_run_steps_2d(batch_state, batch_aux, cfg: SimConfig,
                          n_steps: int, mesh: Mesh):
    """Scan n_steps over a 2-D (ens x rows) sharded ensemble."""
    def body(s, _):
        return ensemble_step_2d(s, batch_aux, cfg, mesh), None

    out, _ = jax.lax.scan(body, batch_state, None, length=n_steps)
    return out


def ensemble_step(batch_state, batch_aux, cfg: SimConfig):
    """One physics step for every realization (vmapped; XLA keeps the batch
    axis sharded if the inputs are)."""
    return jax.vmap(lambda s, a: step(s, a, cfg))(batch_state, batch_aux)


def _flat_sweep(mass_f, eps2, n: int, mesh):
    """Block-diagonal kernel sweep `(p, v, **kw) -> (acc, jerk, pot)` over
    the flattened ensemble. With an ensemble `mesh` (the batch axis
    sharded, whole realizations per device) the kernel runs per device
    under shard_map on the local rows: group ids stay aligned because
    every shard starts at a realization boundary."""
    from ..ops.pallas_nbody import pallas_acc_jerk_pot

    interpret = backend.kernel_interpret()

    def sweep(p, v, **kw):
        f = functools.partial(pallas_acc_jerk_pot, eps2=eps2, group_size=n,
                              interpret=interpret, **kw)
        if mesh is not None:
            spec = P(ENS_AXIS)
            f = jax.shard_map(f, mesh=mesh, in_specs=(spec,) * 3,
                              out_specs=(spec,) * 3, check_vma=False)
        return f(p, v, mass_f)

    return sweep


def ensemble_step_flat(batch_state, batch_aux, cfg: SimConfig,
                       cache=None, want_cache: bool = False, mesh=None):
    """One physics step for the whole ensemble with a FLATTENED, block-
    diagonal N-body advance.

    A vmapped dense force materialises [B, N, N, 3] temporaries; instead
    the B x N stars are flattened into one system and the Pallas kernel's
    group mask (global_index // N) restricts interactions to each
    realization. The shared Hermite substep becomes the
    min over ALL realizations — the same wall-clock the vmapped while_loop
    pays (every lane runs until the slowest finishes), so only summation
    order differs. The pairwise-light physics (deposition, decay,
    condensation) stays vmapped per realization. `mesh`: the 1-D ensemble
    mesh the batch is sharded over (shard_ensemble), so each device sweeps
    its own realizations.
    """
    from ..ops.integrators import advance
    from ..sim.step import physics_after_advance
    from ..units import G_INTERNAL

    c = batch_state.cluster
    b, n = c.mass.shape
    dtype = c.pos.dtype
    flat = lambda x: x.reshape((b * n,) + x.shape[2:])
    pos_f, vel_f, mass_f = flat(c.pos), flat(c.vel), flat(c.mass)
    dt = jnp.asarray(cfg.dt, dtype)
    eps2 = jnp.asarray(cfg.eps2, dtype)

    integ = cfg.integrator
    if integ == "auto":
        # fallback for callers that bypass init_ensemble's ensemble-boundary
        # resolution: adaptive Hermite (shared OR block) collapses on
        # evolved ensembles — one hardened softened binary anywhere in the
        # batch demands ~dt/1000 substeps. The reference's default solver
        # is the fixed-substep BHTree leapfrog (al26_nbody.py:59);
        # ensembles default to exactly that.
        integ = "leapfrog"
    needs_jerk = integ in ("hermite4", "hermite4_block")
    pallas_on = backend.kernel_here(b * n, dtype)
    cache_ok = (want_cache and pallas_on
                and getattr(cfg, "force_cache", True)
                and integ in ("leapfrog", "hermite4_block")
                # kicks leave cached acc/pot exact but stale the cached jerk
                # (sim.step._cacheable)
                and not (cfg.natal_kicks and integ == "hermite4_block"))

    init_eval = None
    final_eval_fn = None
    if pallas_on:
        sweep = _flat_sweep(mass_f, cfg.eps2, n, mesh)

        def force_fn(p, v):
            a, j, _ = sweep(p, v)
            return a, j

        def acc_fn(p):
            a, _, _ = sweep(p, jnp.zeros_like(p), with_jerk=False)
            return a

        # ONE block-diagonal sweep: step-start forces (softened) + the
        # unsoftened potential for the per-realization virial radius —
        # or, with a cache, the previous step's closing evaluation
        if cache is not None:
            a0, j0, pot_f = cache
        else:
            a0, j0, pot_f = sweep(pos_f, vel_f, with_jerk=needs_jerk,
                                  pot_eps2=1e-30)
        init_eval = (a0, j0) if needs_jerk else (a0, None)
        if cache_ok:
            def final_eval_fn(p, v):
                a, j, pot = sweep(p, v,
                                  with_jerk=(integ == "hermite4_block"),
                                  pot_eps2=1e-30)
                return a, (j if integ == "hermite4_block" else None), pot
    else:
        # XLA fallback (CPU, f64, small ensembles): group-masked dense
        # sweep per realization via vmap — [B, N, N, 3] temporaries, so
        # small sizes only
        from ..ops.nbody import acc_jerk_pot_dense, acc_pot_dense

        def force_fn(p, v):
            a, j, _ = jax.vmap(
                lambda pp, vv, mm: acc_jerk_pot_dense(pp, vv, mm, eps2)
            )(p.reshape(b, n, 3), v.reshape(b, n, 3), c.mass)
            return a.reshape(b * n, 3), j.reshape(b * n, 3)

        def acc_fn(p):
            # leapfrog substeps need only accelerations: skip the ~40%
            # jerk pair work the force_fn adapter would silently discard
            a = jax.vmap(
                lambda pp, mm: acc_pot_dense(pp, mm, eps2)[0]
            )(p.reshape(b, n, 3), c.mass)
            return a.reshape(b * n, 3)
        pot_f = jax.vmap(
            lambda pp, mm: acc_pot_dense(pp, mm, 0.0)[1]
        )(c.pos, c.mass).reshape(b * n)

    # per-realization virial radius from the group-masked potential
    u = 0.5 * jnp.sum((mass_f * pot_f).reshape(b, n), axis=1)      # [B]
    mtot = jnp.sum(c.mass, axis=1)                                  # [B]
    r_vir = -G_INTERNAL * mtot * mtot / (2.0 * u)

    force_rows_fn = None
    if integ == "hermite4_block":
        if pallas_on:
            from ..ops.pallas_nbody import make_pallas_force_rows

            force_rows_fn = make_pallas_force_rows(
                mass_f, cfg.eps2, backend.kernel_interpret(), group_size=n)
        else:
            def force_rows_fn(pr, vr, ids, p_all, v_all):
                # jnp fallback with the SAME group masking (fast rows must
                # not feel other realizations)
                dx = p_all[None, :, :] - pr[:, None, :]
                dv = v_all[None, :, :] - vr[:, None, :]
                r2 = jnp.sum(dx * dx, -1) + eps2
                inv_r = jax.lax.rsqrt(r2)
                cols = jnp.arange(b * n)
                bad = (cols[None, :] == ids[:, None]) | (
                    (cols[None, :] // n) != (ids[:, None] // n))
                inv_r = jnp.where(bad, 0.0, inv_r)
                inv_r3 = inv_r * inv_r * inv_r
                r2s = jnp.where(bad, 1.0, r2)
                xv = jnp.sum(dx * dv, -1)
                from ..units import G_INTERNAL as G
                mj3 = mass_f[None, :] * inv_r3
                a = G * backend.einsum("ij,ijk->ik", mj3, dx)
                j = G * (backend.einsum("ij,ijk->ik", mj3, dv)
                         - 3.0 * backend.einsum("ij,ijk->ik", mj3 * xv / r2s,
                                                dx))
                return a, j

    out = advance(
        pos_f, vel_f, mass_f, dt,
        integrator=integ, eta=cfg.eta_hermite,
        n_sub=cfg.leapfrog_n_sub or 16,
        eps2=eps2, max_substeps=cfg.substeps_max,
        force_fn=force_fn, acc_fn=acc_fn,
        # an explicit cfg.k_fast was resolved for ONE realization
        # (sim.init bounds it to [256, 512] from cfg.n): the flattened
        # b*n system needs that CAPACITY PER REALIZATION, or tight
        # binaries losing the global top-k race integrate in the slow
        # group at full dt
        k_fast=(cfg.k_fast * b) if cfg.k_fast else max(256, (b * n) // 64),
        force_rows_fn=force_rows_fn, init_eval=init_eval,
        final_eval_fn=final_eval_fn,
    )
    if cache_ok:
        pos_new, vel_new, (a1, j1, pot1) = out
    else:
        pos_new, vel_new = out
    unflat = lambda x: x.reshape((b, n) + x.shape[1:])
    out_state = jax.vmap(
        lambda s, a, po, p, v, rv: physics_after_advance(
            s, a, cfg, po, p, v, rv)
    )(batch_state, batch_aux, c.pos, unflat(pos_new), unflat(vel_new), r_vir)
    if not cache_ok:
        return out_state
    # mass-delta correction over the flattened mass-evolving sources (same
    # linearity argument as sim/step.py, with the same-realization mask)
    from ..ops.nbody import mass_delta_correction

    src_global = (batch_aux.msrc_idx
                  + (jnp.arange(b, dtype=jnp.int32) * n)[:, None]
                  ).reshape(-1)
    valid = batch_aux.msrc_valid.reshape(-1)
    mass_new_f = flat(out_state.cluster.mass)
    dm = (mass_new_f[src_global] - mass_f[src_global]) * valid
    a1, j1, pot1 = mass_delta_correction(
        a1, j1, pot1, pos_new, vel_new, src_global, dm, eps2,
        group_size=n,
        # block=0: the ensemble batch axis may be mesh-sharded
        # (shard_ensemble) — GSPMD partitions the flattened rows itself,
        # and a lax.map over row blocks of sharded arrays would reshard
        # every iteration (same reasoning as sim/step.py's mesh callers)
        block=0,
    )
    new_cache = (a1, jnp.zeros_like(a1) if j1 is None else j1, pot1)
    return out_state, new_cache


def _resolve_ens_integ(cfg: SimConfig) -> str:
    return "leapfrog" if cfg.integrator == "auto" else cfg.integrator


def ensemble_cacheable(batch_state, cfg: SimConfig) -> bool:
    """Can the flat ensemble carry the block-diagonal force cache between
    steps (and, via ensemble_run_steps_cached, across the driver's
    checkpoint chunks)? Mirrors sim.step._cacheable's gates."""
    b, n = batch_state.cluster.mass.shape
    integ = _resolve_ens_integ(cfg)
    return (backend.kernel_here(b * n, batch_state.cluster.pos.dtype)
            and getattr(cfg, "force_cache", True)
            and integ in ("leapfrog", "hermite4_block")
            and not (cfg.natal_kicks and integ == "hermite4_block"))


def ensemble_fresh_cache(batch_state, cfg: SimConfig, mesh=None):
    """Opening block-diagonal (acc, jerk, pot) sweep to seed the flat
    ensemble's force cache."""
    integ = _resolve_ens_integ(cfg)
    c = batch_state.cluster
    b, n = c.mass.shape
    flat = lambda x: x.reshape((b * n,) + x.shape[2:])
    sweep = _flat_sweep(flat(c.mass), cfg.eps2, n, mesh)
    return sweep(flat(c.pos), flat(c.vel),
                 with_jerk=(integ == "hermite4_block"), pot_eps2=1e-30)


def ensemble_run_steps_cached(batch_state, cache, batch_aux,
                              cfg: SimConfig, n_steps: int, mesh=None):
    """Scan n_steps over the flat ensemble carrying the force cache ACROSS
    calls: the driver threads (state, cache) between checkpoint chunks
    (run_steps_cached semantics), so cadence-boundary steps stop paying a
    fresh O((B*N)^2/B) opening sweep per chunk. Returns (state, cache)."""
    def body_cached(carry, _):
        s, ch = carry
        return ensemble_step_flat(s, batch_aux, cfg, ch,
                                  want_cache=True, mesh=mesh), None

    (out, cache), _ = jax.lax.scan(body_cached, (batch_state, cache),
                                   None, length=n_steps)
    return out, cache


ensemble_run_steps_cached = jax.jit(
    ensemble_run_steps_cached, static_argnames=("cfg", "n_steps", "mesh")
)


def ensemble_run_steps(batch_state, batch_aux, cfg: SimConfig, n_steps: int,
                       flat: bool | None = None, mesh=None):
    """Scan n_steps over the ensemble. `flat=None` auto-selects the
    block-diagonal flattened advance where the Pallas kernel runs; the
    flat leapfrog/hermite4_block paths carry the force cache between steps
    (ONE block-diagonal sweep per step, sim/step.py semantics). `mesh`:
    the 1-D ensemble mesh the batch is sharded over (shard_ensemble), so
    the flat kernel sweeps each device's own realizations."""
    b, n = batch_state.cluster.mass.shape
    pallas_on = backend.kernel_here(b * n, batch_state.cluster.pos.dtype)
    if flat is None:
        flat = pallas_on

    if flat and ensemble_cacheable(batch_state, cfg):
        cache = ensemble_fresh_cache(batch_state, cfg, mesh)
        out, _ = ensemble_run_steps_cached(batch_state, cache, batch_aux,
                                           cfg, n_steps, mesh)
        return out

    def body(s, _):
        if flat:
            return ensemble_step_flat(s, batch_aux, cfg, mesh=mesh), None
        return ensemble_step(s, batch_aux, cfg), None

    out, _ = jax.lax.scan(body, batch_state, None, length=n_steps)
    return out


ensemble_run_steps = jax.jit(
    ensemble_run_steps, static_argnames=("cfg", "n_steps", "flat", "mesh")
)
