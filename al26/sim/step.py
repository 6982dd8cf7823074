"""The simulation step: one jitted, fixed-shape program.

Re-design of `evolve_simulation` (al26_nbody.py:704-1113). The reference's
step crosses four process boundaries (BHTree, SeBa, two channel copies) and
runs four numba kernel launches; here the entire step is a single pure
function `step(state, aux) -> state` compiled once by XLA. Order of
operations follows the reference exactly:

  1. masks + virial radius from the state at step start (:767-770)
  2. N-body advance by the fixed outer dt (:786, :833)
  3. stellar evolution update -> new masses + wind rates (:841, :871-876)
  4. wind deposition, global + local mixing models (:883-941)
  5. supernova detection + disc injection (:943-967)
  6. AGB interloper deposition (:969-1028)
  7. radioactive decay (:1045-1068)
  8. disc condensation / death (:1070-1086)

Data-dependent events (SNe, disc death, interloper proximity) are masks —
shapes never change, so the same compiled program runs every step and can
be vmapped over ensemble realizations or scanned over many steps.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import SimConfig
from ..ops import backend
from ..ops import deposition as dep
from ..ops.integrators import advance
from ..ops.nbody import virial_radius
from ..state import CH_AGB, CH_GLOBAL, CH_LOCAL, CH_SNE, SimState
from ..models.stellar import evolution as stellar
from .init import SimAux


def _agb_rates(aux: SimAux, t_interloper):
    """Interpolate the AGB wind rate grids at the interloper clock; zero
    outside the tabulated range (al26_nbody.py:535-562)."""
    t = aux.agb_grid_t
    inside = (t_interloper >= t[0]) & (t_interloper <= t[-1])
    r_al = jnp.interp(t_interloper, t, aux.agb_grid_rates[0]) * inside
    r_fe = jnp.interp(t_interloper, t, aux.agb_grid_rates[1]) * inside
    return r_al, r_fe


def _build_force_fn(mass, eps2, cfg: SimConfig, mesh, force_impl: str):
    """Select the pairwise force backend (static dispatch).

    auto    -> sharded when a mesh is given; the Pallas kernel where
               ops.backend.kernel_here says so (GPU, f32, N >= 4096);
               otherwise the integrator default (dense <= 2048,
               row-chunked above).
    pallas  -> single-device Pallas tiled kernel (ops.pallas_nbody).
    sharded -> shard_map row blocks over `mesh`, all-gathered columns
               (parallel.sharded).
    ring    -> shard_map row blocks with ppermute-streamed column blocks
               (parallel.ring; O(N/D) peak memory per chip).
    """
    if force_impl in ("sharded", "ring") and mesh is None:
        raise ValueError(
            f"force_impl={force_impl!r} requires a device mesh "
            "(cfg.mesh_shape)"
        )
    if mesh is not None and force_impl not in ("auto", "sharded", "ring",
                                               "tree"):
        # a mesh run's opening/closing sweeps are always the mesh
        # backends (fused_mesh in _step_impl): mixing in a single-chip
        # integrator force would reshard every substep or crash
        raise ValueError(
            f"force_impl={force_impl!r} is single-chip; with mesh_shape "
            "use 'auto', 'sharded', 'ring' or 'tree'"
        )
    if mesh is not None and force_impl == "tree":
        # hermite4_block-only under a mesh (sim.init enforces); the
        # opening/closing sweeps come from the mesh tree sweep
        from ..parallel.tree_mesh import make_tree_mesh_sweep

        sweep = make_tree_mesh_sweep(
            mass, mesh, cfg.eps2, leaf=cfg.tree_leaf,
            theta=cfg.tree_theta, kavg=cfg.tree_kavg or 256,
            pot_eps2=None, with_jerk=True,
        )

        def tree_force_fn(p, v):
            a, j, _ = sweep(p, v)
            return a, j

        return tree_force_fn, None
    if force_impl == "auto":
        if mesh is not None:
            force_impl = "sharded"
        elif backend.kernel_here(mass.shape[0], mass.dtype):
            force_impl = "pallas"
        else:
            force_impl = "default"
    if force_impl == "default":
        return None, None
    if force_impl == "sharded":
        from ..parallel.sharded import make_sharded_force
        return make_sharded_force(mesh, mass, eps2), None
    if force_impl == "ring":
        from ..parallel.ring import make_ring_force
        return make_ring_force(mesh, mass, eps2), None
    if force_impl == "pallas":
        from ..ops.pallas_nbody import make_pallas_acc, make_pallas_force
        interpret = backend.kernel_interpret()
        return (make_pallas_force(mass, eps2, interpret),
                make_pallas_acc(mass, eps2, interpret))
    if force_impl == "tree":
        from ..ops.tree import make_tree_acc, make_tree_force
        kw = dict(leaf=cfg.tree_leaf, theta=cfg.tree_theta,
                  kavg=cfg.tree_kavg or 256)
        return (make_tree_force(mass, cfg.eps2, **kw),
                make_tree_acc(mass, cfg.eps2, **kw))
    raise ValueError(f"unknown force_impl: {force_impl}")


def _build_force_rows_fn(mass, eps2, rows_kernel: bool):
    """The subcycle's K x N row sweep: the Pallas kernel, or None for
    the integrator's XLA default."""
    if not rows_kernel:
        return None
    from ..ops.pallas_nbody import make_pallas_force_rows
    return make_pallas_force_rows(mass, eps2, backend.kernel_interpret())


def _mesh_sweep(mesh, force_impl: str):
    """Full-sweep function `(pos, vel, mass, *, eps2, pot_eps2, with_jerk)
    -> (acc, jerk, pot)` for the mesh backends: ppermute ring streaming
    for force_impl="ring" (O(N/D) peak memory per chip), the all-gather
    row sweep otherwise."""
    if force_impl == "ring":
        from ..parallel.ring import ring_acc_jerk_pot

        return lambda p, v, m, **kw: ring_acc_jerk_pot(p, v, m, mesh, **kw)
    from ..parallel.sharded import sharded_acc_jerk_pot

    return lambda p, v, m, **kw: sharded_acc_jerk_pot(p, v, m, mesh, **kw)


def _sweep_eval_fn(cfg: SimConfig, mesh, force_impl: str, mass,
                   needs_jerk: bool, tree_aref=None):
    """Full fused sweep `(pos, vel) -> (acc, jerk, pot)`: the mesh
    backends under a mesh, the single-device Pallas kernel otherwise. The
    ONE place the sweep conventions (cfg.eps2 force softening, _pot_eps2
    virial softening, with_jerk) live — _step_impl, _stride_impl and
    fresh_cache all build their evaluations here.

    `tree_aref` [N] (tree tier, cfg.tree_mac="relative"): per-star
    reference acceleration magnitudes — the previous evaluation, riding
    the force cache — switching the MAC to the Springel relative
    criterion at tolerance cfg.tree_alpha. None keeps the geometric
    opening-angle MAC (always the case for the cache-seeding first
    sweep of a run, where no previous acceleration exists)."""
    if mesh is not None:
        if force_impl == "tree":
            if cfg.tree_mac == "relative" and tree_aref is None:
                # relative mode's exact cache-seeding sweep, through the
                # all-gather mesh backend (same rationale as single-chip)
                sweep = _mesh_sweep(mesh, "sharded")

                def sweep_eval(p, v):
                    return sweep(p, v, mass, eps2=cfg.eps2,
                                 pot_eps2=_pot_eps2(cfg),
                                 with_jerk=needs_jerk)

                return sweep_eval
            from ..parallel.tree_mesh import make_tree_mesh_sweep

            theta = cfg.tree_theta
            if tree_aref is not None:
                theta = cfg.tree_alpha
            return make_tree_mesh_sweep(
                mass, mesh, cfg.eps2, leaf=cfg.tree_leaf, theta=theta,
                kavg=cfg.tree_kavg or 256, pot_eps2=_pot_eps2(cfg),
                with_jerk=needs_jerk, aref=tree_aref,
            )
        sweep = _mesh_sweep(mesh, force_impl)

        def sweep_eval(p, v):
            return sweep(p, v, mass, eps2=cfg.eps2,
                         pot_eps2=_pot_eps2(cfg), with_jerk=needs_jerk)

        return sweep_eval
    if force_impl == "tree":
        if cfg.tree_mac == "relative" and tree_aref is None:
            # relative mode's cache-seeding sweep (no previous
            # acceleration exists yet) is the EXACT kernel: one full
            # O(N^2) sweep per run/resume, amortised over every
            # subsequent tree step — and the near-field budget then only
            # has to hold the relative-MAC partner counts, not the far
            # larger geometric ones (sim.init auto-sizing)
            if not backend.kernel_here(mass.shape[0], mass.dtype):
                from ..ops.nbody import _row_block_acc_jerk_pot
                from ..units import G_INTERNAL

                def sweep_eval(p, v):
                    ids = jnp.arange(p.shape[0], dtype=jnp.int32)
                    return _row_block_acc_jerk_pot(
                        p, v, p, v, mass, jnp.asarray(cfg.eps2, p.dtype),
                        G_INTERNAL, ids, pot_eps2=_pot_eps2(cfg),
                        with_jerk=needs_jerk)

                return sweep_eval
            # else: fall through to the exact kernel sweep below
        else:
            from ..ops.tree import make_tree_sweep

            theta = cfg.tree_theta
            if tree_aref is not None:
                theta = cfg.tree_alpha
            return make_tree_sweep(
                mass, cfg.eps2, leaf=cfg.tree_leaf, theta=theta,
                kavg=cfg.tree_kavg or 256, pot_eps2=_pot_eps2(cfg),
                with_jerk=needs_jerk, aref=tree_aref,
            )
    from ..ops.pallas_nbody import pallas_acc_jerk_pot

    interpret = backend.kernel_interpret()

    def sweep_eval(p, v):
        return pallas_acc_jerk_pot(p, v, mass, cfg.eps2,
                                   interpret=interpret,
                                   with_jerk=needs_jerk,
                                   pot_eps2=_pot_eps2(cfg))

    return sweep_eval


def _corrected_cache(new_cluster, old_cluster, aux: SimAux, cfg: SimConfig,
                     mesh, pos, vel, a1, j1, pot1):
    """Shared cache epilogue: correct the closing (acc, jerk, pot)
    evaluation for this step's source-mass changes (forces are linear in
    source masses — O(N x M) instead of a fresh O(N^2) sweep) and return
    the next step's opening cache."""
    from ..ops.nbody import mass_delta_correction

    eps2 = jnp.asarray(cfg.eps2, pos.dtype)
    dm = (new_cluster.mass[aux.msrc_idx]
          - old_cluster.mass[aux.msrc_idx]) * aux.msrc_valid
    a1, j1, pot1 = mass_delta_correction(
        a1, j1, pot1, pos, vel, aux.msrc_idx, dm, eps2,
        pot_softened=cfg.softened_virial,
        block=0 if mesh is not None else None,
    )
    return a1, jnp.zeros_like(a1) if j1 is None else j1, pot1


def _pot_eps2(cfg: SimConfig):
    """Potential softening for the per-step sweep: the reference computes
    the virial radius from the RAW potential (AMUSE virial_radius,
    al26_nbody.py:767-770), which costs the sweep a second rsqrt per pair.
    cfg.softened_virial trades that parity for speed: the virial radius
    then uses the BHTree-softened potential.
    MEASURED deviation: |U_soft| < |U_raw| by 6-18% over a 10 Myr Plummer
    run (the ratio drifts as the cluster relaxes), so r_vir grows by the
    same factor and the global wind-bubble VOLUME by up to ~1.6x — the
    global mixing channel dilutes accordingly; dynamics and the local
    channel are bit-identical (tests/test_softened_virial.py). A
    throughput-first option, like gravity_stride."""
    return None if cfg.softened_virial else 1e-30


def _resolve_integ(cfg: SimConfig, n: int) -> str:
    """Defensive "auto" resolution for callers that bypass init_cluster's
    resolve_integrator (e.g. a cfg recreated from a dict)."""
    if cfg.integrator == "auto":
        if cfg.force_impl == "tree":
            # small N: BHTree-parity leapfrog; large N (the regime the
            # tier exists for): block-timestep Hermite over tree
            # acc+jerk — ONE tree sweep per step via the force cache,
            # vs n_sub leapfrog evaluations (round 5). relative MAC is
            # hermite4_block-only at ANY n (mirrors resolve_integrator;
            # leapfrog cannot thread the reference acceleration)
            if cfg.tree_mac == "relative":
                return "hermite4_block"
            return "leapfrog" if n <= 8192 else "hermite4_block"
        return "hermite4" if n <= 8192 else "hermite4_block"
    return cfg.integrator


def _pallas_here(cfg: SimConfig, n, dtype, mesh, force_impl) -> bool:
    return force_impl == "pallas" or (
        force_impl == "auto" and mesh is None
        and backend.kernel_here(n, dtype)
    )


def _cacheable(cfg: SimConfig, n, dtype, mesh, force_impl) -> bool:
    """Can the closing force evaluation be carried to the next step?
    (leapfrog's closing eval is at the final positions exactly;
    hermite4's and hermite4_block's under P(EC) semantics — the last
    substep's evaluation at its predicted state, exactly what the loop
    itself consumed). Round 3: the MESH paths cache too — both the
    all-gather sharded sweep and the ppermute ring sweep return
    acc/jerk/pot in one pass, the cache lives row-sharded, and the
    mass-delta correction is plain jnp that GSPMD partitions."""
    integ = _resolve_integ(cfg, n)
    if not getattr(cfg, "force_cache", True):
        return False
    # natal kicks change velocities outside the advance: the cached acc/pot
    # (position/mass-only) stay exact, but the Hermite integrators' cached
    # JERK is velocity-dependent and would go stale on SN steps
    if cfg.natal_kicks and integ in ("hermite4", "hermite4_block"):
        return False
    if integ not in ("leapfrog", "hermite4", "hermite4_block"):
        return False
    if mesh is not None:
        return force_impl in ("auto", "sharded", "ring", "tree")
    if force_impl == "tree":
        # leapfrog: closing tree eval at the final positions exactly;
        # hermite4_block: P(EC) semantics like the Pallas path
        return True
    return _pallas_here(cfg, n, dtype, mesh, force_impl)


def _step_impl(state: SimState, aux: SimAux, cfg: SimConfig,
               mesh, force_impl: str, cache, want_cache: bool = True):
    """One physics step; `cache` (acc, jerk, pot at the state's positions,
    with the PREVIOUS step's source masses already corrected to the current
    ones) replaces the opening O(N^2) sweep, and when caching is possible a
    new cache is returned with the step's closing evaluation."""
    c = state.cluster
    dt = jnp.asarray(cfg.dt, c.pos.dtype)
    eps2 = jnp.asarray(cfg.eps2, c.pos.dtype)

    from ..units import G_INTERNAL

    integ = _resolve_integ(cfg, c.n)
    tree_here = force_impl == "tree"
    if tree_here and integ not in ("leapfrog", "hermite4_block"):
        # direct step() callers can bypass sim.init.resolve_integrator;
        # the shared-adaptive hermite4 would pay a FULL tree build+sweep
        # per substep — the regime the tier exists for never wants that
        raise ValueError(
            "force_impl='tree' supports integrator='leapfrog' or "
            f"'hermite4_block'; got integrator={integ!r}"
        )
    pallas_here = _pallas_here(cfg, c.n, c.pos.dtype, mesh, force_impl)
    cache_ok = want_cache and _cacheable(cfg, c.n, c.pos.dtype, mesh,
                                         force_impl)

    # -- 1. cluster virial radius from the step-start state (:767-770) ------
    # On the Pallas AND sharded-mesh paths the SAME sweep yields the
    # integrator's step-start forces (softened, cfg.eps2) and the
    # UNsoftened potential the virial radius needs — no second O(N^2)
    # pass. With a cache, even that sweep is the previous step's closing
    # evaluation.
    init_eval = None
    needs_jerk = integ in ("hermite4", "hermite4_block")
    fused_mesh = mesh is not None
    sweep_eval = None  # (pos, vel) -> (acc, jerk, pot) full fused sweep
    if fused_mesh or pallas_here or tree_here:
        sweep_eval = _sweep_eval_fn(cfg, mesh, force_impl, c.mass,
                                    needs_jerk)
    if sweep_eval is not None:
        a0, j0, pot = cache if cache is not None else sweep_eval(c.pos,
                                                                 c.vel)
        u = 0.5 * jnp.sum(c.mass * pot)
        init_eval = (a0, j0) if needs_jerk else (a0, None)
        mtot = jnp.sum(c.mass)
        r_vir = -G_INTERNAL * mtot * mtot / (2.0 * u)
    else:
        r_vir = virial_radius(c.pos, c.mass)
    pos_old = c.pos

    # -- 2. N-body advance ---------------------------------------------
    # NOTE: pass the STATIC softening (cfg.eps2) — the pallas backend bakes
    # it into the kernel as a compile-time constant
    force_fn, acc_fn = _build_force_fn(c.mass, cfg.eps2, cfg, mesh,
                                       force_impl)
    force_rows_fn = None
    if integ == "hermite4_block":
        if fused_mesh:
            # round 3: the subcycle's K x N row sweeps shard their columns
            # over the mesh (previously fell back to dense rows)
            from ..parallel.sharded import make_sharded_force_rows
            force_rows_fn = make_sharded_force_rows(mesh, c.mass, cfg.eps2)
        else:
            # the fast-group subcycle stays EXACT on every backend (K x N
            # row sweeps): under the tree tier too — close encounters are
            # precisely where monopole truncation must not leak in
            force_rows_fn = _build_force_rows_fn(
                c.mass, cfg.eps2,
                pallas_here or (tree_here
                                and backend.kernel_here(c.n, c.pos.dtype)),
            )
    final_eval_fn = None
    if cache_ok:
        sweep_close = sweep_eval
        if tree_here and cfg.tree_mac == "relative":
            # relative MAC: the step's closing sweep opens nodes against
            # the OPENING acceleration magnitudes (cache-carried; forces
            # move O(dt) per step, ample for a truncation-error bound)
            sweep_close = _sweep_eval_fn(
                cfg, mesh, force_impl, c.mass, needs_jerk,
                tree_aref=jnp.sqrt(jnp.sum(a0 * a0, axis=-1)),
            )

        def final_eval_fn(p, v):
            a, j, pot = sweep_close(p, v)
            return a, (j if needs_jerk else None), pot

    out = advance(
        c.pos, c.vel, c.mass, dt,
        integrator=integ, eta=cfg.eta_hermite,
        n_sub=cfg.leapfrog_n_sub or 16,
        eps2=eps2, max_substeps=cfg.substeps_max, force_fn=force_fn,
        acc_fn=acc_fn, k_fast=cfg.k_fast or 0,
        force_rows_fn=force_rows_fn, init_eval=init_eval,
        final_eval_fn=final_eval_fn, k_ultra=cfg.k_ultra,
    )
    if cache_ok:
        pos, vel, (a1, j1, pot1) = out
    else:
        pos, vel = out
    new_state = physics_after_advance(state, aux, cfg, pos_old, pos, vel,
                                      r_vir)
    new_cache = None
    if cache_ok:
        # CAVEAT (advisor r2): on the hermite4/hermite4_block paths the
        # cached (a1, j1, pot1) was evaluated at the last substep's
        # PREDICTED state (P(EC) semantics) while the correction uses the
        # corrected (pos, vel) — "exact linear-in-mass" therefore holds up
        # to the P(EC) displacement. Routine wind-loss dm makes that
        # negligible (the measured energy-drift budget, docs/precision.md);
        # an SN step's collapse-sized dm (~10 Msun from one source) briefly
        # amplifies the same O(predictor-corrector) error by dm/m — still a
        # one-step transient of the integrator's own order, not a secular
        # drift, so the cache is kept rather than invalidated.
        new_cache = _corrected_cache(new_state.cluster, c, aux, cfg, mesh,
                                     pos, vel, a1, j1, pot1)
    return new_state, new_cache


@functools.partial(jax.jit, static_argnames=("cfg", "mesh", "force_impl"))
def step(state: SimState, aux: SimAux, cfg: SimConfig,
         mesh=None, force_impl: str = "auto") -> SimState:
    new_state, _ = _step_impl(state, aux, cfg, mesh, force_impl, None,
                              want_cache=False)
    return new_state


def fresh_cache(state: SimState, cfg: SimConfig, integ: str, mesh=None,
                force_impl: str = "auto"):
    """Opening (acc, jerk, pot) evaluation to seed the force cache
    (row-sharded over `mesh` when given; ring-streamed for
    force_impl="ring")."""
    c = state.cluster
    needs_jerk = integ in ("hermite4", "hermite4_block")
    return _sweep_eval_fn(cfg, mesh, force_impl, c.mass, needs_jerk)(
        c.pos, c.vel
    )


def physics_after_advance(state: SimState, aux: SimAux, cfg: SimConfig,
                          pos_old, pos, vel, r_vir) -> SimState:
    """Steps 3-8 of the physics (everything after the N-body advance):
    stellar evolution, wind/SN/AGB deposition, decay, condensation.

    Split out so the flattened-ensemble fast path (parallel.ensemble) can
    run the O(N^2) advance as ONE block-diagonal Pallas sweep and vmap only
    this (pairwise-light) part per realization."""
    c = state.cluster
    t = state.time
    dt = jnp.asarray(cfg.dt, c.pos.dtype)
    t_new = (state.step_count + 1).astype(c.pos.dtype) * dt
    lm_mask = c.low_mass_mask(cfg.low_mass_min, cfg.low_mass_max)

    # -- 3. stellar evolution ------------------------------------------
    # the (m0, z)-only Hurley-fit machinery is precomputed in
    # aux.stellar_tbl (sim.init): the per-step call is ~10 elementwise
    # ops instead of the zeta polynomials / powers / interps per star
    mass_new, mdot_new = stellar.evolve_from_table(
        aux.stellar_tbl, c.m0, t_new
    )
    # the anchor tables are f64 constants: under x64 they would promote an
    # f32 state and break the scan carry
    mass_new = mass_new.astype(c.pos.dtype)
    mdot_new = mdot_new.astype(c.pos.dtype)
    # the interloper's mass is pinned (it is an evolved AGB star whose mass
    # track is carried by the AGB table, al26_nbody.py:1448-1490)
    mass_new = jnp.where(c.is_interloper, c.mass, mass_new)
    mdot_new = jnp.where(c.is_interloper, 0.0, mdot_new)

    # wind/SN source validity: INITIAL-mass based by default (a 13-14 Msun
    # star keeps its strong post-MS wind and its SN after its current mass
    # drops below the threshold; mdot == 0 after the SN zeroes dead sources
    # either way). sn_parity_mode restores the reference's current-mass
    # gate: the reference builds its high-mass list from the STEP-START
    # masses (get_high_mass_star_indices at al26_nbody.py:767, before the
    # stellar update) and reads the post-update wind rate (:886-895,
    # :945-948) — so at the collapse step the gate sees the pre-SN mass,
    # and an SN fires iff m_presn >= threshold.
    hm_valid = aux.hm_slot_valid
    if cfg.sn_parity_mode:
        hm_valid = hm_valid & (
            c.mass[aux.hm_idx] >= cfg.high_mass_threshold
        )

    # -- 4. wind deposition (both isotopes, both mixing models) -------------
    slr = c.slr
    wind_global = dep.wind_deposition(
        pos, vel, c.r_disk, lm_mask, aux.hm_idx, hm_valid,
        mdot_new, c.wind_ratio, r_vir, dt, local=False,
    )
    wind_local = dep.wind_deposition(
        pos, vel, c.r_disk, lm_mask, aux.hm_idx, hm_valid,
        mdot_new, c.wind_ratio,
        jnp.asarray(cfg.r_bub_local_wind, c.pos.dtype), dt, local=True,
    )
    slr = slr.at[:, :, CH_GLOBAL].add(wind_global)
    slr = slr.at[:, :, CH_LOCAL].add(wind_local)

    # -- 5. supernovae ---------------------------------------------------
    injected, kicked = dep.sn_injection(
        pos, c.r_disk, lm_mask, aux.hm_idx, hm_valid,
        mdot_new, c.kicked, c.sn_yield,
    )
    slr = slr.at[:, :, CH_SNE].add(injected)
    if cfg.natal_kicks:
        # one-shot Maxwellian remnant kick at the SN (superset of the
        # reference's commented-out block, al26_nbody.py:846-865). Applied
        # at step end: this step's deposition used the pre-kick velocity,
        # the next step's advance sees the kicked remnant. Padded slots
        # (repeated index, valid=False) add zero.
        newly = kicked[aux.hm_idx] & ~c.kicked[aux.hm_idx] & aux.hm_slot_valid
        vel = vel.at[aux.hm_idx].add(
            aux.kick_vel.astype(vel.dtype) * newly[:, None]
        )

    # -- 6. interloper ----------------------------------------------------
    agb_raw = c.agb_raw
    if cfg.interloper:
        # the AGB clock uses the PRE-advance time on purpose: the
        # reference computes interloper_time = t - offset from the
        # step-START t, not t_new (al26_nbody.py:984), unlike the stellar
        # and condensation blocks which use t_new
        t_int = t - jnp.asarray(cfg.interloper_offset_time, c.pos.dtype)
        r_al, r_fe = _agb_rates(aux, t_int)
        active = t_int > 0.0
        agb_abs = dep.interloper_deposition(
            pos_old, pos, c.r_disk, lm_mask,
            interloper_index=-1,
            rate_26al=r_al * active, rate_60fe=r_fe * active,
            proximity_radius=0.1,  # pc, al26_nbody.py:1013
            bubble_radius=jnp.asarray(cfg.interloper_bubble_radius,
                                      c.pos.dtype),
            dt=dt,
        )
        slr = slr.at[:, :, CH_AGB].add(agb_abs)
        agb_raw = agb_raw + agb_abs

    # -- 7. decay ---------------------------------------------------------
    slr = dep.apply_decay(
        slr, dt, cfg.half_life_26al, cfg.half_life_60fe,
        decay_agb=cfg.interloper,
    )

    # -- 8. condensation ----------------------------------------------
    slr_final, disk_alive = dep.condense(
        slr, c.slr_final, cfg.interloper, c.tau_disk, c.disk_alive,
        lm_mask, t_new,
    )

    cluster = c.replace(
        pos=pos, vel=vel, mass=mass_new, mdot=mdot_new, kicked=kicked,
        slr=slr, slr_final=slr_final, agb_raw=agb_raw,
        disk_alive=disk_alive,
    )
    return state.replace(
        cluster=cluster, time=t_new, step_count=state.step_count + 1
    )


@functools.partial(jax.jit, static_argnames=("cfg", "n_steps", "mesh",
                                              "force_impl"))
def run_steps(state: SimState, aux: SimAux, cfg: SimConfig,
              n_steps: int, mesh=None, force_impl: str = "auto") -> SimState:
    """Scan `n_steps` physics steps on device (used between checkpoints —
    the reference saves every `steps_per_plot`=10 steps,
    al26_nbody.py:1754-1760). On the Pallas leapfrog/hermite4_block paths
    the closing force evaluation of each step is carried into the next
    (mass-delta-corrected), so a step costs ONE full O(N^2) sweep instead
    of two."""
    if _cacheable(cfg, state.cluster.n, state.cluster.pos.dtype, mesh,
                  force_impl):
        cache = fresh_cache(state, cfg,
                            _resolve_integ(cfg, state.cluster.n), mesh,
                            force_impl)
        if stride_active(cfg, state.cluster.n, state.cluster.pos.dtype,
                         mesh, force_impl):
            state, _ = run_steps_cached_strided(state, cache, aux, cfg,
                                                n_steps, mesh, force_impl)
            return state
        state, _ = run_steps_cached(state, cache, aux, cfg, n_steps,
                                    mesh, force_impl)
        return state

    def body(s, _):
        return step(s, aux, cfg, mesh, force_impl), None

    state, _ = jax.lax.scan(body, state, None, length=n_steps)
    return state


@functools.partial(jax.jit, static_argnames=("cfg", "n_steps", "mesh",
                                              "force_impl"))
def run_steps_cached(state: SimState, cache, aux: SimAux, cfg: SimConfig,
                     n_steps: int, mesh=None, force_impl: str = "auto"):
    """run_steps carrying the force cache ACROSS calls: the driver threads
    (state, cache) between checkpoint chunks so even the first step of a
    chunk reuses the previous chunk's closing evaluation."""
    def body(carry, _):
        s, ch = carry
        return _step_impl(s, aux, cfg, mesh, force_impl, ch), None

    (state, cache), _ = jax.lax.scan(body, (state, cache), None,
                                     length=n_steps)
    return state, cache


def _stride_impl(state: SimState, aux: SimAux, cfg: SimConfig, cache,
                 m: int, mesh=None, force_impl: str = "auto"):
    """m physics steps sharing ONE hermite4_block force advance over m*dt
    (the gravity stride, cfg.gravity_stride).

    The advance spans m*dt; the m-1 interior physics steps read the
    cluster at k*dt from the integrator's interior samples (slow stars:
    step-start Hermite predictor; fast stars: captured in the subcycle at
    the crossing substep — ops.integrators.hermite4_block_advance). All
    deposition/SN/decay/condensation physics still runs every dt; only the
    full O(N^2) force evaluation is strided. The virial radius (global
    wind bubble) is held at its stride-start value for ALL m physics
    steps of the stride, the closing one included (it moves O(0.1%) per
    dt). Stellar mass loss feeds back into gravity
    at stride boundaries through the exact mass-delta cache correction —
    an m*dt lag instead of the unstrided scheme's dt lag.

    Under a `mesh` the stride's two sweep points go through the mesh
    backends: the closing full evaluation is the row-sharded (or ring-
    streamed) fused sweep and the subcycle's K x N row sweeps shard their
    columns over the mesh (parallel.sharded.make_sharded_force_rows) —
    the stride economics carry to multi-chip unchanged."""
    c = state.cluster
    dt = jnp.asarray(cfg.dt, c.pos.dtype)
    dt_total = m * dt
    eps2 = jnp.asarray(cfg.eps2, c.pos.dtype)

    from ..units import G_INTERNAL

    a0, j0, pot = cache
    u = 0.5 * jnp.sum(c.mass * pot)
    mtot = jnp.sum(c.mass)
    r_vir = -G_INTERNAL * mtot * mtot / (2.0 * u)

    tree_aref = None
    if force_impl == "tree" and cfg.tree_mac == "relative":
        tree_aref = jnp.sqrt(jnp.sum(a0 * a0, axis=-1))
    final_eval_fn = _sweep_eval_fn(cfg, mesh, force_impl, c.mass,
                                   needs_jerk=True, tree_aref=tree_aref)
    if mesh is not None:
        from ..parallel.sharded import make_sharded_force_rows
        force_rows_fn = make_sharded_force_rows(mesh, c.mass, cfg.eps2)
    else:
        # the kernel rows only where `auto` would pick the kernel: the
        # tree tier reaches the stride on CPU and under x64 too
        force_rows_fn = _build_force_rows_fn(
            c.mass, cfg.eps2, backend.kernel_here(c.n, c.pos.dtype))
    pos_c, vel_c, (a1, j1, pot1), (pos_s, vel_s) = advance(
        c.pos, c.vel, c.mass, dt_total,
        integrator="hermite4_block", eta=cfg.eta_hermite,
        # the advance spans m*dt: scale the substep budget so the minimum
        # substep floor (h_min = span/max_substeps) stays dt/substeps_max,
        # the same close-encounter resolution as the unstrided integrator
        eps2=eps2, max_substeps=cfg.substeps_max * m,
        force_fn=None, k_fast=cfg.k_fast or 0,
        force_rows_fn=force_rows_fn, init_eval=(a0, j0),
        final_eval_fn=final_eval_fn, interior_samples=m - 1,
        k_ultra=cfg.k_ultra,
    )

    s = state
    pos_prev = c.pos
    for k in range(m - 1):
        s = physics_after_advance(s, aux, cfg, pos_prev, pos_s[k], vel_s[k],
                                  r_vir)
        pos_prev = pos_s[k]
    s = physics_after_advance(s, aux, cfg, pos_prev, pos_c, vel_c, r_vir)
    return s, _corrected_cache(s.cluster, c, aux, cfg, mesh, pos_c, vel_c,
                               a1, j1, pot1)


@functools.partial(jax.jit, static_argnames=("cfg", "n_strides", "m",
                                              "mesh", "force_impl"))
def run_strides_cached(state: SimState, cache, aux: SimAux, cfg: SimConfig,
                       n_strides: int, m: int, mesh=None,
                       force_impl: str = "auto"):
    """Scan n_strides gravity strides of m physics steps each."""
    def body(carry, _):
        s, ch = carry
        return _stride_impl(s, aux, cfg, ch, m, mesh, force_impl), None

    (state, cache), _ = jax.lax.scan(body, (state, cache), None,
                                     length=n_strides)
    return state, cache


def stride_active(cfg: SimConfig, n, dtype, mesh, force_impl) -> bool:
    """gravity_stride > 1 engages on every cache-capable hermite4_block
    path: the single-chip Pallas path and (round 3) the mesh backends —
    _stride_impl routes its closing sweep and subcycle rows through the
    sharded/ring sweeps when a mesh is given."""
    return (
        getattr(cfg, "gravity_stride", 1) > 1
        and _resolve_integ(cfg, n) == "hermite4_block"
        and _cacheable(cfg, n, dtype, mesh, force_impl)
    )


def run_steps_cached_strided(state: SimState, cache, aux: SimAux,
                             cfg: SimConfig, n_steps: int, mesh=None,
                             force_impl: str = "auto"):
    """Host-level composition: as many full strides as fit, then the
    remainder as plain cached steps (driver checkpoint chunks are not
    always stride-aligned)."""
    m = cfg.gravity_stride
    n_str, rem = divmod(n_steps, m)
    if n_str:
        state, cache = run_strides_cached(state, cache, aux, cfg, n_str, m,
                                          mesh, force_impl)
    if rem:
        state, cache = run_steps_cached(state, cache, aux, cfg, rem,
                                        mesh, force_impl)
    return state, cache


@functools.partial(jax.jit, static_argnames=("cfg", "n_steps", "mesh",
                                              "force_impl"))
def run_steps_traj(state: SimState, aux: SimAux, cfg: SimConfig,
                   n_steps: int, mesh=None, force_impl: str = "auto"):
    """Like run_steps, additionally collecting the interloper trajectory per
    step: (t_sim, t_interloper, x, y, z, barycentre distance) — the data the
    reference appends to interloper_trajectory.dat each step
    (al26_nbody.py:1030-1037)."""
    def body(s, _):
        s_new = step(s, aux, cfg, mesh, force_impl)
        return s_new, _traj_row(s, s_new, cfg)

    state, rows = jax.lax.scan(body, state, None, length=n_steps)
    return state, rows


def _traj_row(s_old: SimState, s_new: SimState, cfg: SimConfig):
    """One interloper-trajectory row (al26_nbody.py:1030-1037):
    (t_sim, t_interloper, x, y, z, barycentre distance)."""
    from ..ops.nbody import center_of_mass

    c = s_new.cluster
    pos_int = c.pos[-1]
    com = center_of_mass(c.pos, c.mass)
    bary_dist = jnp.sqrt(jnp.sum((pos_int - com) ** 2))
    t_int = s_old.time - jnp.asarray(cfg.interloper_offset_time, c.pos.dtype)
    return jnp.concatenate([s_old.time[None], t_int[None], pos_int,
                            bary_dist[None]])


@functools.partial(jax.jit, static_argnames=("cfg", "n_steps", "mesh",
                                              "force_impl"))
def run_steps_traj_cached(state: SimState, cache, aux: SimAux,
                          cfg: SimConfig, n_steps: int, mesh=None,
                          force_impl: str = "auto"):
    """run_steps_traj carrying the cross-step force cache: interloper
    science runs get the same one-full-sweep-per-step economics as plain
    runs (round 3; previously the trajectory path always paid the second
    sweep). Returns (state, cache, rows)."""
    def body(carry, _):
        s, ch = carry
        s_new, ch_new = _step_impl(s, aux, cfg, mesh, force_impl, ch)
        return (s_new, ch_new), _traj_row(s, s_new, cfg)

    (state, cache), rows = jax.lax.scan(body, (state, cache), None,
                                        length=n_steps)
    return state, cache, rows
