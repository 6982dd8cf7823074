"""Time integrators for the N-body subsystem.

Reference parity targets (al26_nbody.py:1709-1722): BHTree (leapfrog-like,
default), Hermite / ph4 (4th-order Hermite predictor-corrector). Both are
re-designed as jit-compiled fixed-shape programs:

  * `leapfrog_advance` — KDK leapfrog with a fixed number of substeps per
    outer step (the outer step is the physics step dt = t_f/1000,
    al26_nbody.py:786).
  * `hermite4_advance` — shared adaptive-timestep 4th-order Hermite
    (predict / evaluate / correct) iterated inside a bounded
    `lax.while_loop` until the outer step is consumed. Data-dependent
    substep counts stay entirely on device; shapes never change.

All integrators are vmappable over an ensemble axis.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..units import G_INTERNAL
from .nbody import acc_jerk_pot, acc_pot_dense


def leapfrog_advance(
    pos: jax.Array,
    vel: jax.Array,
    mass: jax.Array,
    dt: jax.Array,
    n_sub: int = 8,
    eps2: float | jax.Array = 0.0,
    g: float = G_INTERNAL,
    acc_fn=None,
    init_acc=None,
    final_eval_fn=None,
) -> Tuple[jax.Array, jax.Array]:
    """Kick-drift-kick leapfrog with `n_sub` fixed substeps.

    `final_eval_fn(pos) -> (acc, pot)`: when given, the LAST substep's
    force evaluation goes through it and the function returns
    (pos, vel, (acc, None, pot)) — the closing evaluation is at the FINAL
    positions exactly, so the caller can reuse it as the next outer step's
    opening evaluation (sim/step.py force cache).

    This is the BHTree-parity path: the reference's default gravity code is
    a leapfrog tree integrator with a FIXED internal timestep (1/64 of an
    N-body time unit) and heavy softening (al26_nbody.py:59,1712-1714).
    One force evaluation per substep (the closing kick reuses the opening
    evaluation of the next substep via the standard DKD->KDK chaining is
    not applied; we keep plain KDK with acc reuse below).
    """
    if acc_fn is None:
        def acc_fn(p):
            a, _ = acc_pot_dense(p, mass, eps2, g)
            return a

    h = dt / n_sub
    # init_acc: the caller's step-start evaluation (which also produced the
    # virial-radius potential) — skips one full O(N^2) sweep per outer step
    a0 = acc_fn(pos) if init_acc is None else init_acc

    def body(_, carry):
        p, v, a = carry
        v_half = v + 0.5 * h * a
        p_new = p + h * v_half
        a_new = acc_fn(p_new)
        v_new = v_half + 0.5 * h * a_new
        return (p_new, v_new, a_new)

    if final_eval_fn is None:
        pos, vel, _ = jax.lax.fori_loop(0, n_sub, body, (pos, vel, a0))
        return pos, vel
    # all but the last substep in the loop; the last one unrolled so its
    # evaluation can also produce the potential for the cache
    pos, vel, a = jax.lax.fori_loop(0, n_sub - 1, body, (pos, vel, a0))
    v_half = vel + 0.5 * h * a
    pos = pos + h * v_half
    a_new, pot = final_eval_fn(pos)
    vel = v_half + 0.5 * h * a_new
    return pos, vel, (a_new, None, pot)


def hermite4_advance(
    pos: jax.Array,
    vel: jax.Array,
    mass: jax.Array,
    dt: jax.Array,
    eta: float = 0.14,
    eps2: float | jax.Array = 0.0,
    g: float = G_INTERNAL,
    max_substeps: int = 4096,
    force_block: int | None = None,
    force_fn=None,
    init_eval=None,
    force_pot_fn=None,
) -> Tuple[jax.Array, jax.Array]:
    """Advance (pos, vel) by dt with shared adaptive-timestep Hermite4.

    The shared substep is h = eta * min_i |a_i| / |jerk_i| (simple Aarseth
    criterion), clamped so the outer step finishes within `max_substeps`.
    One force evaluation per substep (the predictor reuses the previous
    corrector's derivatives), matching the classic P(EC) scheme.

    `force_fn(pos, vel) -> (acc, jerk)` overrides the default dense/chunked
    evaluation — this is the hook through which the Pallas kernel
    (ops.pallas_nbody) and the multi-chip row-sharded kernel
    (parallel.sharded) plug into the same integrator.

    `force_pot_fn(pos, vel) -> (acc, jerk, pot)`: when given, EVERY substep
    evaluation goes through it and the advance returns
    (pos, vel, (acc, jerk, pot)) — the last substep's evaluation, taken at
    that substep's PREDICTED state exactly as the loop itself consumes it
    (standard P(EC) semantics). The caller reuses it as the next outer
    step's opening evaluation, saving one full O(N^2) sweep per outer step
    (S evals instead of S+1 for S substeps; the potential adds ~10% to each
    sweep — a win for the S <= ~8 typical of the default configuration).
    """
    dtype = pos.dtype
    tiny = jnp.asarray(1e-30, dtype)

    if force_fn is None:
        def force_fn(p, v):
            a, j, _ = acc_jerk_pot(p, v, mass, eps2, g, block=force_block)
            return a, j
    want_cache = force_pot_fn is not None
    if want_cache:
        forces = force_pot_fn
    else:
        def forces(p, v):
            a, j = force_fn(p, v)
            return a, j, None

    if init_eval is None:
        a0, j0, pot0 = forces(pos, vel)
    else:
        a0, j0 = init_eval
        pot0 = jnp.zeros(pos.shape[0], dtype) if want_cache else None
    if want_cache and pot0 is None:
        pot0 = jnp.zeros(pos.shape[0], dtype)
    h_min = dt / max_substeps

    def timestep(a, j, t_left):
        a2 = jnp.sum(a * a, axis=-1)
        j2 = jnp.sum(j * j, axis=-1)
        h = eta * jnp.sqrt(jnp.min(a2 / jnp.maximum(j2, tiny)))
        h = jnp.maximum(h, h_min)
        return jnp.minimum(h, t_left)

    def cond(carry):
        t, *_ = carry
        return t < dt

    def body(carry):
        t, p, v, a, j, pot = carry
        h = timestep(a, j, dt - t)
        h2 = h * h
        # predict
        pp = p + h * v + 0.5 * h2 * a + (h2 * h / 6.0) * j
        vp = v + h * a + 0.5 * h2 * j
        # evaluate
        a1, j1, pot1 = forces(pp, vp)
        # correct (Makino & Aarseth 1992 two-stage corrector)
        v1 = v + 0.5 * h * (a + a1) + (h2 / 12.0) * (j - j1)
        p1 = p + 0.5 * h * (v + v1) + (h2 / 12.0) * (a - a1)
        if not want_cache:
            pot1 = pot
        return (t + h, p1, v1, a1, j1, pot1)

    t0 = jnp.zeros((), dtype)
    _, pos, vel, a_f, j_f, pot_f = jax.lax.while_loop(
        cond, body, (t0, pos, vel, a0, j0, pot0)
    )
    if want_cache:
        return pos, vel, (a_f, j_f, pot_f)
    return pos, vel


def hermite4_block_advance(
    pos: jax.Array,
    vel: jax.Array,
    mass: jax.Array,
    dt: jax.Array,
    k_fast: int,
    eta: float = 0.14,
    eps2: float | jax.Array = 0.0,
    g: float = G_INTERNAL,
    max_substeps: int = 4096,
    force_fn=None,
    force_rows_fn=None,
    init_eval=None,
    final_eval_fn=None,
    interior_samples: int = 0,
    k_ultra: int = 0,
) -> Tuple[jax.Array, jax.Array]:
    """Two-group block-timestep Hermite (ph4-style, fixed shapes).

    `0 < k_ultra < k_fast` enables the THREE-level variant: the k_ultra
    rows with the smallest timestep criterion subcycle at the shared
    minimum as usual, and the remaining `mid` tier advances only when the
    elapsed gap reaches its own shared-minimum step (synchronised to
    ultra substep boundaries, forced to land at dt). Multiples of 8
    recommended.

    `final_eval_fn(pos, vel) -> (acc, jerk, pot)`: when given, the closing
    full evaluation goes through it and a third element (acc, jerk, pot) is
    returned for reuse as the next step's opening evaluation. The closing
    evaluation is at the PREDICTED end state (pos_p, vel_p) — standard
    Hermite P(EC) semantics; the corrector displacement it ignores is
    O(dt^2/12 |a1 - a0|), measured to leave the energy drift unchanged at
    the default dt (docs/precision.md).

    The classic hierarchical block-timestep scheme (the reference's ph4
    option, al26_nbody.py:1715-1717) lets each particle pick its own
    power-of-two substep. A shared adaptive step instead forces EVERY
    particle onto the smallest step, whose cost explodes with N (the min of
    |a|/|jerk| over N stars keeps shrinking). This integrator is the
    fixed-shape two-level version:

      * full force evaluation at the step start; the `k_fast` particles
        with the smallest |a|/|jerk| timestep criterion form the FAST group
        (a static-size index set, so shapes never change);
      * the slow group takes one Hermite P(EC) step across the whole dt,
        its positions available to the fast group through the standard
        Hermite predictor polynomial;
      * the fast group subcycles with a shared adaptive step, each substep
        evaluating forces only on the K fast rows against all N columns
        (O(K x N) per substep instead of O(N^2)), with fast columns
        overwritten by their current subcycled state;
      * a final full evaluation at t+dt closes the slow corrector.

    Cost per step: 2 full sweeps + S_sub * K * N pairs, versus
    S_sub * N^2 for the shared-step integrator.

    `force_rows_fn(pos_rows, vel_rows, row_ids, pos_all, vel_all) ->
    (acc, jerk)` overrides the row-subset force (the Pallas row kernel on
    the GPU); defaults to the dense jnp row block.

    `interior_samples = m-1 > 0` additionally returns the full-cluster
    (pos, vel) at the m-1 interior times k*dt/m, k = 1..m-1, as a tuple
    (pos_s [m-1,N,3], vel_s [m-1,N,3]) appended to the outputs. Slow
    stars come from the step-start Hermite predictor polynomial (the same
    polynomial the subcycle itself uses for its columns); FAST stars are
    captured inside the subcycle at the crossing substep, interpolated
    with that substep's own predictor — so close encounters keep subcycle
    accuracy at the sample times. This is the gravity-stride machinery
    (sim.step: one full-force advance spanning m physics steps).
    """
    dtype = pos.dtype
    tiny = jnp.asarray(1e-30, dtype)
    n = pos.shape[0]

    if force_fn is None:
        def force_fn(p, v):
            a, j, _ = acc_jerk_pot(p, v, mass, eps2, g)
            return a, j
    if force_rows_fn is None:
        from .nbody import _row_block_acc_jerk_pot

        def force_rows_fn(pr, vr, ids, p_all, v_all):
            a, j, _ = _row_block_acc_jerk_pot(
                pr, vr, p_all, v_all, mass, eps2, g, ids, with_pot=False
            )
            return a, j

    # -- step-start evaluation + fast-group selection -----------------------
    a0, j0 = force_fn(pos, vel) if init_eval is None else init_eval
    a2 = jnp.sum(a0 * a0, axis=-1)
    j2 = jnp.sum(j0 * j0, axis=-1)
    crit = jnp.sqrt(a2 / jnp.maximum(j2, tiny))      # per-particle h/eta
    _, fast_idx = jax.lax.top_k(-crit, k_fast)
    fast_idx = fast_idx.astype(jnp.int32)

    dt2 = dt * dt

    def predict_all(tau):
        """Hermite predictor for every particle at step-start + tau."""
        t2 = tau * tau
        p = pos + tau * vel + 0.5 * t2 * a0 + (t2 * tau / 6.0) * j0
        v = vel + tau * a0 + 0.5 * t2 * j0
        return p, v

    # -- fast-group subcycle -------------------------------------------
    pf0 = pos[fast_idx]
    vf0 = vel[fast_idx]
    af0 = a0[fast_idx]
    jf0 = j0[fast_idx]
    h_min = dt / max_substeps
    m_s = interior_samples
    if m_s:
        # interior sample times k*dt/m, k = 1..m-1 (gravity stride)
        tau_s = (jnp.arange(1, m_s + 1, dtype=dtype) / (m_s + 1)) * dt
        samp_pf0 = jnp.zeros((m_s,) + pf0.shape, dtype)
        samp_vf0 = jnp.zeros((m_s,) + vf0.shape, dtype)

    def cond(carry):
        return carry[0] < dt

    def body(carry):
        tau, pf, vf, af, jf, samp_pf, samp_vf = carry
        fa2 = jnp.sum(af * af, axis=-1)
        fj2 = jnp.sum(jf * jf, axis=-1)
        h = eta * jnp.sqrt(jnp.min(fa2 / jnp.maximum(fj2, tiny)))
        h = jnp.minimum(jnp.maximum(h, h_min), dt - tau)
        h2 = h * h
        # predict fast rows
        pfp = pf + h * vf + 0.5 * h2 * af + (h2 * h / 6.0) * jf
        vfp = vf + h * af + 0.5 * h2 * jf
        if m_s:
            # capture fast-group states at interior sample times this
            # substep crosses, via THIS substep's predictor polynomial
            th = (tau_s - tau)[:, None, None]            # [m_s,1,1]
            crossed = ((tau < tau_s) & (tau + h >= tau_s))[:, None, None]
            p_at = pf + th * vf + 0.5 * th**2 * af + (th**3 / 6.0) * jf
            v_at = vf + th * af + 0.5 * th**2 * jf
            samp_pf = jnp.where(crossed, p_at, samp_pf)
            samp_vf = jnp.where(crossed, v_at, samp_vf)
        # columns at tau+h: everyone predicted, fast rows replaced by
        # their subcycled prediction
        p_cols, v_cols = predict_all(tau + h)
        p_cols = p_cols.at[fast_idx].set(pfp)
        v_cols = v_cols.at[fast_idx].set(vfp)
        a1, j1 = force_rows_fn(pfp, vfp, fast_idx, p_cols, v_cols)
        vf1 = vf + 0.5 * h * (af + a1) + (h2 / 12.0) * (jf - j1)
        pf1 = pf + 0.5 * h * (vf + vf1) + (h2 / 12.0) * (af - a1)
        return (tau + h, pf1, vf1, a1, j1, samp_pf, samp_vf)

    tau0 = jnp.zeros((), dtype)
    if 0 < k_ultra < k_fast:
        # -- three-level variant: the k_ultra fastest rows subcycle at the
        # shared-minimum step as before, while the remaining mid tier
        # advances only when the gap since its last update reaches its OWN
        # shared-minimum step (synchronised to ultra substep boundaries,
        # forced to land exactly at dt). Cost drops from S*K*N to
        # S*K_u*N + S_mid*(K-K_u)*N pair evaluations, with S_mid/S equal
        # to the crit-ratio between the tiers (docs/precision.md).
        u_idx = fast_idx[:k_ultra]      # top_k order: smallest crit first
        m_idx = fast_idx[k_ultra:]
        k_mid = k_fast - k_ultra

        def body_t(carry):
            (tau_u, tau_m, pu, vu, au, ju, pm, vm, am, jm,
             samp_pf, samp_vf) = carry
            ua2 = jnp.sum(au * au, axis=-1)
            uj2 = jnp.sum(ju * ju, axis=-1)
            h = eta * jnp.sqrt(jnp.min(ua2 / jnp.maximum(uj2, tiny)))
            h = jnp.minimum(jnp.maximum(h, h_min), dt - tau_u)
            h2 = h * h
            tau_new = tau_u + h
            ma2 = jnp.sum(am * am, axis=-1)
            mj2 = jnp.sum(jm * jm, axis=-1)
            hm_nat = eta * jnp.sqrt(jnp.min(ma2 / jnp.maximum(mj2, tiny)))
            adv_m = ((tau_new - tau_m) >= hm_nat) | (tau_new >= dt)
            # predictions: ultra over its substep, mid from ITS last update
            pup = pu + h * vu + 0.5 * h2 * au + (h2 * h / 6.0) * ju
            vup = vu + h * au + 0.5 * h2 * ju
            thm = tau_new - tau_m
            pmp = pm + thm * vm + 0.5 * thm**2 * am + (thm**3 / 6.0) * jm
            vmp = vm + thm * am + 0.5 * thm**2 * jm
            if m_s:
                crossed = ((tau_u < tau_s)
                           & (tau_new >= tau_s))[:, None, None]
                th_u = (tau_s - tau_u)[:, None, None]
                pu_at = (pu + th_u * vu + 0.5 * th_u**2 * au
                         + (th_u**3 / 6.0) * ju)
                vu_at = vu + th_u * au + 0.5 * th_u**2 * ju
                th_m = (tau_s - tau_m)[:, None, None]
                pm_at = (pm + th_m * vm + 0.5 * th_m**2 * am
                         + (th_m**3 / 6.0) * jm)
                vm_at = vm + th_m * am + 0.5 * th_m**2 * jm
                p_at = jnp.concatenate([pu_at, pm_at], axis=1)
                v_at = jnp.concatenate([vu_at, vm_at], axis=1)
                samp_pf = jnp.where(crossed, p_at, samp_pf)
                samp_vf = jnp.where(crossed, v_at, samp_vf)
            p_cols, v_cols = predict_all(tau_new)
            p_cols = p_cols.at[u_idx].set(pup).at[m_idx].set(pmp)
            v_cols = v_cols.at[u_idx].set(vup).at[m_idx].set(vmp)
            au1, ju1 = force_rows_fn(pup, vup, u_idx, p_cols, v_cols)
            vu1 = vu + 0.5 * h * (au + au1) + (h2 / 12.0) * (ju - ju1)
            pu1 = pu + 0.5 * h * (vu + vu1) + (h2 / 12.0) * (au - au1)

            def m_advance(_):
                am1, jm1 = force_rows_fn(pmp, vmp, m_idx, p_cols, v_cols)
                vm1 = (vm + 0.5 * thm * (am + am1)
                       + (thm**2 / 12.0) * (jm - jm1))
                pm1 = (pm + 0.5 * thm * (vm + vm1)
                       + (thm**2 / 12.0) * (am - am1))
                return pm1, vm1, am1, jm1, tau_new

            pm2, vm2, am2, jm2, tau_m2 = jax.lax.cond(
                adv_m, m_advance, lambda _: (pm, vm, am, jm, tau_m), None
            )
            return (tau_new, tau_m2, pu1, vu1, au1, ju1,
                    pm2, vm2, am2, jm2, samp_pf, samp_vf)

        if m_s:
            samp0 = (samp_pf0, samp_vf0)
        else:
            zero3 = jnp.zeros((0,), dtype)
            samp0 = (zero3, zero3)
        carry0 = (tau0, tau0,
                  pf0[:k_ultra], vf0[:k_ultra], af0[:k_ultra],
                  jf0[:k_ultra],
                  pf0[k_ultra:], vf0[k_ultra:], af0[k_ultra:],
                  jf0[k_ultra:]) + samp0
        out_t = jax.lax.while_loop(cond, body_t, carry0)
        (_, _, pu, vu, au, ju, pm, vm, am, jm, samp_pf, samp_vf) = out_t
        pf = jnp.concatenate([pu, pm], axis=0)   # fast_idx order
        vf = jnp.concatenate([vu, vm], axis=0)
    else:
        if m_s:
            carry0 = (tau0, pf0, vf0, af0, jf0, samp_pf0, samp_vf0)
        else:
            zero3 = jnp.zeros((0,), dtype)
            carry0 = (tau0, pf0, vf0, af0, jf0, zero3, zero3)
        _, pf, vf, af, jf, samp_pf, samp_vf = jax.lax.while_loop(
            cond, body, carry0
        )

    # -- slow-group full step ------------------------------------------
    pos_p, vel_p = predict_all(dt)
    pos_p = pos_p.at[fast_idx].set(pf)
    vel_p = vel_p.at[fast_idx].set(vf)
    pot1 = None
    if final_eval_fn is None:
        a1, j1 = force_fn(pos_p, vel_p)
    else:
        a1, j1, pot1 = final_eval_fn(pos_p, vel_p)
    vel_c = vel + 0.5 * dt * (a0 + a1) + (dt2 / 12.0) * (j0 - j1)
    pos_c = pos + 0.5 * dt * (vel + vel_c) + (dt2 / 12.0) * (a0 - a1)
    # fast rows keep their subcycled (more accurate) result
    pos_c = pos_c.at[fast_idx].set(pf)
    vel_c = vel_c.at[fast_idx].set(vf)
    out = (pos_c, vel_c)
    if final_eval_fn is not None:
        out = out + ((a1, j1, pot1),)
    if m_s:
        # full-cluster interior samples: slow stars from the step-start
        # predictor, fast rows overwritten with their captured states
        def one_sample(k):
            p_k, v_k = predict_all(tau_s[k])
            p_k = p_k.at[fast_idx].set(samp_pf[k])
            v_k = v_k.at[fast_idx].set(samp_vf[k])
            return p_k, v_k

        ps, vs = [], []
        for k in range(m_s):
            p_k, v_k = one_sample(k)
            ps.append(p_k)
            vs.append(v_k)
        out = out + ((jnp.stack(ps), jnp.stack(vs)),)
    return out


def advance(
    pos, vel, mass, dt, *, integrator: str = "hermite4",
    eta: float = 0.14, n_sub: int = 8, eps2=0.0, g=G_INTERNAL,
    max_substeps: int = 4096, force_block=None, force_fn=None, acc_fn=None,
    k_fast: int = 0, force_rows_fn=None, init_eval=None, final_eval_fn=None,
    interior_samples: int = 0, k_ultra: int = 0,
):
    """Static dispatch over the configured integrator.

    `init_eval=(a0, j0)` (or `(a0, None)` for leapfrog) injects the caller's
    step-start force evaluation so the sweep that produced the virial-radius
    potential is not repeated. `final_eval_fn` (leapfrog / hermite4_block
    only) makes the advance also return its closing (acc, jerk, pot)
    evaluation for reuse as the NEXT step's opening one."""
    if integrator == "hermite4":
        # the force cache routes EVERY substep through final_eval_fn (which
        # also returns the potential — on the Pallas kernel the pot columns
        # are computed regardless, so this is free) and returns the last
        # substep's P(EC) evaluation for reuse as the next step's opening
        # one: S sweeps per outer step instead of S+1
        return hermite4_advance(
            pos, vel, mass, dt, eta, eps2, g, max_substeps, force_block,
            force_fn, init_eval, force_pot_fn=final_eval_fn,
        )
    if integrator == "hermite4_block":
        k = k_fast or max(128, pos.shape[0] // 16)
        k = min(k, pos.shape[0])  # top_k rejects k > n (tiny clusters)
        return hermite4_block_advance(
            pos, vel, mass, dt, k,
            eta, eps2, g, max_substeps, force_fn, force_rows_fn, init_eval,
            final_eval_fn, interior_samples, k_ultra,
        )
    if integrator == "leapfrog":
        if acc_fn is None and force_fn is not None:
            def acc_fn(p):
                a, _ = force_fn(p, jnp.zeros_like(p))
                return a
        init_acc = init_eval[0] if init_eval is not None else None
        final_acc_fn = None
        if final_eval_fn is not None:
            def final_acc_fn(p):
                # honor final_eval_fn's documented (pos, vel) contract —
                # leapfrog has no meaningful velocity at the closing kick,
                # so pass zeros rather than None
                a, _, pot = final_eval_fn(p, jnp.zeros_like(p))
                return a, pot
        return leapfrog_advance(pos, vel, mass, dt, n_sub, eps2, g, acc_fn,
                                init_acc, final_acc_fn)
    raise ValueError(f"unknown integrator: {integrator}")
