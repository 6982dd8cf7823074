"""SLR deposition, decay and disc-condensation physics.

Vectorised re-design of the reference's per-step disc routines:

  * `wind_deposition`  — the O(N_lm x N_hm) pairwise wind sweep-up kernel
    (`calc_wind_abs`, al26_nbody.py:642-702), which the reference runs FOUR
    times per step (2 isotopes x {local, global} mixing models). Here one
    masked, vectorised evaluation produces all isotopes at once, and the
    global model collapses to O(N) because its per-pair term factorises:

        wind_abs[i,s] = eta_i * dt * sum_j W_ij * (wind_ratio[j,s]*mdot_j)
        eta_i         = 0.75 * r_disk_i^2 * |v_i| * dt / r_bub^3
        W_ij          = 1                      (global: r_bub = virial radius)
        W_ij          = [d_ij < r_bub]         (local:  r_bub = 0.1 pc)

    Massive stars are gathered into a fixed-width slot array `hm_idx` (the
    set of CANDIDATE massive stars is fixed at init: masses only decrease)
    so shapes stay static under jit and the pairwise work is O(N x H) with
    H = #(m0 >= 13) << N.

  * `sn_injection`     — supernova detection (wind rate exactly zero and not
    yet kicked, al26_nbody.py:946-948) and 1/d^2 disc injection
    (`calc_eta_disk_sne`, al26_nbody.py:1291-1334), as masks instead of
    per-event Python loops.

  * `interloper_deposition` — AGB flyby path-intersection deposition
    (al26_nbody.py:969-1028). The reference brute-force samples the
    straight-line paths at 1024 points (`calc_intersection`,
    al26_nbody.py:1156-1190); we solve the quadratic for the chord overlap
    in closed form (exact limit of that sampling), with the sampled variant
    kept for parity tests.

  * `decay` / `condense` — exponential decay with the reference's
    hard-coded constants (al26_nbody.py:1045-1068) and disc-death
    snapshotting (al26_nbody.py:1070-1086).

All units internal (Msun/pc/Myr); all functions pure + vmappable.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..state import CH_AGB
from ..units import LN2_REFERENCE
from .backend import einsum

# Lichtenberg+2016 SN injection constants (al26_nbody.py:1327-1329)
SN_COS60 = 0.5
SN_ETA_COND = 0.5
SN_ETA_INJ = 0.7


def eta_bubble_wind(r_disk, d_trav, r_bub):
    """Disc sweep-up cross-section fraction (al26_nbody.py:1241-1254)."""
    return 0.75 * (r_disk**2) * d_trav / (r_bub**3)


def eta_disk_sne(r_disk, d=None, *, d2=None):
    """SN injection efficiency (al26_nbody.py:1291-1334). Takes the
    distance `d` (reference signature) or its square `d2` directly —
    sn_injection already holds the [N,H] squared distances, and a
    sqrt+square round trip would perturb the golden-pinned bits."""
    if d2 is None:
        d2 = d * d
    eta_geom = (SN_COS60 * r_disk**2) / (4.0 * d2)
    return SN_ETA_COND * SN_ETA_INJ * eta_geom


def wind_deposition(
    pos: jax.Array,          # [N,3] pc
    vel: jax.Array,          # [N,3] pc/Myr
    r_disk: jax.Array,       # [N]   pc
    lm_mask: jax.Array,      # [N]   bool (disc-bearing targets)
    hm_idx: jax.Array,       # [H]   int  (fixed massive-star candidate slots)
    hm_valid: jax.Array,     # [H]   bool (slot currently a >=13 Msun star)
    mdot: jax.Array,         # [N]   Msun/Myr (>= 0)
    wind_ratio: jax.Array,   # [N,S] dimensionless
    bubble_radius: jax.Array,  # scalar pc (virial radius for global model,
    #                            0.1 pc for local model)
    dt: jax.Array,           # scalar Myr
    local: bool,             # static: local mixing model (distance cut)?
) -> jax.Array:
    """Absorbed wind SLR mass per star per isotope, [N,S] Msun."""
    speed = jnp.sqrt(jnp.sum(vel * vel, axis=-1))          # [N]
    eta = eta_bubble_wind(r_disk, speed * dt, bubble_radius)  # [N]
    src = wind_ratio[hm_idx] * (mdot[hm_idx] * hm_valid)[:, None]  # [H,S]
    if local:
        d2 = jnp.sum((pos[:, None, :] - pos[hm_idx][None, :, :]) ** 2, axis=-1)
        # deposit strictly when d < bubble_radius (ref skips when
        # bubble_radius <= d_sep, al26_nbody.py:688-690)
        within = d2 < bubble_radius**2                      # [N,H]
        contrib = einsum("nh,hs->ns", within.astype(pos.dtype), src)
    else:
        contrib = jnp.sum(src, axis=0)[None, :]             # [1,S]
        contrib = jnp.broadcast_to(contrib, (pos.shape[0], src.shape[1]))
    out = (eta * dt * lm_mask)[:, None] * contrib
    return out


def sn_injection(
    pos: jax.Array,         # [N,3]
    r_disk: jax.Array,      # [N]
    lm_mask: jax.Array,     # [N] bool
    hm_idx: jax.Array,      # [H] candidate slots (INITIAL mass >= 13)
    hm_slot_valid: jax.Array,  # [H] bool: False for padding slots
    mdot: jax.Array,        # [N] Msun/Myr AFTER the stellar-evolution update
    kicked: jax.Array,      # [N] bool
    sn_yield: jax.Array,    # [N,S] Msun
) -> Tuple[jax.Array, jax.Array]:
    """Detect SNe this step and inject yields onto every disc.

    Returns (injected [N,S], kicked' [N]). Detection: a massive-star
    CANDIDATE (initial mass >= 13 Msun) whose wind rate is now exactly zero
    and which has not been kicked. The reference gates on CURRENT mass
    (al26_nbody.py:945-948 via get_high_mass_star_indices), which silently
    drops the SN of any star whose winds take it below the threshold
    before collapse — with the default LC18 vel=300 rotating mass
    anchors that is the ENTIRE 13-25 Msun SN-progenitor range (pre-SN
    masses 5.4-9.5 Msun, models/stellar/lc18_anchors). Candidacy here is
    initial-mass-based (hm_idx is built from m0 at init), fixing that
    loss; `kicked` still guarantees exactly one injection per star.
    Padded slots (repeated indices) are masked so no star injects twice.
    SimConfig.sn_parity_mode restores the reference's current-mass RULE
    (sim/step.py folds `mass >= threshold` into `hm_slot_valid`); pair it
    with cfg.mass_tracks="seba" (round 4) for the reference's OUTCOME
    too — the SeBa-calibrated weak-wind tracks keep every >= 14 Msun
    progenitor above the gate at collapse, so the 14-25 Msun band
    actually injects (models/stellar/seba_anchors, docs/stellar_model.md).
    """
    # scatter-or: a duplicated padding slot (valid=False) must not clobber
    # the real slot's candidacy at the same index
    sn_candidate = jnp.zeros(pos.shape[0], bool).at[hm_idx].max(
        hm_slot_valid
    )
    sn_event = sn_candidate & (mdot == 0.0) & ~kicked       # [N]
    ev = sn_event[hm_idx] & hm_slot_valid                   # [H]
    d2 = jnp.sum((pos[:, None, :] - pos[hm_idx][None, :, :]) ** 2, axis=-1)
    d2 = jnp.maximum(d2, 1e-30)
    eta = eta_disk_sne(r_disk[:, None], d2=d2)
    w = eta * ev[None, :].astype(pos.dtype)                 # [N,H]
    injected = einsum("nh,hs->ns", w, sn_yield[hm_idx])
    injected = injected * lm_mask[:, None]
    return injected, kicked | sn_event


def chord_fraction(
    p1_old: jax.Array, p1_new: jax.Array,
    p2_old: jax.Array, p2_new: jax.Array,
    r: float | jax.Array,
) -> jax.Array:
    """Fraction of the step two linearly-moving points spend within r.

    Closed-form solution of |(p2-p1)(s)| <= r for s in [0,1] — the exact
    limit of the reference's 1024-point sampling (al26_nbody.py:1156-1190).
    Broadcasts over leading axes.
    """
    d0 = p2_old - p1_old
    dd = (p2_new - p2_old) - (p1_new - p1_old)
    a = jnp.sum(dd * dd, axis=-1)
    b = 2.0 * jnp.sum(d0 * dd, axis=-1)
    c = jnp.sum(d0 * d0, axis=-1) - r * r
    disc = b * b - 4.0 * a * c
    sqrt_disc = jnp.sqrt(jnp.maximum(disc, 0.0))
    safe_a = jnp.where(a > 0.0, a, 1.0)
    s1 = (-b - sqrt_disc) / (2.0 * safe_a)
    s2 = (-b + sqrt_disc) / (2.0 * safe_a)
    lo = jnp.clip(s1, 0.0, 1.0)
    hi = jnp.clip(s2, 0.0, 1.0)
    frac_moving = jnp.where(disc > 0.0, hi - lo, 0.0)
    # degenerate case: no relative motion — inside for the whole step or not
    frac_static = jnp.where(c <= 0.0, 1.0, 0.0)
    return jnp.where(a > 0.0, frac_moving, frac_static)


def chord_fraction_sampled(p1_old, p1_new, p2_old, p2_new, r, n: int = 1024):
    """Reference-parity variant: n-point straight-line sampling
    (al26_nbody.py:1156-1190)."""
    s = jnp.linspace(0.0, 1.0, n)
    p1 = p1_old[..., None, :] + s[:, None] * (p1_new - p1_old)[..., None, :]
    p2 = p2_old[..., None, :] + s[:, None] * (p2_new - p2_old)[..., None, :]
    d = jnp.sqrt(jnp.sum((p1 - p2) ** 2, axis=-1))
    return jnp.sum(d <= r, axis=-1) / n


def interloper_deposition(
    pos_old: jax.Array,      # [N,3] before the N-body advance
    pos_new: jax.Array,      # [N,3] after
    r_disk: jax.Array,       # [N]
    lm_mask: jax.Array,      # [N] bool (is_interloper already excluded)
    interloper_index: int | jax.Array,
    rate_26al: jax.Array,    # scalar Msun/Myr at the interloper's AGB clock
    rate_60fe: jax.Array,    # scalar
    proximity_radius: float, # pc — the 0.1 pc sampling radius (al26:1013)
    bubble_radius: jax.Array,  # pc — interloper wind bubble (al26:1022)
    dt: jax.Array,
    exact_chord: bool = True,
) -> jax.Array:
    """AGB interloper deposition, [N,S] Msun (al26_nbody.py:990-1028)."""
    int_old = pos_old[interloper_index]
    int_new = pos_new[interloper_index]
    if exact_chord:
        frac = chord_fraction(
            pos_old, pos_new,
            jnp.broadcast_to(int_old, pos_old.shape),
            jnp.broadcast_to(int_new, pos_new.shape),
            proximity_radius,
        )
    else:
        frac = chord_fraction_sampled(
            pos_old, pos_new,
            jnp.broadcast_to(int_old, pos_old.shape),
            jnp.broadcast_to(int_new, pos_new.shape),
            proximity_radius,
        )
    d_trav = jnp.sqrt(jnp.sum((pos_new - pos_old) ** 2, axis=-1)) * frac
    eta = eta_bubble_wind(r_disk, d_trav, bubble_radius)     # [N]
    eta = eta * lm_mask
    rates = jnp.stack([rate_26al, rate_60fe])                # [S]
    return eta[:, None] * rates[None, :] * dt


def decay_factors(dt, half_life_26al: float, half_life_60fe: float, dtype):
    """exp(-dt * ln2 / t_half) with the reference's truncated ln2
    (al26_nbody.py:1048-1051)."""
    f_al = jnp.exp(-dt * LN2_REFERENCE / half_life_26al)
    f_fe = jnp.exp(-dt * LN2_REFERENCE / half_life_60fe)
    return jnp.stack([f_al, f_fe]).astype(dtype)


def apply_decay(slr: jax.Array, dt, half_life_26al, half_life_60fe,
                decay_agb: bool) -> jax.Array:
    """Decay all reservoirs [N,S,C]. The AGB channel only decays when the
    interloper subsystem is active (al26_nbody.py:1062-1064); agb_raw never
    decays by construction (kept outside `slr`)."""
    f = decay_factors(dt, half_life_26al, half_life_60fe, slr.dtype)  # [S]
    ch_scale = jnp.ones((slr.shape[-1],), slr.dtype)
    if not decay_agb:
        ch_scale = ch_scale.at[CH_AGB].set(0.0)
        factors = 1.0 + ch_scale[None, :] * (f[:, None] - 1.0)   # [S,C]
    else:
        factors = jnp.broadcast_to(f[:, None], (slr.shape[-2], slr.shape[-1]))
    return slr * factors[None, :, :]


def condense(
    slr: jax.Array,        # [N,S,C]
    slr_final: jax.Array,  # [N,S,C]
    agb_final_enabled: bool,
    tau_disk: jax.Array,   # [N]
    disk_alive: jax.Array, # [N] bool
    lm_mask: jax.Array,    # [N] bool
    t_new: jax.Array,
) -> Tuple[jax.Array, jax.Array]:
    """Snapshot reservoirs into *_final while the disc lives; kill expired
    discs (al26_nbody.py:1070-1086). The AGB final channel is only tracked
    when the interloper is enabled, as in the reference (:1080-1082)."""
    live = lm_mask & disk_alive
    snap = live & (tau_disk >= t_new)
    ch_update = jnp.ones((slr.shape[-1],), bool)
    if not agb_final_enabled:
        ch_update = ch_update.at[CH_AGB].set(False)
    upd = snap[:, None, None] & ch_update[None, None, :]
    slr_final = jnp.where(upd, slr, slr_final)
    disk_alive = disk_alive & ~(live & (tau_disk < t_new))
    return slr_final, disk_alive
