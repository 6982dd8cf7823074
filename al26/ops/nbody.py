"""Direct-summation N-body gravity in plain JAX.

The reference delegates gravity to AMUSE C++ worker codes (BHTree default,
Hermite/ph4 selectable; al26_nbody.py:1709-1722). On an accelerator a
direct O(N^2) pairwise evaluation vectorises well and, at the cluster
sizes this domain uses (N <= ~1e5), is *more* accurate than a tree (no
multipole truncation). This module is the plain reference implementation
(jnp, row-chunked for memory; every f32 contraction pinned to HIGHEST
through ops.backend.einsum); `al26.ops.pallas_nbody` holds the tiled GPU
kernel used on the hot path, and `al26.parallel` shards row blocks across
devices.

All functions are pure, dtype-preserving and vmappable over a leading
ensemble axis.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..units import G_INTERNAL
from .backend import einsum


def _pair_terms(dx, r2):
    """inv_r, inv_r3 with the self-interaction (r2 == eps2 on diagonal)
    handled by the caller via masking."""
    inv_r = jax.lax.rsqrt(r2)
    inv_r3 = inv_r / r2
    return inv_r, inv_r3


def acc_pot_dense(
    pos: jax.Array,
    mass: jax.Array,
    eps2: float | jax.Array = 0.0,
    g: float = G_INTERNAL,
) -> Tuple[jax.Array, jax.Array]:
    """Accelerations [N,3] and per-particle potentials [N] by dense O(N^2).

    Memory O(N^2); use `acc_pot_chunked` beyond a few thousand stars.
    Potential excludes the self term: pot_i = -G sum_{j!=i} m_j / r_ij.
    """
    n = pos.shape[0]
    dx = pos[None, :, :] - pos[:, None, :]          # x_j - x_i
    r2 = jnp.sum(dx * dx, axis=-1) + eps2
    inv_r, inv_r3 = _pair_terms(dx, r2)
    eye = jnp.eye(n, dtype=bool)
    inv_r = jnp.where(eye, 0.0, inv_r)
    inv_r3 = jnp.where(eye, 0.0, inv_r3)
    acc = g * einsum("ij,ijk->ik", mass[None, :] * inv_r3, dx)
    pot = -g * jnp.sum(mass[None, :] * inv_r, axis=1)
    return acc, pot


def acc_jerk_pot_dense(
    pos: jax.Array,
    vel: jax.Array,
    mass: jax.Array,
    eps2: float | jax.Array = 0.0,
    g: float = G_INTERNAL,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Accelerations, jerks and potentials for the Hermite scheme.

    jerk_i = G sum_j m_j [ v_ij/r^3 - 3 (x_ij . v_ij) x_ij / r^5 ]
    """
    n = pos.shape[0]
    dx = pos[None, :, :] - pos[:, None, :]
    dv = vel[None, :, :] - vel[:, None, :]
    r2 = jnp.sum(dx * dx, axis=-1) + eps2
    inv_r, inv_r3 = _pair_terms(dx, r2)
    eye = jnp.eye(n, dtype=bool)
    inv_r = jnp.where(eye, 0.0, inv_r)
    inv_r3 = jnp.where(eye, 0.0, inv_r3)
    xv = jnp.sum(dx * dv, axis=-1)                  # x_ij . v_ij
    mj3 = mass[None, :] * inv_r3
    r2_safe = jnp.where(eye, 1.0, r2)               # diagonal: 0/0 guard
    acc = g * einsum("ij,ijk->ik", mj3, dx)
    jerk = g * (
        einsum("ij,ijk->ik", mj3, dv)
        - 3.0 * einsum("ij,ijk->ik", mj3 * xv / r2_safe, dx)
    )
    pot = -g * jnp.sum(mass[None, :] * inv_r, axis=1)
    return acc, jerk, pot


def _row_block_acc_jerk_pot(pos_i, vel_i, pos, vel, mass, eps2, g, self_rows,
                            pot_eps2=None, col_offset=0, with_jerk=True,
                            with_pot=True):
    """Force on a row block [B,3] from all sources [N,3].

    `self_rows` gives the global indices of the block rows so the self pair
    can be masked out exactly; `col_offset` is the global index of the
    FIRST source column (nonzero when the caller shards the columns —
    parallel.sharded.make_sharded_force_rows). `pot_eps2` softens the
    potential separately from the forces (1e-30 ~ unsoftened) so one sweep
    serves both the integrator and the virial radius, mirroring the Pallas
    kernel (ops.pallas_nbody). `with_pot=False` skips the potential
    reduction (subcycle row sweeps discard it every substep)."""
    n = pos.shape[0]
    dx = pos[None, :, :] - pos_i[:, None, :]
    dv = vel[None, :, :] - vel_i[:, None, :]
    r2 = jnp.sum(dx * dx, axis=-1) + eps2
    inv_r = jax.lax.rsqrt(r2)
    inv_r3 = inv_r / r2
    cols = col_offset + jnp.arange(n)
    self_mask = cols[None, :] == self_rows[:, None]
    inv_r = jnp.where(self_mask, 0.0, inv_r)
    inv_r3 = jnp.where(self_mask, 0.0, inv_r3)
    mj3 = mass[None, :] * inv_r3
    acc = g * einsum("ij,ijk->ik", mj3, dx)
    if with_jerk:
        xv = jnp.sum(dx * dv, axis=-1)
        r2_safe = jnp.where(self_mask, 1.0, r2)     # diagonal: 0/0 guard
        jerk = g * (
            einsum("ij,ijk->ik", mj3, dv)
            - 3.0 * einsum("ij,ijk->ik", mj3 * xv / r2_safe, dx)
        )
    else:
        # leapfrog / potential-only sweeps skip ~40% of the pair work
        jerk = jnp.zeros_like(acc)
    if not with_pot:
        return acc, jerk, jnp.zeros(pos_i.shape[0], pos_i.dtype)
    if pot_eps2 is None:
        inv_rp = inv_r
    else:
        r2p = r2 - eps2 + pot_eps2
        inv_rp = jnp.where(self_mask, 0.0, jax.lax.rsqrt(r2p))
    pot = -g * jnp.sum(mass[None, :] * inv_rp, axis=1)
    return acc, jerk, pot


def acc_jerk_pot_chunked(
    pos: jax.Array,
    vel: jax.Array,
    mass: jax.Array,
    eps2: float | jax.Array = 0.0,
    g: float = G_INTERNAL,
    block: int = 1024,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """O(N^2) force/jerk/potential with O(N*block) memory via lax.map over
    row blocks. N is padded to a multiple of `block` with zero-mass stars."""
    n = pos.shape[0]
    nb = -(-n // block) * block
    pad = nb - n
    if pad:
        posp = jnp.pad(pos, ((0, pad), (0, 0)))
        velp = jnp.pad(vel, ((0, pad), (0, 0)))
    else:
        posp, velp = pos, vel

    rows = jnp.arange(nb).reshape(-1, block)

    def one_block(idx):
        return _row_block_acc_jerk_pot(
            posp[idx], velp[idx], pos, vel, mass, eps2, g, idx
        )

    acc, jerk, pot = jax.lax.map(one_block, rows)
    acc = acc.reshape(nb, 3)[:n]
    jerk = jerk.reshape(nb, 3)[:n]
    pot = pot.reshape(nb)[:n]
    return acc, jerk, pot


def acc_jerk_pot(
    pos, vel, mass, eps2=0.0, g=G_INTERNAL, block: Optional[int] = None
):
    """Dispatch dense vs chunked on a static size threshold."""
    n = pos.shape[0]
    if block is None:
        block = 1024
    if n <= 2048:
        return acc_jerk_pot_dense(pos, vel, mass, eps2, g)
    return acc_jerk_pot_chunked(pos, vel, mass, eps2, g, block)


# ---------------------------------------------------------------------------
# Cluster diagnostics (replacing AMUSE particle-set builtins,
# al26_nbody.py:770 virial_radius, al26_plot.py:281-299 energies)
# ---------------------------------------------------------------------------
def potential_chunked(pos, mass, eps2=0.0, g=G_INTERNAL,
                      block: int = 1024) -> jax.Array:
    """Per-particle potentials with O(N*block) memory."""
    n = pos.shape[0]
    nb = -(-n // block) * block
    pad = nb - n
    posp = jnp.pad(pos, ((0, pad), (0, 0))) if pad else pos
    rows = jnp.arange(nb).reshape(-1, block)

    def one_block(idx):
        dx = pos[None, :, :] - posp[idx][:, None, :]
        r2 = jnp.sum(dx * dx, axis=-1) + eps2
        inv_r = jax.lax.rsqrt(r2)
        cols = jnp.arange(n)
        self_mask = cols[None, :] == idx[:, None]
        inv_r = jnp.where(self_mask, 0.0, inv_r)
        return -g * jnp.sum(mass[None, :] * inv_r, axis=1)

    pot = jax.lax.map(one_block, rows)
    return pot.reshape(nb)[:n]


def potential_energy(pos, mass, eps2=0.0, g=G_INTERNAL) -> jax.Array:
    """Total potential energy U = 1/2 sum_i m_i pot_i. Dense for small N,
    row-chunked beyond (a dense N=10k sweep materialises ~10^8-element
    temporaries every step just for the virial radius)."""
    if pos.shape[0] <= 2048:
        _, pot = acc_pot_dense(pos, mass, eps2, g)
    else:
        pot = potential_chunked(pos, mass, eps2, g)
    return 0.5 * jnp.sum(mass * pot)


def kinetic_energy(vel, mass) -> jax.Array:
    return 0.5 * jnp.sum(mass * jnp.sum(vel * vel, axis=-1))


def total_energy(pos, vel, mass, eps2=0.0, g=G_INTERNAL) -> jax.Array:
    return kinetic_energy(vel, mass) + potential_energy(pos, mass, eps2, g)


def virial_radius(pos, mass, g=G_INTERNAL) -> jax.Array:
    """R_vir = -G M^2 / (2 U), matching AMUSE particles.virial_radius()
    used each step by the reference (al26_nbody.py:770). Unsoftened."""
    u = potential_energy(pos, mass, 0.0, g)
    mtot = jnp.sum(mass)
    return -g * mtot * mtot / (2.0 * u)


def center_of_mass(pos, mass) -> jax.Array:
    return jnp.sum(pos * mass[:, None], axis=0) / jnp.sum(mass)


def half_mass_radius(pos, mass) -> jax.Array:
    """Radius enclosing half the total mass about the barycentre
    (al26_nbody.py:1336-1363). Sort-based, fixed shape."""
    com = center_of_mass(pos, mass)
    d2 = jnp.sum((pos - com) ** 2, axis=-1)
    order = jnp.argsort(d2)
    csum = jnp.cumsum(mass[order])
    target = 0.5 * jnp.sum(mass)
    idx = jnp.searchsorted(csum, target)
    idx = jnp.clip(idx, 0, pos.shape[0] - 1)
    return jnp.sqrt(d2[order[idx]])


def min_intercept_time(pos, vel, lm_mask, hm_mask) -> jax.Array:
    """Minimum straight-line intercept time d_ij / |v_i| over (low-mass,
    high-mass) pairs — the reference's experimental adaptive-timestep
    criterion (`calc_min_intercept_time`, al26_nbody.py:1116-1154; there it
    is numba-parallel and gated behind a flag that exits). Vectorised,
    masked, fixed-shape; usable as a diagnostic or a timestep bound."""
    d2 = jnp.sum((pos[:, None, :] - pos[None, :, :]) ** 2, axis=-1)
    spd2 = jnp.sum(vel * vel, axis=-1)
    pair = lm_mask[:, None] & hm_mask[None, :]
    t2 = jnp.where(pair, d2 / jnp.maximum(spd2[:, None], 1e-30), jnp.inf)
    return jnp.sqrt(jnp.min(t2))


def local_densities(pos, mass, k: int = 10) -> jax.Array:
    """10th-nearest-neighbour local mass density per star
    (al26_plot.py:324-371): rho_i = sum(mass of k nearest) / (4/3 pi d_k^3).
    Dense O(N^2); diagnostics only."""
    d2 = jnp.sum((pos[:, None, :] - pos[None, :, :]) ** 2, axis=-1)
    # neighbour 0 is self; take 1..k
    neg_d2 = -d2
    _, idx = jax.lax.top_k(neg_d2, k + 1)
    nbr = idx[:, 1 : k + 1]
    m_sum = jnp.sum(mass[nbr], axis=1)
    d_k = jnp.sqrt(d2[jnp.arange(pos.shape[0])[:, None], nbr[:, -1:]])[:, 0]
    four_thirds_pi = 4.18879020479  # constant as written in al26_plot.py:327
    return m_sum / (four_thirds_pi * d_k**3)


def _mass_delta_block(acc, jerk, pot, pos_b, vel_b, targets_b, xs, vs,
                      src_idx, dm, eps2, g, group_size, pot_softened):
    """mass_delta_correction body on a row block [B] of the N targets.
    The per-row reduction over the M sources is independent of the block
    split (chunked == dense up to XLA's per-program reassociation of the
    tiny M contraction — tests/test_force_cache.py pins ~1 ulp)."""
    dx = xs[None, :, :] - pos_b[:, None, :]     # [B,M,3]
    r2 = jnp.sum(dx * dx, axis=-1) + eps2       # [B,M]
    r2 = jnp.maximum(r2, 1e-30)
    invalid = targets_b[:, None] == src_idx[None, :]        # self pairs
    if group_size > 0:
        invalid = invalid | ((targets_b[:, None] // group_size)
                             != (src_idx[None, :] // group_size))
    invr = jnp.where(invalid, 0.0, jax.lax.rsqrt(r2))
    w = dm[None, :] * invr * invr * invr        # [B,M]
    acc = acc + g * einsum("nm,nmk->nk", w, dx)
    if jerk is not None:
        dv = vs[None, :, :] - vel_b[:, None, :]
        s = 3.0 * jnp.sum(dx * dv, axis=-1) / r2
        jerk = jerk + g * (einsum("nm,nmk->nk", w, dv)
                           - einsum("nm,nmk->nk", w * s, dx))
    if pot_softened:
        pot = pot - g * einsum("nm,m->n", invr, dm)
    else:
        invr_u = jnp.where(invalid, 0.0,
                           jax.lax.rsqrt(jnp.maximum(r2 - eps2, 0.0)
                                         + 1e-30))
        pot = pot - g * einsum("nm,m->n", invr_u, dm)
    return acc, jerk, pot


# auto row-chunk threshold: above ~2^23 (N*M) pair terms the [N,M,3]
# broadcast temporaries stop being memory-trivial (at the flagship
# N=102400 x M~410 they are ~0.5 GB each; at N=204800 x M~1600 the dense
# path compiles ~10 GB of live buffers, the chunked one ~0.26 GB —
# tests/test_force_cache.py)
_MDC_DENSE_MAX = 1 << 23


def mass_delta_correction(acc, jerk, pot, pos, vel, src_idx, dm,
                          eps2, g=G_INTERNAL, group_size: int = 0,
                          pot_softened: bool = False,
                          block: int | None = None):
    """Exact update of a cached force evaluation for SOURCE-MASS changes at
    fixed positions.

    Pairwise gravity is linear in the source masses, so when only the M
    mass-evolving stars (m0 >= 8 Msun; SimAux.msrc_idx) change between
    steps, the previous step's closing (acc, jerk, pot) evaluation becomes
    this step's opening one after adding the delta-mass contributions —
    O(N*M) work instead of a fresh O(N^2) sweep (sim/step.py force cache).
    The reference instead re-evaluates the full force in its gravity worker
    every step after the stellar->gravity mass copy (al26_nbody.py:871-876).

    Conventions match ops/pallas_nbody._nbody_kernel exactly: acc/jerk
    softened by eps2; pot unsoftened (the pot_eps2=1e-30 path) by default,
    or eps2-softened with `pot_softened=True` — must mirror the sweep that
    produced the cache (cfg.softened_virial, sim/step.py:_pot_eps2), else
    the cached potential drifts from the true one on every mass-loss step.
    `jerk=None` skips the jerk update (leapfrog cache). `dm` must already
    be zero for padding slots. group_size > 0 restricts pairs to the same
    realization (flattened ensembles).

    `block` bounds the HBM footprint by lax.map-ing row blocks of the N
    targets (each per-row sum over M is the same math; XLA may
    reassociate the small M contraction differently between the two
    program shapes — ~1 ulp, tests/test_force_cache.py): None
    auto-chunks above _MDC_DENSE_MAX pair terms, 0 forces the dense path
    (mesh callers — GSPMD partitions the N axis across chips itself, and
    a lax.map over row blocks of a sharded array would reshard every
    iteration)."""
    n = pos.shape[0]
    m = src_idx.shape[0]
    xs = pos[src_idx]                           # [M,3]
    vs = vel[src_idx]
    targets = jnp.arange(n, dtype=src_idx.dtype)
    if block is None and n * m > _MDC_DENSE_MAX:
        block = max(1024, _MDC_DENSE_MAX // max(m, 1))
    if not block or block >= n:
        return _mass_delta_block(acc, jerk, pot, pos, vel, targets, xs, vs,
                                 src_idx, dm, eps2, g, group_size,
                                 pot_softened)
    nb = -(-n // block) * block
    pad = nb - n

    def prep(a):
        if pad:
            a = jnp.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1))
        return a.reshape(nb // block, block, *a.shape[1:])

    # padded target ids are -1: never equal a source index, and under
    # group_size they land in group -1 (no source group) — contributions 0
    tgt = targets if not pad else jnp.pad(targets, (0, pad),
                                          constant_values=-1)
    has_jerk = jerk is not None
    ins = (prep(acc), prep(jerk if has_jerk else acc), prep(pot),
           prep(pos), prep(vel), tgt.reshape(nb // block, block))

    def one(t):
        a_b, j_b, p_b, pb, vb, tb = t
        a_b, j_b, p_b = _mass_delta_block(
            a_b, j_b if has_jerk else None, p_b, pb, vb, tb, xs, vs,
            src_idx, dm, eps2, g, group_size, pot_softened,
        )
        return a_b, (j_b if has_jerk else a_b), p_b

    a_o, j_o, p_o = jax.lax.map(one, ins)
    acc = a_o.reshape(nb, 3)[:n]
    jerk = j_o.reshape(nb, 3)[:n] if has_jerk else None
    pot = p_o.reshape(nb)[:n]
    return acc, jerk, pot
