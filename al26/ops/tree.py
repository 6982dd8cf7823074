"""Fixed-shape Barnes-Hut tree gravity for accelerators.

The reference's default gravity is AMUSE BHTree (a classic Barnes-Hut
octree treecode, monopole cells, opening angle 0.75;
al26_nbody.py:59,1712-1714). This build's default remains exact direct
summation (more accurate than any tree — ops/pallas_nbody.py), but the
O(N^2) cost eventually wins at large N. This module
is the opt-in approximate tier for that regime — the same algorithmic
class as the reference's default solver, redesigned for XLA's static
shapes (no pointers, no recursion, no data-dependent sizes):

  1. Morton-sort stars and split the sorted order into B = 2^D
     equal-count *leaf blocks* of L stars (one (static) reshape).
  2. Build a complete binary tree over the blocks bottom-up: each node
     stores total mass, centre of mass and a bounding radius
     (levels are arrays [2^l], a static python loop over l).
  3. For every (target block, node) pair evaluate a *conservative* MAC
     (multipole acceptance criterion):

         accept  <=>  r_node < theta * (|com_node - com_block| - r_block)

     i.e. the node must look small from *every* star of the target
     block, not just from its centre. Nodes whose parent was already
     accepted are masked off top-down. Ancestor nodes of the target
     block can never be accepted for theta <= 1 (their bounding sphere
     contains the block, so |com_n - com_b| <= r_node + r_block), so no
     explicit self-exclusion is needed.
  4. Far field: accepted nodes contribute their monopole. Evaluated
     densely — every star against every node of every level, masked by
     the block-level accept matrix. That is sum_l N*2^l = 2*N*B point-
     node interactions, ~1% of the N^2 exact pair work at L = 256, and
     entirely gather-free.
  5. Near field: leaf blocks that survive to the bottom unaccepted
     (including the block itself) are resolved by exact P2P. The true
     entries of the [B, B] mask are packed into ONE flat, statically
     padded pair list of (target block, source block) indices; a
     lax.scan over fixed-size chunks evaluates [C, L, L] exact pair
     tiles and scatter-adds them into the per-block accumulators. Work
     therefore scales with the MEAN partner count, not the max — on
     fractal ICs the count distribution is heavy-tailed (N = 4e5,
     theta = 0.75: mean 171 of 2048 blocks but max 1515; a per-block
     [B, kmax] packing would pay the max and erase the entire win).
     Pair lists longer than the static budget are reported via the
     returned `overflow` flag (forces are then *underestimated*: excess
     pairs are dropped — callers must treat overflow as an error).

Cost: kavg*L*N + 2*N^2/L pair-interactions vs N^2 exact. Measured on
the production fractal ICs (D = 2.0) at N = 4e5, theta = 0.75 (the
reference BHTree's own opening angle): ~0.12 of the exact pair work.
(On centrally-concentrated Plummer ICs the geometric MAC is much
weaker — see mac_masks on the relative criterion.)

Round 5: the tier carries JERK (far field: monopole jerk with nodes
moving at their mass-weighted mean velocities; near field: exact
pairwise jerk), so the block-timestep Hermite integrator runs over
tree forces — one tree sweep per step through the force cache, with
the exact K x N fast-group subcycle on top (sim.step), composing with
the gravity stride. The leapfrog path remains for BHTree parity.

Unlike the flat single-level decomposition measured as a dead end in
ROADMAP.md ("Measured dead end (round 4)"), the multi-level MAC gives
every node a distance-proportional size bound, which is what recovers
BHTree-class accuracy (the flat K-nearest-blocks cut could not).

All functions are pure and jittable; `leaf`, `theta`, `kavg` are static.
f32-safe (no f64 required); works under vmap over a leading ensemble
axis only via outer wrapping (positions define their own sort).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..units import G_INTERNAL
from .backend import einsum


# ---------------------------------------------------------------------------
# Morton (Z-order) keys — 10 bits per axis, int32-safe (30-bit keys).
# Key resolution only has to be fine enough to make the sorted order
# spatially coherent; ties inside one 1/1024-box cell are harmless (the
# tree works on the *positions*, the keys only choose the ordering).
# ---------------------------------------------------------------------------
def _spread_bits_10(x: jax.Array) -> jax.Array:
    """Spread the low 10 bits of int32 x so consecutive bits land 3 apart
    (standard magic-number bit interleave)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton_keys(pos: jax.Array) -> jax.Array:
    """int32 Z-order keys for pos [N,3], normalised to the data bounds."""
    lo = jnp.min(pos, axis=0)
    hi = jnp.max(pos, axis=0)
    span = jnp.maximum(hi - lo, 1e-30)
    q = ((pos - lo) / span * 1023.0).astype(jnp.int32)
    q = jnp.clip(q, 0, 1023)
    return (
        _spread_bits_10(q[:, 0])
        | (_spread_bits_10(q[:, 1]) << 1)
        | (_spread_bits_10(q[:, 2]) << 2)
    )


class BlockTree(NamedTuple):
    """Complete binary tree over Morton-sorted equal-count leaf blocks.

    levels[l] holds (mass [2^l], com [2^l,3], radius [2^l]) for the 2^l
    nodes at depth l; levels[-1] are the leaves (one per block). When the
    tree is built with velocities (the Hermite path needs jerk), vel_s
    and the per-node mass-weighted mean velocities vcoms are populated;
    otherwise they are None.
    """

    order: jax.Array        # [Np] sorted-particle -> original index
    pos_s: jax.Array        # [B, L, 3] sorted, padded positions
    mass_s: jax.Array       # [B, L] sorted, padded masses (pad = 0)
    gidx_s: jax.Array       # [B, L] original index per slot (pad = Np..)
    masses: Tuple[jax.Array, ...]
    coms: Tuple[jax.Array, ...]
    radii: Tuple[jax.Array, ...]
    vel_s: jax.Array | None = None      # [B, L, 3] sorted velocities
    vcoms: Tuple[jax.Array, ...] | None = None  # per-level node velocities


def near_budget(kavg: int, b: int, chunk: int = 8) -> int:
    """Static near-field pair-list budget shared by BOTH near-field
    backends (the XLA scan and the Pallas kernel): kavg * B, rounded up
    to a multiple of the scan chunk, capped at B^2. One definition so
    the two backends agree bit-for-bit on when the list overflows
    (advisor r4: they previously rounded differently and could disagree
    near the boundary)."""
    budget = min(kavg * b, b * b)
    return min(-(-budget // chunk) * chunk, b * b)


def pack_pair_list(p2p: jax.Array, kavg: int, chunk: int = 8):
    """Flat target-major near-field pair list from the [B, B] mask,
    padded to the static near_budget: (ti, sj, ok, overflow), all 1-D of
    length near_budget(kavg, B, chunk). ONE implementation for all
    three consumers (XLA scan, Pallas kernel, mesh path — review r5:
    the packing was triplicated, the defect class near_budget exists to
    prevent). Padding entries carry ok=False with ti/sj = 0; callers
    that need a dummy-block routing re-map them."""
    b = p2p.shape[0]
    budget = near_budget(kavg, b, chunk)
    flat = p2p.reshape(-1)
    overflow = jnp.sum(flat) > budget
    idx = jnp.argsort(~flat, stable=True)[:budget]
    ok = flat[idx]
    ti = jnp.where(ok, idx // b, 0).astype(jnp.int32)
    sj = jnp.where(ok, idx % b, 0).astype(jnp.int32)
    return ti, sj, ok, overflow


def aref_block_min(tree: "BlockTree", aref: jax.Array, n: int) -> jax.Array:
    """Per-block minimum reference-acceleration magnitudes [B] for the
    relative MAC: the caller's per-star |a| [N] sorted into tree order,
    padding slots at +inf so they never weaken a block's bound. Shared
    by the single-chip and mesh entry points (review r5)."""
    pad = tree.gidx_s.size - n
    aref_s = jnp.concatenate(
        [aref[tree.order], jnp.full(pad, jnp.inf, aref.dtype)]
    ) if pad else aref[tree.order]
    return jnp.min(aref_s.reshape(tree.pos_s.shape[0], -1), axis=1)


def build_block_tree(pos: jax.Array, mass: jax.Array, leaf: int,
                     vel: jax.Array | None = None) -> BlockTree:
    """Sort by Morton key, pad to B = 2^D blocks of `leaf`, reduce the
    node properties bottom-up. Padding slots replicate the last sorted
    star's position with zero mass, so they never perturb a centre of
    mass or inflate a bounding radius. Passing `vel` additionally sorts
    velocities and reduces per-node mass-weighted mean velocities (the
    far-field monopole jerk needs them)."""
    n = pos.shape[0]
    nblocks = -(-n // leaf)
    depth = max(1, (nblocks - 1).bit_length())
    b = 1 << depth
    npad = b * leaf

    keys = morton_keys(pos)
    order = jnp.argsort(keys)
    pos_sorted = pos[order]
    mass_sorted = mass[order]
    vel_sorted = vel[order] if vel is not None else None

    pad = npad - n
    if pad:
        pos_sorted = jnp.concatenate(
            [pos_sorted, jnp.broadcast_to(pos_sorted[-1], (pad, 3))], axis=0
        )
        mass_sorted = jnp.concatenate(
            [mass_sorted, jnp.zeros(pad, mass.dtype)], axis=0
        )
        if vel_sorted is not None:
            vel_sorted = jnp.concatenate(
                [vel_sorted, jnp.zeros((pad, 3), vel.dtype)], axis=0
            )
    pos_s = pos_sorted.reshape(b, leaf, 3)
    mass_s = mass_sorted.reshape(b, leaf)
    vel_s = (vel_sorted.reshape(b, leaf, 3)
             if vel_sorted is not None else None)
    gidx = jnp.concatenate([order, jnp.arange(n, npad)]).reshape(b, leaf)

    # leaves
    m_leaf = jnp.sum(mass_s, axis=1)                          # [B]
    wsum = jnp.sum(pos_s * mass_s[..., None], axis=1)         # [B,3]
    m_safe = jnp.maximum(m_leaf, 1e-30)[:, None]
    com_leaf = jnp.where(
        m_leaf[:, None] > 0.0, wsum / m_safe, jnp.mean(pos_s, axis=1),
    )
    r_leaf = jnp.sqrt(
        jnp.max(jnp.sum((pos_s - com_leaf[:, None, :]) ** 2, axis=-1), axis=1)
    )

    masses = [m_leaf]
    coms = [com_leaf]
    radii = [r_leaf]
    vcoms = None
    if vel_s is not None:
        vw = jnp.sum(vel_s * mass_s[..., None], axis=1)
        vcoms = [jnp.where(m_leaf[:, None] > 0.0, vw / m_safe, 0.0)]
    while masses[0].shape[0] > 1:
        mc = masses[0].reshape(-1, 2)
        cc = coms[0].reshape(-1, 2, 3)
        rc = radii[0].reshape(-1, 2)
        mp = jnp.sum(mc, axis=1)
        wp = jnp.sum(cc * mc[..., None], axis=1)
        mp_safe = jnp.maximum(mp, 1e-30)[:, None]
        cp = jnp.where(
            mp[:, None] > 0.0, wp / mp_safe, jnp.mean(cc, axis=1),
        )
        rp = jnp.max(
            jnp.sqrt(jnp.sum((cc - cp[:, None, :]) ** 2, axis=-1)) + rc,
            axis=1,
        )
        masses.insert(0, mp)
        coms.insert(0, cp)
        radii.insert(0, rp)
        if vcoms is not None:
            vc = vcoms[0].reshape(-1, 2, 3)
            vp = jnp.sum(vc * mc[..., None], axis=1)
            vcoms.insert(0, jnp.where(mp[:, None] > 0.0, vp / mp_safe, 0.0))

    return BlockTree(order, pos_s, mass_s, gidx, tuple(masses), tuple(coms),
                     tuple(radii), vel_s,
                     tuple(vcoms) if vcoms is not None else None)


def mac_masks(tree: BlockTree, theta: float, g: float = G_INTERNAL,
              aref: jax.Array | None = None):
    """Per-level accept matrices.

    Returns (accepts, p2p) where accepts[l] is bool [B, 2^l] — node c at
    level l serves target block i as a monopole — and p2p is bool [B, B]
    — leaf block j must be resolved exactly for target block i. Every
    (target star, source star) pair is covered exactly once: a node is
    accepted at the first (shallowest) level whose MAC passes, its
    subtree is masked below, and unaccepted leaves fall through to p2p.

    Two acceptance criteria:

    * geometric (aref=None):  r_node < theta * (d - r_block) — the node
      must subtend less than theta from every star of the target block.
      Purely geometric BH; on equal-count blocks it is hopeless for
      centrally concentrated clusters (sparse-halo leaves are spatially
      huge, so they are never accepted even though their force
      contribution is negligible — measured: mean P2P partner count
      ~27% of all blocks on an N=4e5 Plummer sphere).
    * relative (aref [B] = per-block reference acceleration magnitude,
      e.g. min |acc| of the previous evaluation — the force cache
      already carries it): accept iff the worst-case monopole truncation
      error is a small fraction of the actual force,

          3 G M_node r_node^2 / d_min^4  <  theta * aref_block,

      with d_min = d - r_block (closest target star to the node com)
      and the expansion-validity guard d_min > r_node. This is the
      Springel (2005, GADGET-2 eq. 18) relative opening criterion
      adapted to bounding spheres; `theta` plays the role of the
      tolerance alpha (~1e-3..1e-2).
    """
    b = tree.pos_s.shape[0]
    com_b = tree.coms[-1]                                     # [B,3]
    r_b = tree.radii[-1]                                      # [B]

    accepts = []
    avail = jnp.ones((b, 1), dtype=bool)                      # level 0
    for m_l, com_l, r_l in zip(tree.masses, tree.coms, tree.radii):
        d = jnp.sqrt(
            jnp.sum((com_l[None, :, :] - com_b[:, None, :]) ** 2, axis=-1)
        )                                                     # [B, 2^l]
        if aref is None:
            ok = r_l[None, :] < theta * (d - r_b[:, None])
        else:
            dmin = d - r_b[:, None]
            valid = dmin > r_l[None, :]
            err = 3.0 * g * m_l[None, :] * r_l[None, :] ** 2 \
                / jnp.maximum(dmin, 1e-30) ** 4
            ok = valid & (err < theta * aref[:, None])
        acc = avail & ok
        accepts.append(acc)
        if m_l.shape[0] < b:
            child_avail = avail & ~acc                        # [B, 2^l]
            avail = jnp.repeat(child_avail, 2, axis=1)        # [B, 2^(l+1)]
    p2p = avail & ~accepts[-1]                                # [B, B]
    return accepts, p2p


def _monopole_far_field(tree, accepts, eps2, g, pot_eps2, chunk=128,
                        with_jerk=False):
    """Masked dense point-node monopole sweep.

    All tree levels are flattened into one node axis (C_tot = 2B - 1
    nodes) and evaluated in target-block chunks of `chunk` blocks, so
    peak memory is [chunk, L, C_tot] regardless of N. The quadratic
    forms use the matmul identity (r^2 = |x|^2 + |c|^2 - 2 x.c; the
    monopole sum factorises as (sum_c s_c com_c) - pos * sum_c s_c), so
    the two O(L*C) contractions per chunk are matrix products instead of
    materialising a [.., 3] displacement tensor. The |x|^2-cancellation
    this identity risks is bounded here: accepted nodes are far
    (d > r_node / theta), so r^2 is never tiny relative to |x|^2 at the
    scales f32 cares about; the near field keeps the exact dx form.

    `with_jerk` (requires a velocity-built tree) adds the monopole jerk

        jerk_i = G sum_c [ s_c v_rel - 3 s_c (d.v_rel)/r^2 d ],
        d = com_c - x_i,  v_rel = vcom_c - v_i,  s_c = m_c / r^3,

    with every contraction factorised the same matmul way (the pairwise
    scalar d.v_rel expands into four dot products, two of them einsums).
    The monopole jerk treats each node as a point moving at its
    mass-weighted mean velocity — the standard treecode approximation
    (exact for the force derivative of the monopole itself; the
    neglected internal-motion terms are the same order as the
    truncation the MAC already admits). Jerk only steers the Hermite
    timestep criterion and corrector, so this accuracy class is ample.
    """
    m_all = jnp.concatenate(tree.masses)                      # [C]
    com_all = jnp.concatenate(tree.coms, axis=0)              # [C,3]
    mask_all = jnp.concatenate(accepts, axis=1)               # [B,C]
    w_all = jnp.where(mask_all, m_all[None, :], 0.0)          # [B,C]
    vcom_all = (jnp.concatenate(tree.vcoms, axis=0)
                if with_jerk else None)
    return _far_field_rows(tree.pos_s, tree.vel_s, w_all, com_all,
                           vcom_all, eps2, g, pot_eps2, chunk, with_jerk)


def _far_field_rows(pos_s, vel_s, w_all, com_all, vcom_all, eps2, g,
                    pot_eps2, chunk=128, with_jerk=False):
    """Array-explicit far field over a (slice of the) target-block axis:
    pos_s/vel_s [B_loc, L, 3], w_all [B_loc, C] against the REPLICATED
    node axis com_all/vcom_all [C, 3]. Split out of _monopole_far_field
    so the mesh path can shard the target axis (shard_map over row
    blocks; nodes replicated — no collective needed, the node sum is
    local per target)."""
    b, leaf, _ = pos_s.shape
    com_sq = jnp.sum(com_all * com_all, axis=-1)              # [C]
    # cap the [chunk, L, C] temporaries at ~128 MiB f32 each: at
    # N = 4e5+ (C = 2B-1 ~ 4k) a chunk of 128 blocks makes them ~540 MiB
    # and the several live at once (r2/inv_r/s, + rv/q with jerk) OOM the
    # chip. chunk is a power of two so it divides b exactly.
    c_tot = int(com_all.shape[0])
    cap = max(1, (32 * 1024 * 1024) // max(leaf * c_tot, 1))
    cap = 1 << (cap.bit_length() - 1)
    chunk = min(chunk, b, cap)
    # precision: at the GPU's default f32 matmul precision (TF32, ~3
    # decimal digits) the r^2 identity would cancel catastrophically for
    # the masked-out NEAR pairs (dense evaluation covers them too), going
    # negative past eps2 -> rsqrt(NaN) -> 0 * NaN poisons the mask, and
    # accepted-pair forces would degrade to ~1e-3 relative. backend.einsum
    # pins HIGHEST; the far field is ~1-3% of the sweep's pair work.
    if with_jerk:
        cvdot = jnp.sum(com_all * vcom_all, axis=-1)          # [C]

    def one_chunk(args):
        if with_jerk:
            pos_c, vel_c, w_c = args                # [Bc,L,3] x2, [Bc,C]
        else:
            pos_c, w_c = args
        dot = einsum("blk,ck->blc", pos_c, com_all)
        # clamp: masked-out near pairs (a star against its own ancestor
        # nodes) cancel to ~0 and can land slightly negative in f32;
        # their w is 0, but rsqrt(negative) would poison 0 * NaN
        r2 = jnp.maximum(
            jnp.sum(pos_c * pos_c, axis=-1)[..., None]
            + com_sq[None, None, :] - 2.0 * dot + eps2, 1e-30)
        inv_r = jax.lax.rsqrt(r2)
        s = w_c[:, None, :] * inv_r / r2                      # [Bc,L,C]
        s_sum = jnp.sum(s, axis=-1)[..., None]
        acc = g * (einsum("blc,ck->blk", s, com_all)
                   - pos_c * s_sum)
        jerk = None
        if with_jerk:
            xv = jnp.sum(pos_c * vel_c, axis=-1)              # [Bc,L]
            rv = (cvdot[None, None, :]
                  - einsum("blk,ck->blc", vel_c, com_all)
                  - einsum("blk,ck->blc", pos_c, vcom_all)
                  + xv[..., None])                            # [Bc,L,C]
            q = 3.0 * s * rv / r2
            q_sum = jnp.sum(q, axis=-1)[..., None]
            jerk = g * (einsum("blc,ck->blk", s, vcom_all)
                        - vel_c * s_sum
                        - einsum("blc,ck->blk", q, com_all)
                        + pos_c * q_sum)
        if pot_eps2 is not None:
            r2p = jnp.maximum(r2 - eps2 + pot_eps2, 1e-30)
            inv_r = jax.lax.rsqrt(r2p)
        pot = -g * jnp.sum(w_c[:, None, :] * inv_r, axis=-1)
        if with_jerk:
            return acc, jerk, pot
        return acc, pot

    pos_ch = pos_s.reshape(b // chunk, chunk, leaf, 3)
    w_ch = w_all.reshape(b // chunk, chunk, -1)
    if with_jerk:
        vel_ch = vel_s.reshape(b // chunk, chunk, leaf, 3)
        acc, jerk, pot = jax.lax.map(one_chunk, (pos_ch, vel_ch, w_ch))
        return (acc.reshape(b, leaf, 3), jerk.reshape(b, leaf, 3),
                pot.reshape(b, leaf))
    acc, pot = jax.lax.map(one_chunk, (pos_ch, w_ch))
    return acc.reshape(b, leaf, 3), None, pot.reshape(b, leaf)


def _p2p_near_field(tree, p2p, eps2, g, pot_eps2, kavg, chunk=8,
                    with_jerk=False):
    """Exact pair sweep over the MAC-failing (target, source) leaf pairs.

    The true entries of the [B, B] p2p mask are packed into one flat
    pair list padded to the static budget (near_budget — shared with the
    Pallas backend; stable argsort of the raveled mask keeps pairs
    target-major); a lax.scan over chunks of `chunk` pairs evaluates
    [C, L, L] exact tiles and scatter-adds them into the [B, L]
    accumulators. Cost scales with the MEAN partner count (the budget),
    never the per-block max. `with_jerk` adds the exact pairwise jerk
    (velocity-built tree required).
    """
    b = tree.pos_s.shape[0]
    chunk = min(chunk, b * b)               # b, chunk: powers of two
    ti, sj, ok, overflow = pack_pair_list(p2p, kavg, chunk)
    acc, jerk, pot = _p2p_scan(tree.pos_s, tree.vel_s, tree.mass_s,
                               tree.gidx_s, ti.reshape(-1, chunk),
                               sj.reshape(-1, chunk),
                               ok.reshape(-1, chunk), eps2, g,
                               pot_eps2, with_jerk)
    return acc, jerk, pot, overflow


def _p2p_scan(pos_s, vel_s, mass_s, gidx_s, ti, sj, ok, eps2, g,
              pot_eps2, with_jerk=False):
    """Scatter-add scan over a ([n_chunks, chunk]) pair-list slice into
    FULL-size [B, L] accumulators. Split from _p2p_near_field so the
    mesh path can shard the pair axis (each device scans its slice; the
    full-size accumulators psum across the mesh)."""
    b, leaf, _ = pos_s.shape
    dtype = pos_s.dtype

    def one_chunk(carry, slot):
        acc, jerk, pot = carry
        i_c, j_c, ok_c = slot                                 # [C] each
        pos_t = pos_s[i_c]                                    # [C,L,3]
        gidx_t = gidx_s[i_c]                                  # [C,L]
        pos_j = pos_s[j_c]
        mass_j = jnp.where(ok_c[:, None], mass_s[j_c], 0.0)
        gidx_j = gidx_s[j_c]
        dx = pos_j[:, None, :, :] - pos_t[:, :, None, :]      # [C,Lt,Ls,3]
        r2 = jnp.sum(dx * dx, axis=-1) + eps2
        self_pair = gidx_j[:, None, :] == gidx_t[:, :, None]
        inv_r = jnp.where(self_pair, 0.0, jax.lax.rsqrt(r2))
        r2_safe = jnp.where(self_pair, 1.0, r2)
        mj3 = mass_j[:, None, :] * inv_r / r2_safe
        # HIGHEST (backend.einsum): in TF32 these contractions would put
        # ~1e-3 relative error on the exact near field, the part of the
        # tree that exists to be exact
        d_acc = g * einsum("cij,cijk->cik", mj3, dx)          # [C,L,3]
        if with_jerk:
            dv = (vel_s[j_c][:, None, :, :]
                  - vel_s[i_c][:, :, None, :])
            rv = jnp.sum(dx * dv, axis=-1)
            q = 3.0 * mj3 * rv / r2_safe
            d_jerk = g * (einsum("cij,cijk->cik", mj3, dv)
                          - einsum("cij,cijk->cik", q, dx))
            jerk = jerk.at[i_c].add(d_jerk)
        if pot_eps2 is not None:
            r2p = r2 - eps2 + pot_eps2
            inv_r = jnp.where(self_pair, 0.0, jax.lax.rsqrt(r2p))
        d_pot = -g * jnp.sum(mass_j[:, None, :] * inv_r, axis=-1)
        return (acc.at[i_c].add(d_acc), jerk, pot.at[i_c].add(d_pot)), None

    init = (jnp.zeros((b, leaf, 3), dtype),
            jnp.zeros((b, leaf, 3), dtype) if with_jerk
            else jnp.zeros((), dtype),
            jnp.zeros((b, leaf), dtype))
    (acc, jerk, pot), _ = jax.lax.scan(one_chunk, init, (ti, sj, ok))
    return acc, (jerk if with_jerk else None), pot


def _check_theta(theta: float, aref) -> None:
    """Geometric-MAC validity (advisor r4): the no-self-interaction
    argument (an ancestor node's bounding sphere contains the target
    block, so it can never pass r_node < theta * (d - r_block)) only
    holds for theta <= 1. The relative criterion carries its own
    d_min > r_node validity guard, so there `theta` is the tolerance
    alpha and any positive value is safe. Raised at trace time (theta
    is static)."""
    if theta <= 0.0:
        raise ValueError(f"tree_theta={theta}: must be > 0")
    if aref is None and theta > 1.0:
        raise ValueError(
            f"tree_theta={theta}: the geometric MAC requires theta <= 1 "
            "(above that an accepted ancestor node would double-count "
            "the target block's own stars); use the relative criterion "
            "(aref) for aggressive opening instead"
        )


@partial(jax.jit, static_argnames=("leaf", "theta", "kavg", "g",
                                   "with_jerk"))
def tree_acc_jerk_pot(
    pos: jax.Array,
    vel: jax.Array | None,
    mass: jax.Array,
    eps2: float | jax.Array = 0.0,
    g: float = G_INTERNAL,
    *,
    leaf: int = 256,
    theta: float = 0.5,
    kavg: int = 256,
    pot_eps2: float | None = None,
    aref: jax.Array | None = None,
    with_jerk: bool = False,
) -> Tuple[jax.Array, jax.Array | None, jax.Array, jax.Array]:
    """Barnes-Hut accelerations [N,3], jerks [N,3] (None unless
    `with_jerk`), potentials [N] and an `overflow` bool (true => the
    near-field pair list exceeded the near_budget(kavg, B) budget and
    the result is truncated; treat as an error and re-run with a larger
    kavg or a larger leaf — size kavg with p2p_partner_counts).

    `with_jerk` makes the tier Hermite-capable (round 5): the far field
    adds the monopole jerk (nodes as points moving at their mass-
    weighted mean velocity), the near field the exact pairwise jerk.
    `aref` [N]: per-star reference acceleration magnitudes (previous
    evaluation) switching the MAC to the relative criterion (see
    mac_masks); None uses the geometric criterion.
    `pot_eps2` softens the potential separately from the forces (same
    convention as ops.nbody._row_block_acc_jerk_pot / the Pallas kernel);
    None reuses `eps2`.
    """
    _check_theta(theta, aref)
    n = pos.shape[0]
    tree = build_block_tree(pos, mass, leaf,
                            vel if with_jerk else None)
    aref_b = aref_block_min(tree, aref, n) if aref is not None else None
    accepts, p2p = mac_masks(tree, theta, g, aref_b)
    far_acc, far_jerk, far_pot = _monopole_far_field(
        tree, accepts, eps2, g, pot_eps2, with_jerk=with_jerk
    )
    near_acc, near_jerk, near_pot, overflow = _p2p_near_field(
        tree, p2p, eps2, g, pot_eps2, kavg, with_jerk=with_jerk
    )
    acc_s = (far_acc + near_acc).reshape(-1, 3)
    pot_s = (far_pot + near_pot).reshape(-1)

    npad = acc_s.shape[0]
    inv = jnp.zeros(npad, jnp.int32).at[tree.gidx_s.reshape(-1)].set(
        jnp.arange(npad, dtype=jnp.int32)
    )
    acc = acc_s[inv[:n]]
    pot = pot_s[inv[:n]]
    jerk = None
    if with_jerk:
        jerk = (far_jerk + near_jerk).reshape(-1, 3)[inv[:n]]
    return acc, jerk, pot, overflow


def tree_acc_pot(
    pos: jax.Array,
    mass: jax.Array,
    eps2: float | jax.Array = 0.0,
    g: float = G_INTERNAL,
    *,
    leaf: int = 256,
    theta: float = 0.5,
    kavg: int = 256,
    pot_eps2: float | None = None,
    aref: jax.Array | None = None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """(acc [N,3], pot [N], overflow) — the jerk-free entry point (the
    leapfrog path and the diagnostics use it)."""
    acc, _, pot, overflow = tree_acc_jerk_pot(
        pos, None, mass, eps2, g, leaf=leaf, theta=theta, kavg=kavg,
        pot_eps2=pot_eps2, aref=aref, with_jerk=False,
    )
    return acc, pot, overflow


def make_tree_sweep(mass, eps2, *, leaf: int, theta: float, kavg: int,
                    pot_eps2: float | None, g: float = G_INTERNAL,
                    with_jerk: bool = False, aref: jax.Array | None = None):
    """Full-sweep `(pos, vel) -> (acc, jerk, pot)` for sim.step: the
    tree-tier analogue of ops.pallas_nbody.pallas_acc_jerk_pot.
    `with_jerk=False` (the leapfrog tier) returns zeros for jerk — the
    pallas_acc_jerk_pot with_jerk=False convention, so the force-cache
    pytree is scan-stable; True returns the real tree jerk (the
    hermite4_block tier). A near-field pair-budget overflow POISONS the
    outputs with NaN: silent force truncation must never pass as
    physics, and utils.validate's finiteness check turns the poison into
    a loud error at the next checkpoint boundary (the in-jit path cannot
    raise)."""

    def sweep(pos, vel=None):
        acc, jerk, pot, ovf = tree_acc_jerk_pot(
            pos, vel, mass, eps2, g, leaf=leaf, theta=theta, kavg=kavg,
            pot_eps2=pot_eps2, with_jerk=with_jerk, aref=aref,
        )
        poison = jnp.where(ovf, jnp.nan, 0.0).astype(acc.dtype)
        if jerk is None:
            jerk = jnp.zeros_like(acc)
        else:
            jerk = jerk + poison
        return acc + poison, jerk, pot + poison

    return sweep


def make_tree_force(mass, eps2, *, leaf: int, theta: float, kavg: int,
                    g: float = G_INTERNAL):
    """`(pos, vel) -> (acc, jerk)` for the Hermite integrators'
    force_fn hook (overflow NaN-poisons, as everywhere in the tier)."""

    def force_fn(pos, vel):
        acc, jerk, _, ovf = tree_acc_jerk_pot(
            pos, vel, mass, eps2, g, leaf=leaf, theta=theta, kavg=kavg,
            with_jerk=True,
        )
        poison = jnp.where(ovf, jnp.nan, 0.0).astype(acc.dtype)
        return acc + poison, jerk + poison

    return force_fn


def make_tree_acc(mass, eps2, *, leaf: int, theta: float, kavg: int,
                  g: float = G_INTERNAL):
    """Substep `pos -> acc` for the leapfrog interior evaluations (the
    potential reuses the force softening — no second rsqrt)."""

    def acc_fn(pos):
        acc, _, ovf = tree_acc_pot(
            pos, mass, eps2, g, leaf=leaf, theta=theta, kavg=kavg,
        )
        return acc + jnp.where(ovf, jnp.nan, 0.0).astype(acc.dtype)

    return acc_fn


@partial(jax.jit, static_argnames=("leaf", "theta", "g"))
def p2p_partner_counts(pos: jax.Array, mass: jax.Array, leaf: int = 256,
                       theta: float = 0.5, g: float = G_INTERNAL,
                       aref: jax.Array | None = None) -> jax.Array:
    """Diagnostic: per-block near-field partner counts [B] (for sizing
    kavg = ceil(mean count) on a given distribution before committing
    to a run; overflow then flags any drift past the budget). Jitted —
    the tree build + MAC are hundreds of small ops."""
    n = pos.shape[0]
    tree = build_block_tree(pos, mass, leaf)
    aref_b = aref_block_min(tree, aref, n) if aref is not None else None
    _, p2p = mac_masks(tree, theta, g, aref_b)
    return jnp.sum(p2p, axis=1)
