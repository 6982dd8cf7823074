"""Barnes-Hut tree sweep over a device mesh (round 5, VERDICT r4 item 4).

The reference's default BHTree solver runs with number_of_workers=8
(al26_nbody.py:57,1712-1714) — force work partitioned across worker
processes against a shared tree. The device-mesh equivalent here is the
classic replicated-tree decomposition: every device builds the SAME tree
(positions are replicated under the all-gather row-sharding scheme the
mesh backends already use, so the Morton sort + node reduction are
redundant O(N log N) work per chip — cheap next to the force sweeps),
and the two heavy phases partition:

  * FAR FIELD — the dense masked point-node sweep shards its TARGET
    block axis across the mesh (ops.tree._far_field_rows over the local
    row slice; the node axis is replicated, so no collective is
    needed);
  * NEAR FIELD — the flat MAC-failing pair list shards its PAIR axis:
    each chip scatter-scans its slice of the list into full-size
    accumulators (ops.tree._p2p_scan) and one psum completes the sum
    (pairs of the same target block can land on different chips, which
    is exactly what makes the partition balanced under heavy-tailed
    per-block partner counts).

Results are returned fully replicated (P() outputs) — the step's
deposition physics runs replicated under the mesh paths, exactly like
the all-gather sharded backend's consumers. hermite4_block-only, like
the single-chip relative-MAC tier (sim.init enforces it): the fast
group's exact K x N subcycle rows go through the existing
parallel.sharded.make_sharded_force_rows.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import tree as T
from ..units import G_INTERNAL


def tree_acc_jerk_pot_mesh(
    pos: jax.Array,
    vel: jax.Array | None,
    mass: jax.Array,
    mesh: Mesh,
    eps2: float | jax.Array = 0.0,
    g: float = G_INTERNAL,
    *,
    leaf: int = 256,
    theta: float = 0.5,
    kavg: int = 256,
    pot_eps2: float | None = None,
    aref: jax.Array | None = None,
    with_jerk: bool = False,
):
    """(acc [N,3], jerk [N,3] | None, pot [N], overflow) — the mesh
    analogue of ops.tree.tree_acc_jerk_pot. Requires the block count
    B = 2^ceil(log2(N/leaf)) to be divisible by the mesh size (pick
    `leaf` accordingly; init-time configs at production N satisfy it
    automatically — B >= 256 vs meshes of 4-64 chips)."""
    T._check_theta(theta, aref)   # same geometric-MAC guard as single-chip
    axis = mesh.axis_names[0]
    d = mesh.shape[axis]
    n = pos.shape[0]

    # replicated tree build + MAC (identical on every chip)
    tree = T.build_block_tree(pos, mass, leaf, vel if with_jerk else None)
    b, L, _ = tree.pos_s.shape
    if b % d:
        raise ValueError(
            f"tree mesh path needs the block count ({b}) divisible by "
            f"the mesh size ({d}); lower tree_leaf"
        )
    aref_b = T.aref_block_min(tree, aref, n) if aref is not None else None
    accepts, p2p = T.mac_masks(tree, theta, g, aref_b)

    m_all = jnp.concatenate(tree.masses)
    com_all = jnp.concatenate(tree.coms, axis=0)
    mask_all = jnp.concatenate(accepts, axis=1)
    w_all = jnp.where(mask_all, m_all[None, :], 0.0)
    vcom_all = (jnp.concatenate(tree.vcoms, axis=0) if with_jerk else None)
    vel_s = tree.vel_s if with_jerk else jnp.zeros_like(tree.pos_s)

    # ---- far field: target blocks sharded, nodes replicated ----------
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis)),
        check_vma=False,  # closed-over replicated tree arrays (the
        #   sharded backend sets the same flag for its pallas outputs)
    )
    def far(pos_rows, vel_rows, w_rows):
        acc, jerk, pot = T._far_field_rows(
            pos_rows, vel_rows if with_jerk else None, w_rows,
            com_all, vcom_all, eps2, g, pot_eps2, with_jerk=with_jerk,
        )
        if jerk is None:
            jerk = jnp.zeros_like(acc)
        return acc, jerk, pot

    far_acc, far_jerk, far_pot = far(tree.pos_s, vel_s, w_all)

    # ---- near field: pair list sharded, accumulators psum'd ----------
    chunk = min(8, b * b)
    ti, sj, ok, overflow = T.pack_pair_list(p2p, kavg, chunk)
    n_chunks = ti.shape[0] // chunk
    # pad the chunk axis to a multiple of the mesh size with masked pairs
    n_pad = -(-n_chunks // d) * d
    extra = n_pad * chunk - ti.shape[0]
    if extra:
        ti = jnp.concatenate([ti, jnp.zeros(extra, jnp.int32)])
        sj = jnp.concatenate([sj, jnp.zeros(extra, jnp.int32)])
        ok = jnp.concatenate([ok, jnp.zeros(extra, bool)])
    ti, sj, ok = (a.reshape(n_pad, chunk) for a in (ti, sj, ok))

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=(P(), P(), P()),
        check_vma=False,  # the scatter-scan carry starts replicated and
        #   becomes device-varying on the first chunk (scan-vma rule)
    )
    def near(ti_l, sj_l, ok_l):
        acc, jerk, pot = T._p2p_scan(
            tree.pos_s, tree.vel_s, tree.mass_s, tree.gidx_s,
            ti_l, sj_l, ok_l, eps2, g, pot_eps2, with_jerk,
        )
        if jerk is None:
            jerk = jnp.zeros(())
        return (jax.lax.psum(acc, axis), jax.lax.psum(jerk, axis),
                jax.lax.psum(pot, axis))

    near_acc, near_jerk, near_pot = near(ti, sj, ok)

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


def make_tree_mesh_sweep(mass, mesh, eps2, *, leaf: int, theta: float,
                         kavg: int, pot_eps2: float | None,
                         g: float = G_INTERNAL, with_jerk: bool = False,
                         aref: jax.Array | None = None):
    """Full-sweep `(pos, vel) -> (acc, jerk, pot)` for sim.step under a
    mesh — the mesh analogue of ops.tree.make_tree_sweep (same NaN
    poison-on-overflow contract)."""

    def sweep(pos, vel=None):
        acc, jerk, pot, ovf = tree_acc_jerk_pot_mesh(
            pos, vel, mass, mesh, eps2, g, leaf=leaf, theta=theta,
            kavg=kavg, pot_eps2=pot_eps2, aref=aref, with_jerk=with_jerk,
        )
        poison = jnp.where(ovf, jnp.nan, 0.0).astype(acc.dtype)
        if jerk is None:
            jerk = jnp.zeros_like(acc)
        else:
            jerk = jerk + poison
        return acc + poison, jerk, pot + poison

    return sweep
