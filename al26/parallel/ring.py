"""Ring-streamed pairwise forces: the ppermute dataflow.

The all-gather path (parallel.sharded) replicates every chip's positions
before the row sweep — fine to N ~ 1e5, but the gathered column set grows
with N while each chip's row block shrinks. This module streams the
COLUMN blocks around the ICI ring instead (exactly the ring-attention
dataflow, SURVEY.md §5 long-context analogue): each chip keeps its row
block resident, computes partial forces against the circulating column
block, and `ppermute`s the block to its neighbour — D steps, peak memory
O(N/D) per chip, bandwidth identical to the all-gather in total but
pipelined with compute by XLA.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.backend import einsum
from ..units import G_INTERNAL

RING_AXIS = "rows"


def _partial_block_force(pos_r, vel_r, row_ids, pos_c, vel_c, mass_c,
                         col_ids, eps2, g, pot_eps2=None, with_jerk=True):
    """acc/jerk/pot contribution of one column block onto the row block.
    Self pairs masked by global id equality. `pot_eps2` softens the
    potential separately from the forces (same convention as
    parallel.sharded / the Pallas kernel) so one ring pass serves both
    the integrator and the virial radius."""
    dx = pos_c[None, :, :] - pos_r[:, None, :]
    dv = vel_c[None, :, :] - vel_r[:, None, :]
    r2 = jnp.sum(dx * dx, axis=-1) + eps2
    inv_r = jax.lax.rsqrt(r2)
    self_mask = col_ids[None, :] == row_ids[:, None]
    inv_r = jnp.where(self_mask, 0.0, inv_r)
    inv_r3 = inv_r * inv_r * inv_r
    mj3 = mass_c[None, :] * inv_r3
    acc = g * einsum("ij,ijk->ik", mj3, dx)
    if with_jerk:
        r2_safe = jnp.where(self_mask, 1.0, r2)
        xv = jnp.sum(dx * dv, axis=-1)
        jerk = g * (
            einsum("ij,ijk->ik", mj3, dv)
            - 3.0 * einsum("ij,ijk->ik", mj3 * xv / r2_safe, dx)
        )
    else:
        jerk = jnp.zeros_like(acc)
    if pot_eps2 is None:
        inv_rp = inv_r
    else:
        r2p = r2 - eps2 + pot_eps2
        inv_rp = jnp.where(self_mask, 0.0, jax.lax.rsqrt(r2p))
    pot = -g * jnp.sum(mass_c[None, :] * inv_rp, axis=1)
    return acc, jerk, pot


def ring_acc_jerk_pot(
    pos: jax.Array,
    vel: jax.Array,
    mass: jax.Array,
    mesh: Mesh,
    eps2: float | jax.Array = 0.0,
    g: float = G_INTERNAL,
    axis: str = RING_AXIS,
    pot_eps2: float | None = None,
    with_jerk: bool = True,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Row-sharded (acc, jerk, pot) with ring-streamed columns. Matches
    parallel.sharded.sharded_acc_jerk_pot bit-for-bit up to summation
    order; requires N % n_devices == 0."""

    # the RING axis size, not the total device count — on a multi-axis
    # mesh (e.g. ensemble x rows) the permutation and col_ids must follow
    # the named axis only
    n_dev = mesh.shape[axis]
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis)),
    )
    def _f(pos_l, vel_l, mass_l):
        block = pos_l.shape[0]
        me = jax.lax.axis_index(axis)
        row_ids = me * block + jnp.arange(block)

        def body(step, carry):
            acc, jerk, pot, pc, vc, mc = carry
            # the circulating block started at chip (me - step) % n_dev
            src = jnp.mod(me - step, n_dev)
            col_ids = src * block + jnp.arange(block)
            a, j, p = _partial_block_force(
                pos_l, vel_l, row_ids, pc, vc, mc, col_ids, eps2, g,
                pot_eps2=pot_eps2, with_jerk=with_jerk,
            )
            # rotate the column block one hop around the ring
            pc = jax.lax.ppermute(pc, axis, perm)
            vc = jax.lax.ppermute(vc, axis, perm)
            mc = jax.lax.ppermute(mc, axis, perm)
            return acc + a, jerk + j, pot + p, pc, vc, mc

        zeros3 = jnp.zeros_like(pos_l)
        zeros1 = jnp.zeros_like(mass_l)
        acc, jerk, pot, _, _, _ = jax.lax.fori_loop(
            0, n_dev, body,
            (zeros3, zeros3, zeros1, pos_l, vel_l, mass_l),
        )
        return acc, jerk, pot

    return _f(pos, vel, mass)


def make_ring_force(mesh: Mesh, mass: jax.Array,
                    eps2: float | jax.Array = 0.0, g: float = G_INTERNAL,
                    axis: str = RING_AXIS):
    """`force_fn(pos, vel) -> (acc, jerk)` using the ring dataflow."""

    def force_fn(pos, vel):
        a, j, _ = ring_acc_jerk_pot(pos, vel, mass, mesh, eps2, g, axis)
        return a, j

    return force_fn
