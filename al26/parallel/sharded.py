"""Multi-chip scaling: row-block sharding of the O(N^2) interaction matrix.

The reference's only intra-solver parallelism is `number_of_workers=8` MPI
worker processes inside the AMUSE gravity code (al26_nbody.py:57,1711-1720).
The accelerator equivalent (SURVEY.md §2c item 1, §5 communication): each
device owns a row block of the particle set; positions are all-gathered
over the interconnect (a few MB even at N=1e5 — bandwidth-trivial next to
the O(N^2/D) compute) and every device evaluates forces for its rows
against all columns.
The per-row reduction is local, so no psum is needed for the forces; scalar
diagnostics (potential energy -> virial radius) reduce with a single psum.

Everything is expressed with `jax.shard_map` over a 1-D device mesh (the
GPUs of a host reach each other all to all, so the mesh follows the
algorithm); the same code runs on real devices and on the fake 8-device
CPU backend the tests use.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import backend
from ..units import G_INTERNAL

ROW_AXIS = "rows"


def make_mesh(n_devices: int | None = None, axis: str = ROW_AXIS) -> Mesh:
    """1-D device mesh over the first `n_devices` local devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    import numpy as np

    return Mesh(np.array(devs), (axis,))


def pad_to_multiple(n: int, d: int) -> int:
    return -(-n // d) * d


def _local_rows_force(pos_l, vel_l, mass_l, eps2, g, axis,
                      use_pallas: bool | None = None,
                      with_jerk: bool = True,
                      pot_eps2: float | None = None):
    """Per-shard body: gather all columns, compute this shard's row block.

    Where ops.backend.kernel_here says so (GPU, f32, enough columns), the
    row sweep runs through the Pallas row-block kernel
    (ops.pallas_nbody.pallas_acc_jerk_pot_rows) — the same kernel as the
    single-device path. `use_pallas=True` forces it (the interpreter on a
    CPU test process).
    `pot_eps2` separates the potential softening from the force softening
    so ONE sweep serves both the integrator and the virial radius
    (al26_nbody.py:767-770; same convention as the Pallas kernel)."""
    pos = jax.lax.all_gather(pos_l, axis, tiled=True)
    vel = jax.lax.all_gather(vel_l, axis, tiled=True)
    mass = jax.lax.all_gather(mass_l, axis, tiled=True)
    block = pos_l.shape[0]
    start = jax.lax.axis_index(axis) * block
    if use_pallas is None:
        use_pallas = backend.kernel_here(pos.shape[0], pos.dtype)
    rows = (start + jnp.arange(block)).astype(jnp.int32)
    if use_pallas:
        from ..ops.pallas_nbody import pallas_acc_jerk_pot_rows

        return pallas_acc_jerk_pot_rows(
            pos_l, vel_l, rows, pos, vel, mass, eps2=float(eps2), g=g,
            interpret=backend.kernel_interpret(), with_jerk=with_jerk,
            pot_eps2=pot_eps2,
        )
    from ..ops.nbody import _row_block_acc_jerk_pot

    return _row_block_acc_jerk_pot(pos_l, vel_l, pos, vel, mass, eps2, g,
                                   rows, pot_eps2=pot_eps2,
                                   with_jerk=with_jerk)


def make_sharded_force(
    mesh: Mesh,
    mass: jax.Array,
    eps2: float | jax.Array = 0.0,
    g: float = G_INTERNAL,
    axis: str = ROW_AXIS,
):
    """Build `force_fn(pos, vel) -> (acc, jerk)` that row-shards the pairwise
    sweep over `mesh`. Requires N % n_devices == 0 (pad with zero-mass stars
    otherwise). Inputs may be replicated or sharded; outputs follow in_specs."""

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis)),
        check_vma=False,  # pallas_call outputs carry no vma annotation
    )
    def _force(pos_l, vel_l, mass_l):
        a, j, _ = _local_rows_force(pos_l, vel_l, mass_l, eps2, g, axis)
        return a, j

    def force_fn(pos, vel):
        return _force(pos, vel, mass)

    return force_fn


def sharded_acc_jerk_pot(
    pos: jax.Array,
    vel: jax.Array,
    mass: jax.Array,
    mesh: Mesh,
    eps2: float | jax.Array = 0.0,
    g: float = G_INTERNAL,
    axis: str = ROW_AXIS,
    pot_eps2: float | None = None,
    with_jerk: bool = True,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Row-sharded (acc, jerk, pot) over the mesh. With `pot_eps2` set,
    the returned potential is softened separately from the forces, so the
    mesh step needs no second O(N^2/D) sweep for the virial radius
    (sim/step.py round-3 fusion; previously sharded_potential_energy ran
    as an extra full pass every step)."""

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis)),
        check_vma=False,  # pallas_call outputs carry no vma annotation
    )
    def _f(pos_l, vel_l, mass_l):
        return _local_rows_force(pos_l, vel_l, mass_l, eps2, g, axis,
                                 with_jerk=with_jerk, pot_eps2=pot_eps2)

    return _f(pos, vel, mass)


def make_sharded_force_rows(
    mesh: Mesh,
    mass: jax.Array,
    eps2: float | jax.Array = 0.0,
    g: float = G_INTERNAL,
    axis: str = ROW_AXIS,
):
    """`force_rows_fn(pos_rows, vel_rows, row_ids, pos_all, vel_all) ->
    (acc, jerk)` for the block-timestep Hermite subcycle under a mesh
    (ops.integrators.hermite4_block_advance): the K fast rows are
    REPLICATED, the N source columns are row-sharded, each device sums its
    K x N/D partial forces and a psum completes the reduction — O(K*N/D)
    pair work per chip per substep, the sharded analogue of the Pallas row
    kernel. Self pairs are masked by global column index."""

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(None), P(None), P(None), P(axis), P(axis), P(axis)),
        out_specs=(P(None), P(None)),
    )
    def _rows(pr, vr, ids, pos_l, vel_l, mass_l):
        from ..ops.nbody import _row_block_acc_jerk_pot

        block = pos_l.shape[0]
        start = jax.lax.axis_index(axis) * block
        a, j, _ = _row_block_acc_jerk_pot(
            pr, vr, pos_l, vel_l, mass_l, eps2, g, ids,
            col_offset=start, with_pot=False,  # discarded every substep
        )
        return (jax.lax.psum(a, axis), jax.lax.psum(j, axis))

    def force_rows_fn(pr, vr, ids, p_all, v_all):
        return _rows(pr, vr, ids, p_all, v_all, mass)

    return force_rows_fn


def sharded_potential_energy(pos, mass, mesh, eps2=0.0, g=G_INTERNAL,
                             axis: str = ROW_AXIS):
    """Total potential energy with a single psum over the mesh."""

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=P(),
    )
    def _u(pos_l, mass_l):
        zeros = jnp.zeros_like(pos_l)
        _, _, pot_l = _local_rows_force(pos_l, zeros, mass_l, eps2, g, axis,
                                        with_jerk=False)
        return jax.lax.psum(0.5 * jnp.sum(mass_l * pot_l), axis)

    return _u(pos, mass)


def shard_state_rows(state, mesh: Mesh, axis: str = ROW_AXIS):
    """Place every per-star array of a SimState/Cluster pytree with its
    leading (star) axis sharded across the mesh; scalars replicated."""

    def place(x):
        if getattr(x, "ndim", 0) >= 1:
            spec = P(axis, *([None] * (x.ndim - 1)))
        else:
            spec = P()
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(place, state)
