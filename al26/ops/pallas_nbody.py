"""Pallas kernel (Triton route, NVIDIA GPU): tiled O(N^2) force / jerk /
potential.

This is the hot-path replacement for the reference's out-of-process C++
gravity workers (BHTree/Hermite/ph4, al26_nbody.py:1709-1722), written as
the classic shared-memory all-pairs sweep (Nyland, Harris & Prins, GPU
Gems 3 ch. 31):

  * the grid is (row blocks, column splits). Each program owns BLOCK_I
    target rows and loops (fori_loop, dynamic bounds) over its range of
    BLOCK_J column tiles. Columns are read as 1-D SoA slices (x, y, z, vx,
    vy, vz, m); Triton stages them through shared memory (num_stages)
    while the accumulators stay in registers as [BLOCK_I, BLOCK_J] tiles
    (element-wise FMAs; the row sums are taken once, after the loop);
  * the column split is the second grid axis: when the row blocks alone
    cannot fill the card (the hermite4_block subcycle's 64-512 rows), the
    column range is cut into S pieces whose partial sums [S, 7, B] are
    added in XLA afterwards, in a fixed order (no atomics, so results do
    not change from run to run);
  * self pairs (row id against column index), padding columns (col >= n)
    and, for flattened ensembles, pairs across groups are masked exactly,
    so results match the dense reference to f32 round-off
    (tests/test_pallas.py); the group column window is derived from each
    row block's ids, so a B-realization ensemble costs O(B N^2) pairs.

There is no matrix product in the pair work, so no tensor-core or TF32
path is involved: every sum is an f32 FMA chain.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..units import G_INTERNAL


class Tiles(NamedTuple):
    """One kernel configuration. The column range is split until
    row blocks x splits reaches `min_programs` (or each split holds one
    tile)."""
    block_i: int
    block_j: int
    num_warps: int
    num_stages: int
    min_programs: int


# the fastest configuration of each call shape, measured on an H100 80GB HBM3
# (scripts/tune_kernel.py; PERF.md "Findings"): "full" at N=131072 (the
# whole sweep, 38.4 ms), "rows" at 512 scattered rows x N=102400 (the
# hermite4_block subcycle, 0.34 ms), "group" at 64 x 1024 (the flattened
# ensemble, 0.41 ms). Tiles above 1024 elements ran 15-45% slower.
# Read when a call is traced: to try another entry, swap it and clear
# JAX's caches (jax.clear_caches), as scripts/tune_kernel.py does.
TILES = {
    "full": Tiles(16, 64, 4, 2, 528),
    "rows": Tiles(16, 64, 4, 2, 528),
    "group": Tiles(16, 32, 2, 2, 264),
}


def call_kind(b: int, n: int, group_size: int) -> str:
    """Which TILES entry a call of b rows over n columns uses (also the
    kernel's name in profiles: nbody_full / nbody_rows / nbody_group)."""
    if group_size > 0:
        return "group"
    return "rows" if b < n else "full"


def _cdiv(a, b):
    return -(-a // b)


def _sweep_kernel(rows_ref, ids_ref, bounds_ref, cols_ref, out_ref, *,
                  n: int, eps2: float, pot_eps2: float | None, g: float,
                  with_jerk: bool, group_size: int, block_i: int,
                  block_j: int, n_split: int):
    """rows_ref [6, Bp] (x, y, z, vx, vy, vz of the targets), ids_ref [Bp]
    int32 (global column index of each row, -1 = padding), bounds_ref
    [2, nb * S] int32 (column-tile range of program (i, s)), cols_ref
    [7, Np] (x, y, z, vx, vy, vz, m of the sources), out_ref [S, 7, Bp]
    (acc xyz, pot, jerk xyz; [S, 4, Bp] without jerk): the partial sums of
    each column split."""
    i = pl.program_id(0)
    s = pl.program_id(1)
    rs = pl.ds(i * block_i, block_i)
    xi = plgpu.load(rows_ref.at[0, rs])[:, None]
    yi = plgpu.load(rows_ref.at[1, rs])[:, None]
    zi = plgpu.load(rows_ref.at[2, rs])[:, None]
    vxi = plgpu.load(rows_ref.at[3, rs])[:, None]
    vyi = plgpu.load(rows_ref.at[4, rs])[:, None]
    vzi = plgpu.load(rows_ref.at[5, rs])[:, None]
    ids = plgpu.load(ids_ref.at[rs])[:, None]
    k = i * n_split + s
    t_lo = bounds_ref[0, k]
    t_hi = bounds_ref[1, k]

    def body(t, acc):
        j0 = t * block_j
        cs = pl.ds(j0, block_j)
        xj = plgpu.load(cols_ref.at[0, cs])[None, :]
        yj = plgpu.load(cols_ref.at[1, cs])[None, :]
        zj = plgpu.load(cols_ref.at[2, cs])[None, :]
        mj = plgpu.load(cols_ref.at[6, cs])[None, :]
        dx = xj - xi                                  # [block_i, block_j]
        dy = yj - yi
        dz = zj - zi
        d2 = dx * dx + dy * dy + dz * dz
        cid = j0 + jax.lax.broadcasted_iota(jnp.int32, (1, block_j), 1)
        valid = (cid != ids) & (cid < n)
        if group_size > 0:
            # ids >= -1 and cid >= 0: truncating division is the floor
            # except for padding rows, whose outputs are discarded
            valid &= (jax.lax.div(cid, jnp.int32(group_size))
                      == jax.lax.div(ids, jnp.int32(group_size)))
        inv_r = jnp.where(valid, jax.lax.rsqrt(d2 + eps2), 0.0)
        inv_r2 = inv_r * inv_r
        w = mj * (inv_r * inv_r2)                     # m_j / r^3, masked
        if pot_eps2 is not None:
            # separately softened potential (1e-30 ~ unsoftened): one sweep
            # gives the BHTree-softened forces AND the raw potential the
            # virial radius needs (al26_nbody.py:770)
            inv_r = jnp.where(valid, jax.lax.rsqrt(d2 + pot_eps2), 0.0)
        # element-wise accumulation: the row sums are taken once, after
        # the loop, instead of a cross-thread reduction per tile
        new = [acc[0] + w * dx, acc[1] + w * dy, acc[2] + w * dz,
               acc[3] - mj * inv_r]
        if with_jerk:
            dvx = plgpu.load(cols_ref.at[3, cs])[None, :] - vxi
            dvy = plgpu.load(cols_ref.at[4, cs])[None, :] - vyi
            dvz = plgpu.load(cols_ref.at[5, cs])[None, :] - vzi
            sr = 3.0 * (dx * dvx + dy * dvy + dz * dvz) * inv_r2
            new += [acc[4] + w * (dvx - sr * dx),
                    acc[5] + w * (dvy - sr * dy),
                    acc[6] + w * (dvz - sr * dz)]
        return tuple(new)

    n_acc = 7 if with_jerk else 4
    zeros = jnp.zeros((block_i, block_j), jnp.float32)
    acc = jax.lax.fori_loop(t_lo, t_hi, body, (zeros,) * n_acc)
    sums = [jnp.sum(a, axis=1) for a in acc]
    # output rows: acc x, y, z, pot, jerk x, y, z
    for c, v in enumerate(sums):
        # int32 indices throughout: under x64 a Python int would index as
        # int64 beside the int32 program ids
        plgpu.store(out_ref.at[s, jnp.int32(c), rs], g * v)


def _tile_bounds(ids_p, nb: int, nt: int, n_split: int, group_size: int,
                 block_i: int, block_j: int) -> jax.Array:
    """[2, nb * n_split] int32 column-tile range of each program: the whole
    column range, or each row block's group window, cut into n_split
    contiguous pieces."""
    if group_size > 0:
        blk = ids_p.reshape(nb, block_i)
        big = jnp.int32(2**30)
        id_min = jnp.min(jnp.where(blk >= 0, blk, big), axis=1)
        id_max = jnp.max(blk, axis=1)   # padding rows are -1, never the max
        # all-padding block: id_min=big, id_max=-1 -> lo >= hi -> no work
        lo = jnp.minimum((id_min // group_size) * group_size // block_j, nt)
        hi = jnp.minimum(_cdiv((id_max // group_size + 1) * group_size,
                               block_j), nt)
        lo = jnp.minimum(lo, hi)
    else:
        lo = jnp.zeros((nb,), jnp.int32)
        hi = jnp.full((nb,), nt, jnp.int32)
    per = _cdiv(hi - lo, n_split)
    s = jnp.arange(n_split, dtype=jnp.int32)[None, :]
    s_lo = jnp.minimum(lo[:, None] + s * per[:, None], hi[:, None])
    s_hi = jnp.minimum(s_lo + per[:, None], hi[:, None])
    return jnp.stack([s_lo.reshape(-1), s_hi.reshape(-1)]).astype(jnp.int32)


@functools.partial(jax.jit,
                   static_argnames=("eps2", "g", "interpret", "with_jerk",
                                    "group_size", "pot_eps2"))
def pallas_acc_jerk_pot_rows(
    pos_rows: jax.Array,   # [B,3]  target rows (a subset of the columns)
    vel_rows: jax.Array,   # [B,3]
    row_ids: jax.Array,    # [B] int32: global column index of each row
    #                        (any order/subset; -1 = padding row)
    pos: jax.Array,        # [N,3]  ALL source columns
    vel: jax.Array,        # [N,3]
    mass: jax.Array,       # [N]
    eps2: float = 0.0,
    g: float = G_INTERNAL,
    interpret: bool = False,
    with_jerk: bool = True,
    group_size: int = 0,
    pot_eps2: float | None = None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Forces on `pos_rows` from all of `pos`: (acc [B,3], jerk [B,3],
    pot [B]), computed in f32 and returned in the rows' dtype.

    `with_jerk=False` skips the jerk accumulation (~40% of the pair work;
    jerk comes back zero). `pot_eps2` softens the potential separately
    from the forces (1e-30 ~ unsoftened), so one sweep serves both the
    integrator and the virial radius. `group_size > 0` restricts pairs to
    the same group (global_index // group_size): a flattened ensemble of
    B realizations runs as ONE block-diagonal sweep; the TILES entry is
    chosen by call_kind. `interpret=True` runs the Pallas interpreter (CPU
    tests only; callers take it from ops.backend.kernel_interpret).

    Used by the single-cluster sweep, the hermite4_block subcycle (a
    scattered row subset), each shard of the row-sharded mesh sweep
    (parallel.sharded) and the flattened ensembles (parallel.ensemble)."""
    b = pos_rows.shape[0]
    n = pos.shape[0]
    kind = call_kind(b, n, group_size)
    t = TILES[kind]
    bp = _cdiv(b, t.block_i) * t.block_i
    np_ = _cdiv(n, t.block_j) * t.block_j
    nb = bp // t.block_i
    nt = np_ // t.block_j
    n_split = max(1, min(_cdiv(t.min_programs, nb), nt))

    f32 = jnp.float32
    rows = jnp.pad(jnp.concatenate([pos_rows, vel_rows], axis=1).astype(f32),
                   ((0, bp - b), (0, 0))).T                    # [6, Bp]
    ids = jnp.pad(row_ids.astype(jnp.int32), (0, bp - b), constant_values=-1)
    cols = jnp.pad(
        jnp.concatenate([pos, vel, mass[:, None]], axis=1).astype(f32),
        ((0, np_ - n), (0, 0))).T                              # [7, Np]
    bounds = _tile_bounds(ids, nb, nt, n_split, group_size, t.block_i,
                          t.block_j)
    kernel = functools.partial(
        _sweep_kernel, n=n, eps2=float(eps2),
        pot_eps2=None if pot_eps2 is None else float(pot_eps2), g=float(g),
        with_jerk=with_jerk, group_size=group_size, block_i=t.block_i,
        block_j=t.block_j, n_split=n_split,
    )
    part = pl.pallas_call(
        kernel,
        grid=(nb, n_split),
        out_shape=jax.ShapeDtypeStruct((n_split, 7 if with_jerk else 4, bp),
                                       f32),
        compiler_params=plgpu.CompilerParams(num_warps=t.num_warps,
                                             num_stages=t.num_stages),
        interpret=interpret,
        name="nbody_" + kind,
    )(rows, ids, bounds, cols)
    if not with_jerk:
        part = jnp.concatenate(
            [part, jnp.zeros((n_split, 3, bp), f32)], axis=1)
    tot = part[0]
    for k in range(1, n_split):   # fixed order: deterministic partial sums
        tot = tot + part[k]
    dtype = pos_rows.dtype
    return (tot[0:3, :b].T.astype(dtype), tot[4:7, :b].T.astype(dtype),
            tot[3, :b].astype(dtype))


def pallas_acc_jerk_pot(
    pos: jax.Array,
    vel: jax.Array,
    mass: jax.Array,
    eps2: float = 0.0,
    g: float = G_INTERNAL,
    interpret: bool = False,
    with_jerk: bool = True,
    group_size: int = 0,
    pot_eps2: float | None = None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """(acc [N,3], jerk [N,3], pot [N]): the full sweep, every star a row
    (see pallas_acc_jerk_pot_rows)."""
    return pallas_acc_jerk_pot_rows(
        pos, vel, jnp.arange(pos.shape[0], dtype=jnp.int32), pos, vel, mass,
        eps2=float(eps2), g=g, interpret=interpret, with_jerk=with_jerk,
        group_size=group_size, pot_eps2=pot_eps2,
    )


def make_pallas_force(mass: jax.Array, eps2: float, interpret: bool,
                      g: float = G_INTERNAL):
    """`force_fn(pos, vel) -> (acc, jerk)` (ops.integrators hook)."""

    def force_fn(pos, vel):
        a, j, _ = pallas_acc_jerk_pot(pos, vel, mass, eps2, g,
                                      interpret=interpret)
        return a, j

    return force_fn


def make_pallas_acc(mass: jax.Array, eps2: float, interpret: bool,
                    g: float = G_INTERNAL):
    """`acc_fn(pos) -> acc` (acceleration only) for the leapfrog path."""

    def acc_fn(pos):
        a, _, _ = pallas_acc_jerk_pot(pos, jnp.zeros_like(pos), mass, eps2,
                                      g, interpret=interpret,
                                      with_jerk=False)
        return a

    return acc_fn


def make_pallas_force_rows(mass: jax.Array, eps2: float, interpret: bool,
                           g: float = G_INTERNAL, group_size: int = 0):
    """`force_rows_fn(pos_rows, vel_rows, row_ids, pos_all, vel_all) ->
    (acc, jerk)` for the block-timestep fast-group subcycle."""

    def force_rows_fn(pr, vr, ids, p_all, v_all):
        a, j, _ = pallas_acc_jerk_pot_rows(
            pr, vr, ids, p_all, v_all, mass, eps2=float(eps2), g=g,
            interpret=interpret, group_size=group_size,
        )
        return a, j

    return force_rows_fn
