"""Pallas force-kernel tests. On the CPU the kernel runs in the Pallas
interpreter (interpret=True) and is cross-lowered to Triton IR for CUDA;
the `gpu`-marked tests compile and run it on the card (chip_smoke.py
runs them there)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from al26.ops import backend
from al26.ops.nbody import acc_jerk_pot_dense
from al26.ops.pallas_nbody import (
    TILES, Tiles, call_kind, pallas_acc_jerk_pot, pallas_acc_jerk_pot_rows,
)

kern = functools.partial(pallas_acc_jerk_pot, interpret=True)
kern_rows = functools.partial(pallas_acc_jerk_pot_rows, interpret=True)
# small tiles keep interpret-mode sweeps cheap and put several row blocks,
# column tiles and splits into test-sized systems
SMALL = Tiles(16, 32, 4, 2, 8)


@pytest.fixture
def set_tiles(monkeypatch):
    """`set_tiles(kind, t)`: use tiles `t` for the call shape `kind` in
    this test. TILES is read at trace time, so JAX's caches are cleared
    after the swap and again before monkeypatch restores the table."""
    def swap(kind, t):
        monkeypatch.setitem(TILES, kind, t)
        jax.clear_caches()

    yield swap
    jax.clear_caches()


def _system(n, seed=0):
    rng = np.random.default_rng(seed)
    return (
        jnp.asarray(rng.normal(size=(n, 3)), jnp.float32),
        jnp.asarray(rng.normal(size=(n, 3)), jnp.float32),
        jnp.asarray(rng.uniform(0.1, 2.0, n), jnp.float32),
    )


def _dense64(pos, vel, mass, eps2):
    f64 = jnp.float64
    return acc_jerk_pot_dense(pos.astype(f64), vel.astype(f64),
                              mass.astype(f64), eps2)


def _scaled(x, ref):
    return float(jnp.max(jnp.abs(x - ref)) / jnp.max(jnp.abs(ref)))


@pytest.mark.parametrize("n", [32, 64, 100, 777])
@pytest.mark.parametrize("offset", [0.0, 4.0])
def test_pallas_matches_dense(set_tiles, n, offset):
    """Full sweep against the f64 dense reference, for power-of-two and
    ragged N (padding rows and columns); the offset cluster checks that
    nothing depends on the origin."""
    set_tiles("full", SMALL)
    pos, vel, mass = _system(n)
    pos = pos + offset
    a1, j1, p1 = kern(pos, vel, mass, 1e-3)
    a2, j2, p2 = _dense64(pos, vel, mass, 1e-3)
    assert _scaled(a1, a2) < 1e-5
    assert _scaled(j1, j2) < 1e-5
    assert _scaled(p1, p2) < 1e-5


@pytest.mark.parametrize("kind", sorted(TILES))
def test_pallas_table_tiles_match_dense(kind):
    """Every configuration in the tile table computes the same forces,
    each reached through the call shape that selects it."""
    gs = 150
    pos, vel, mass = _system(2 * gs, seed=2)
    if kind == "group":
        a1, j1, p1 = kern(pos, vel, mass, 0.125, group_size=gs)
        parts = [_dense64(pos[k * gs:(k + 1) * gs], vel[k * gs:(k + 1) * gs],
                          mass[k * gs:(k + 1) * gs], 0.125) for k in (0, 1)]
        a2, j2, p2 = (jnp.concatenate([p[i] for p in parts])
                      for i in range(3))
    else:
        ids = jnp.arange(2 * gs, dtype=jnp.int32)
        if kind == "rows":
            ids = ids[::3]
        assert call_kind(ids.shape[0], 2 * gs, 0) == kind
        a1, j1, p1 = kern_rows(pos[ids], vel[ids], ids, pos, vel, mass,
                               eps2=0.125)
        a2, j2, p2 = (x[ids] for x in _dense64(pos, vel, mass, 0.125))
    assert _scaled(a1, a2) < 1e-5
    assert _scaled(j1, j2) < 1e-5
    assert _scaled(p1, p2) < 1e-5


@pytest.mark.parametrize("min_programs", [1, 4, 64, 10_000])
def test_pallas_column_split_partial_sums(set_tiles, min_programs):
    """The column split (second grid axis, partial sums added in XLA)
    gives the same rows whatever the number of splits, up to and past
    one column tile per split."""
    set_tiles("rows", Tiles(8, 16, 4, 2, min_programs))
    pos, vel, mass = _system(333, seed=5)
    ids = jnp.asarray([3, 17, 300, 150, 42, 0, 332, 99], jnp.int32)
    a, j, p = kern_rows(pos[ids], vel[ids], ids, pos, vel, mass, eps2=1e-3)
    a2, j2, p2 = _dense64(pos, vel, mass, 1e-3)
    assert _scaled(a, a2[ids]) < 1e-5
    assert _scaled(j, j2[ids]) < 1e-5
    assert _scaled(p, p2[ids]) < 1e-5


def test_pallas_without_jerk(set_tiles):
    set_tiles("full", SMALL)
    pos, vel, mass = _system(200, seed=6)
    a1, j1, p1 = kern(pos, vel, mass, 1e-2, with_jerk=False)
    a2, _, p2 = _dense64(pos, vel, mass, 1e-2)
    assert _scaled(a1, a2) < 1e-5
    assert _scaled(p1, p2) < 1e-5
    assert float(jnp.max(jnp.abs(j1))) == 0.0


def test_pallas_unsoftened_masks_self():
    pos, vel, mass = _system(64, seed=3)
    a1, j1, p1 = kern(pos, vel, mass, 0.0)
    assert np.isfinite(np.asarray(a1)).all()
    assert np.isfinite(np.asarray(j1)).all()
    assert np.isfinite(np.asarray(p1)).all()


def test_pallas_force_fn_in_integrator():
    from al26.ops.integrators import hermite4_advance
    from al26.ops.pallas_nbody import make_pallas_force

    pos, vel, mass = _system(128, seed=4)
    pos64 = pos.astype(jnp.float64)
    vel64 = vel.astype(jnp.float64)
    mass64 = mass.astype(jnp.float64)
    p_ref, v_ref = hermite4_advance(pos64, vel64, mass64,
                                    jnp.asarray(0.001), eps2=1e-2)
    ff = make_pallas_force(mass, 1e-2, interpret=True)
    p_pal, v_pal = hermite4_advance(pos, vel, mass, jnp.asarray(0.001,
                                    jnp.float32), eps2=1e-2, force_fn=ff)
    np.testing.assert_allclose(np.asarray(p_pal), np.asarray(p_ref),
                               rtol=1e-4, atol=1e-6)


def test_pallas_rows_variant_matches_full():
    """The row-block kernel (multi-device per-shard path) equals the full
    kernel's corresponding rows for any offset."""
    pos, vel, mass = _system(512, seed=7)
    a_full, j_full, p_full = kern(pos, vel, mass, 1e-3)
    for start, width in [(0, 128), (128, 256), (384, 128)]:
        a, j, p = kern_rows(
            pos[start:start + width], vel[start:start + width],
            jnp.arange(start, start + width, dtype=jnp.int32),
            pos, vel, mass, eps2=1e-3)
        np.testing.assert_allclose(np.asarray(a),
                                   np.asarray(a_full[start:start + width]),
                                   rtol=2e-5, atol=1e-8)
        np.testing.assert_allclose(np.asarray(p),
                                   np.asarray(p_full[start:start + width]),
                                   rtol=2e-5, atol=1e-8)


def test_sharded_force_pallas_path_matches():
    """shard_map + pallas row kernel (forced on, interpret mode) equals the
    jnp sharded result on the fake 8-device mesh."""
    from jax.sharding import PartitionSpec as P

    from al26.parallel.sharded import _local_rows_force, make_mesh

    rng = np.random.default_rng(3)
    n = 256
    pos = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    vel = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    mass = jnp.asarray(rng.uniform(0.1, 2.0, n), jnp.float32)
    mesh = make_mesh(8)

    def build(use_pallas):
        @functools.partial(
            jax.shard_map, mesh=mesh,
            in_specs=(P("rows"), P("rows"), P("rows")),
            out_specs=(P("rows"), P("rows"), P("rows")),
            check_vma=False)
        def f(p, v, m):
            return _local_rows_force(p, v, m, 1e-3, 4.4985e-3, "rows",
                                     use_pallas=use_pallas)
        return f

    a1, j1, p1 = build(False)(pos, vel, mass)
    a2, j2, p2 = build(True)(pos, vel, mass)
    np.testing.assert_allclose(np.asarray(a1), np.asarray(a2),
                               rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p2),
                               rtol=2e-4, atol=1e-7)


def test_pallas_scattered_rows():
    """Arbitrary (non-contiguous, unordered) row subsets mask their self
    pairs correctly — the block-timestep fast-group path."""
    pos, vel, mass = _system(300, seed=9)
    a_full, j_full, p_full = kern(pos, vel, mass, 1e-3)
    ids = jnp.asarray([7, 3, 299, 150, 42, 0, 255], jnp.int32)
    a, j, p = kern_rows(pos[ids], vel[ids], ids, pos, vel, mass, eps2=1e-3)
    np.testing.assert_allclose(np.asarray(a), np.asarray(a_full[ids]),
                               rtol=2e-5, atol=1e-8)
    np.testing.assert_allclose(np.asarray(j), np.asarray(j_full[ids]),
                               rtol=2e-5, atol=1e-8)
    np.testing.assert_allclose(np.asarray(p), np.asarray(p_full[ids]),
                               rtol=2e-5, atol=1e-8)


def test_pallas_group_window_matches_per_group_dense():
    """group_size > 0 (flattened ensembles): the block-diagonal column
    window + mask must reproduce the per-group dense forces exactly, for a
    group size that straddles column-tile and row-block boundaries."""
    gs, b = 700, 3
    pos, vel, mass = _system(gs * b, seed=11)
    a, j, p = kern(pos, vel, mass, 1e-3, group_size=gs)
    for k in range(b):
        sl = slice(k * gs, (k + 1) * gs)
        a_ref, j_ref, p_ref = _dense64(pos[sl], vel[sl], mass[sl], 1e-3)
        np.testing.assert_allclose(np.asarray(a[sl]), np.asarray(a_ref),
                                   rtol=2e-4, atol=1e-7)
        np.testing.assert_allclose(np.asarray(j[sl]), np.asarray(j_ref),
                                   rtol=2e-4, atol=1e-7)
        np.testing.assert_allclose(np.asarray(p[sl]), np.asarray(p_ref),
                                   rtol=2e-4, atol=1e-7)


def test_pallas_group_window_scattered_rows():
    """The column window derives from row ids, so a SCATTERED fast-group row
    subset (block-timestep subcycle) with group masking stays correct even
    when its rows span several groups."""
    gs, b = 600, 3
    pos, vel, mass = _system(gs * b, seed=13)
    a_full, j_full, p_full = kern(pos, vel, mass, 1e-3, group_size=gs)
    ids = jnp.asarray([5, 1700, 599, 600, 1234, 0, 1799], jnp.int32)
    a, j, p = kern_rows(pos[ids], vel[ids], ids, pos, vel, mass, eps2=1e-3,
                        group_size=gs)
    np.testing.assert_allclose(np.asarray(a), np.asarray(a_full[ids]),
                               rtol=2e-5, atol=1e-8)
    np.testing.assert_allclose(np.asarray(j), np.asarray(j_full[ids]),
                               rtol=2e-5, atol=1e-8)
    np.testing.assert_allclose(np.asarray(p), np.asarray(p_full[ids]),
                               rtol=2e-5, atol=1e-8)


def test_pallas_pot_eps2_fused_sweep():
    """pot_eps2 decouples the potential's softening from the forces': one
    sweep returns BHTree-softened acc/jerk AND the unsoftened potential
    (what sim.step feeds the virial radius)."""
    pos, vel, mass = _system(400, seed=15)
    eps2 = 0.125
    a_s, j_s, _ = kern(pos, vel, mass, eps2)
    _, _, p_u = kern(pos, vel, mass, 0.0)
    a, j, p = kern(pos, vel, mass, eps2, pot_eps2=1e-30)
    np.testing.assert_allclose(np.asarray(a), np.asarray(a_s),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(np.asarray(j), np.asarray(j_s),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(np.asarray(p), np.asarray(p_u),
                               rtol=2e-5, atol=1e-8)


def test_pick_tiles_by_call_shape():
    assert call_kind(100, 100, 0) == "full"
    assert call_kind(512, 102400, 0) == "rows"
    assert call_kind(65536, 65536, 1024) == "group"
    assert call_kind(64, 65536, 1024) == "group"


@pytest.mark.parametrize("kind", sorted(TILES))
@pytest.mark.parametrize("group_size", [0, 1024])
def test_pallas_lowers_to_triton_for_cuda(set_tiles, kind, group_size):
    """The kernel lowers through Pallas' Triton route for CUDA (the IR the
    GPU compiles), at a ragged N, for every tile configuration; the
    lowering happens on the CPU, no card needed."""
    n, b = 4096 + 7, 512
    set_tiles(call_kind(b, n, group_size), TILES[kind])
    f32 = jnp.float32
    p = jax.ShapeDtypeStruct((n, 3), f32)
    m = jax.ShapeDtypeStruct((n,), f32)
    pr = jax.ShapeDtypeStruct((b, 3), f32)
    ids = jax.ShapeDtypeStruct((b,), jnp.int32)

    def f(a, v, i, q, w, mm):
        return pallas_acc_jerk_pot_rows(a, v, i, q, w, mm, eps2=0.125,
                                        group_size=group_size,
                                        pot_eps2=1e-30)

    with jax.enable_x64(False):
        text = jax.jit(f).trace(pr, pr, ids, p, p, m).lower(
            lowering_platforms=("cuda",)).as_text()
    assert "xla.gpu.triton" in text


# -- where the kernel runs (ops.backend) ---------------------------------

@pytest.mark.parametrize("platform,dtype,x64,n,want", [
    ("gpu", jnp.float32, False, 4096, True),
    ("gpu", jnp.float32, False, 4095, False),
    ("gpu", jnp.float64, False, 8192, False),
    ("gpu", jnp.float32, True, 8192, False),
    ("cpu", jnp.float32, False, 8192, False),
    ("rocm", jnp.float32, False, 8192, False),
])
def test_kernel_here(monkeypatch, platform, dtype, x64, n, want):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    with jax.enable_x64(x64):
        assert backend.kernel_here(n, dtype) is want


def test_kernel_interpret_needs_opt_in(monkeypatch):
    """On a CPU process an explicit kernel request runs the interpreter
    only under the test session's opt-in; otherwise it raises."""
    assert backend.kernel_interpret() is True   # conftest opted in
    monkeypatch.setattr(backend, "_interpret_opt_in", False)
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        backend.kernel_interpret()
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert backend.kernel_interpret() is False


def test_force_impl_pallas_raises_on_cpu_without_opt_in(monkeypatch):
    from al26.config import SimConfig
    from al26.sim import init_cluster, run_steps

    state, aux, cfg = init_cluster(SimConfig(n=64, rc=1.0, final_time=1.0,
                                             seed=1, dtype="f32"))
    monkeypatch.setattr(backend, "_interpret_opt_in", False)
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        run_steps(state, aux, cfg, 1, force_impl="pallas")


@pytest.mark.parametrize("env_dir", [None, "/some/cache"])
def test_compile_cache_location(monkeypatch, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins (and the code sets nothing);
    otherwise the cache is the fixed <repo>/.jax_cache."""
    import os

    before = jax.config.jax_compilation_cache_dir
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = backend.enable_compile_cache()
        if env_dir:
            assert got == env_dir
            assert jax.config.jax_compilation_cache_dir == before
        else:
            repo = os.path.dirname(os.path.dirname(os.path.abspath(
                __file__)))
            assert got == os.path.join(repo, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_auto_never_selects_kernel_on_cpu():
    from al26.config import SimConfig
    from al26.sim.step import _build_force_fn, _pallas_here

    mass = jnp.ones(8192, jnp.float32)
    cfg = SimConfig(n=8192, rc=1.0, dtype="f32")
    with jax.enable_x64(False):
        assert _build_force_fn(mass, 0.1, cfg, None, "auto") == (None, None)
        assert not _pallas_here(cfg, 8192, jnp.float32, None, "auto")


# -- on the card ---------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(TILES))
@pytest.mark.parametrize("with_jerk", [True, False])
def test_pallas_compiled_matches_dense(gpu, set_tiles, kind, with_jerk):
    """The compiled kernel against a float64 numpy reference, every tile
    configuration, ragged N."""
    set_tiles("full", TILES[kind])
    pos, vel, mass = _system(2007, seed=21)
    with jax.enable_x64(False):
        out = pallas_acc_jerk_pot(pos, vel, mass, 1e-3, with_jerk=with_jerk,
                                  pot_eps2=1e-30)
    x, v, m = (np.asarray(t, np.float64) for t in (pos, vel, mass))
    dx = x[None] - x[:, None]
    dv = v[None] - v[:, None]
    d2 = np.sum(dx * dx, axis=-1)
    np.fill_diagonal(d2, 1.0)
    inv_r = 1.0 / np.sqrt(d2 + 1e-3)
    inv_p = 1.0 / np.sqrt(d2 + 1e-30)
    np.fill_diagonal(inv_r, 0.0)
    np.fill_diagonal(inv_p, 0.0)
    w = m * inv_r ** 3
    s = 3.0 * np.sum(dx * dv, axis=-1) * inv_r ** 2
    from al26.units import G_INTERNAL as g

    ref = (g * np.sum(w[..., None] * dx, axis=1),
           g * np.sum(w[..., None] * (dv - s[..., None] * dx), axis=1),
           -g * np.sum(m * inv_p, axis=1))
    for k in (0, 1, 2) if with_jerk else (0, 2):
        got = np.asarray(out[k], np.float64)
        assert np.max(np.abs(got - ref[k])) / np.max(np.abs(ref[k])) < 1e-4
