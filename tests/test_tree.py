"""Barnes-Hut tree tier (ops/tree.py + the force_impl="tree" wiring).

The reference's default gravity is the AMUSE BHTree treecode (monopole
cells, opening angle 0.75, leapfrog; al26_nbody.py:59,1712-1714). This
build's default stays EXACT direct summation; the tree is the opt-in
approximate tier for N >~ 2e5. Tests:

* small N (every block a near-field partner) => bit-level agreement with
  the exact solver, including padding (N not a multiple of leaf);
* clumpy mid-size N with the MAC engaged => error bounded at the
  BHTree-accuracy class, and the far field genuinely used;
* the near-field pair budget overflow poisons forces with NaN (never a
  silent truncation);
* step-level: force_impl="tree" leapfrog trajectories match the exact
  default-leapfrog ones at all-P2P scale; cached == uncached;
* config/driver guards: integrator resolution, hermite/mesh/ensemble
  rejections, kavg auto-sizing at init.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from al26.config import SimConfig
from al26.ops.nbody import acc_jerk_pot_chunked
from al26.ops.tree import (
    build_block_tree, make_tree_acc, make_tree_sweep, p2p_partner_counts,
    tree_acc_pot,
)


def _exact(pos, mass, eps2):
    acc, _, pot = acc_jerk_pot_chunked(
        pos, jnp.zeros_like(pos), mass, eps2, block=512
    )
    return acc, pot


def _clumpy(rng, n, n_clumps=48, spread=20.0, width=0.3):
    centers = rng.normal(size=(n_clumps, 3)) * spread
    pts = centers[rng.integers(0, n_clumps, n)] \
        + rng.normal(size=(n, 3)) * width
    return jnp.asarray(pts), jnp.asarray(rng.uniform(0.1, 5.0, n))


def test_small_n_equals_exact_including_padding():
    # N=1500 with leaf=128 pads to 12 -> 16 blocks; at this scale no node
    # passes the MAC, so every pair is resolved exactly: the tree must
    # agree with direct summation to fp roundoff, proving the Morton
    # sort/padding/unsort plumbing and the self-pair exclusion
    rng = np.random.default_rng(3)
    pos = jnp.asarray(rng.normal(size=(1500, 3)))
    mass = jnp.asarray(rng.uniform(0.1, 5.0, 1500))
    eps2 = 1e-4
    acc_ex, pot_ex = _exact(pos, mass, eps2)
    acc_t, pot_t, ovf = tree_acc_pot(pos, mass, eps2, leaf=128,
                                     theta=0.75, kavg=16)
    assert not bool(ovf)
    np.testing.assert_allclose(acc_t, acc_ex, rtol=0, atol=1e-12)
    np.testing.assert_allclose(pot_t, pot_ex, rtol=0, atol=1e-12)


def test_pot_eps2_convention():
    # pot_eps2 softens the potential separately from the forces — the
    # same convention as the Pallas kernel (raw-potential virial radius)
    from al26.ops.nbody import acc_pot_dense

    rng = np.random.default_rng(5)
    pos = jnp.asarray(rng.normal(size=(700, 3)))
    mass = jnp.asarray(rng.uniform(0.1, 5.0, 700))
    acc_ex, _ = acc_pot_dense(pos, mass, 1e-2)
    _, pot_ex = acc_pot_dense(pos, mass, 1e-30)
    acc_t, pot_t, _ = tree_acc_pot(pos, mass, 1e-2, leaf=128, theta=0.75,
                                   kavg=8, pot_eps2=1e-30)
    np.testing.assert_allclose(acc_t, acc_ex, rtol=0, atol=1e-12)
    np.testing.assert_allclose(pot_t, pot_ex, rtol=0, atol=1e-12)


def test_mac_engaged_accuracy_bounded():
    # widely separated clumps: the MAC accepts far clumps as monopoles
    # (near-field partner count well under B), and the acceleration
    # error stays in the BHTree class for theta=0.75
    rng = np.random.default_rng(7)
    pos, mass = _clumpy(rng, 4096)
    eps2 = 1e-4
    cnt = np.asarray(p2p_partner_counts(pos, mass, leaf=64, theta=0.75))
    b = len(cnt)
    assert cnt.mean() < 0.5 * b, "far field never engaged — MAC broken?"
    acc_ex, pot_ex = _exact(pos, mass, eps2)
    acc_t, pot_t, ovf = tree_acc_pot(pos, mass, eps2, leaf=64, theta=0.75,
                                     kavg=int(cnt.mean()) + 4)
    assert not bool(ovf)
    rel = np.linalg.norm(np.asarray(acc_t - acc_ex), axis=1) \
        / np.linalg.norm(np.asarray(acc_ex), axis=1)
    # measured on this fixture: median ~1.3e-4, max ~1.2e-2
    assert np.median(rel) < 1e-3
    assert rel.max() < 5e-2
    prel = np.abs(np.asarray(pot_t - pot_ex) / np.asarray(pot_ex))
    assert np.median(prel) < 1e-3


# slow lane (round-5 re-tier): op-level relative-MAC accuracy sweep (the production relative path keeps test_step_tree_relative_mac_tracks_exact default)
@pytest.mark.slow
def test_relative_mac_tightens_error():
    # the Springel-style relative criterion with a reference acceleration
    # must produce a SMALLER worst-case error than geometric theta=0.75
    # at a comparable or larger near-field cost
    rng = np.random.default_rng(11)
    pos, mass = _clumpy(rng, 4096)
    eps2 = 1e-4
    acc_ex, _ = _exact(pos, mass, eps2)
    aref = jnp.linalg.norm(acc_ex, axis=1)
    alpha = 1e-4
    cnt_g = np.asarray(p2p_partner_counts(pos, mass, leaf=128, theta=0.75))
    cnt_r = np.asarray(p2p_partner_counts(pos, mass, leaf=128, theta=alpha,
                                          aref=aref))
    acc_g, _, _ = tree_acc_pot(pos, mass, eps2, leaf=128, theta=0.75,
                               kavg=int(cnt_g.mean()) + 4)
    acc_r, _, _ = tree_acc_pot(pos, mass, eps2, leaf=128, theta=alpha,
                               kavg=int(cnt_r.mean()) + 4, aref=aref)
    rel_g = np.linalg.norm(np.asarray(acc_g - acc_ex), axis=1) / aref
    rel_r = np.linalg.norm(np.asarray(acc_r - acc_ex), axis=1) / aref
    # the criterion bounds each accepted NODE's truncation error by
    # alpha * |a|; totals accumulate over nodes, so allow 5x slack —
    # geometric theta=0.75's worst star (3.5e-3 measured) sits far
    # outside even that, which is the point of the relative mode
    assert rel_r.max() < 5 * alpha
    assert rel_g.max() > 5 * alpha
    assert np.median(rel_r) < np.median(rel_g)


def test_overflow_poisons_with_nan():
    rng = np.random.default_rng(13)
    pos, mass = _clumpy(rng, 2048)
    # budget of ~1 partner/block cannot even hold the self-blocks' row
    _, _, ovf = tree_acc_pot(pos, mass, 1e-4, leaf=128, theta=0.75, kavg=1)
    assert bool(ovf)
    sweep = make_tree_sweep(mass, 1e-4, leaf=128, theta=0.75, kavg=1,
                            pot_eps2=1e-30)
    acc, jerk, pot = sweep(pos, None)
    assert not bool(jnp.all(jnp.isfinite(acc)))
    assert not bool(jnp.all(jnp.isfinite(pot)))
    acc_fn = make_tree_acc(mass, 1e-4, leaf=128, theta=0.75, kavg=1)
    assert not bool(jnp.all(jnp.isfinite(acc_fn(pos))))
    # and a sufficient budget is clean
    cnt = np.asarray(p2p_partner_counts(pos, mass, leaf=128, theta=0.75))
    sweep_ok = make_tree_sweep(mass, 1e-4, leaf=128, theta=0.75,
                               kavg=int(cnt.mean()) + 4, pot_eps2=1e-30)
    acc, jerk, pot = sweep_ok(pos, None)
    assert bool(jnp.all(jnp.isfinite(acc))) and bool(
        jnp.all(jnp.isfinite(pot)))
    assert jerk.shape == acc.shape and not np.any(np.asarray(jerk))


def test_every_pair_covered_once():
    # mass-weighted counting: with G=1 and all masses 1, the potential
    # with pot_eps2 -> large is ~ -(N-1)/sqrt(eps2) per star IF AND ONLY
    # IF every source is counted exactly once (far + near, no node
    # double-counted below an accepted ancestor, no self term)
    rng = np.random.default_rng(17)
    n = 3000
    pos, mass = _clumpy(rng, n)
    mass = jnp.ones(n)
    big = 1e6  # softening dominates every distance -> each pair ~ 1/sqrt(big)
    _, pot_t, _ = tree_acc_pot(pos, mass, 1e-4, g=1.0, leaf=128, theta=0.75,
                               kavg=40, pot_eps2=big)
    expect = -(n - 1) / np.sqrt(big)
    np.testing.assert_allclose(np.asarray(pot_t), expect, rtol=5e-3)


def test_build_block_tree_padding_invariants():
    rng = np.random.default_rng(19)
    n, leaf = 900, 128  # pads 900 -> 8 blocks * 128 = 1024
    pos = jnp.asarray(rng.normal(size=(n, 3)))
    mass = jnp.asarray(rng.uniform(0.5, 2.0, n))
    tree = build_block_tree(pos, mass, leaf)
    # total node mass at every level equals the real total mass
    for m_l in tree.masses:
        np.testing.assert_allclose(float(jnp.sum(m_l)), float(jnp.sum(mass)),
                                    rtol=1e-12)
    # root com is the global com
    com = np.average(np.asarray(pos), axis=0, weights=np.asarray(mass))
    np.testing.assert_allclose(np.asarray(tree.coms[0][0]), com, atol=1e-12)
    # gidx covers 0..npad-1 exactly once
    assert sorted(np.asarray(tree.gidx_s).ravel().tolist()) == list(
        range(8 * leaf))


# ---------------------------------------------------------------------------
# step-level wiring
# ---------------------------------------------------------------------------
_BASE = dict(n=512, rc=1.0, final_time=0.1, n_plot=10, steps_per_plot=1,
             seed=42, model="fractal")


# slow lane (round-5 re-tier): leapfrog tree step equality (the hermite4_block step equality and the op-level small-N exactness stay default)
@pytest.mark.slow
def test_step_tree_matches_exact_leapfrog_small_n():
    from al26.sim.init import init_cluster
    from al26.sim.step import fresh_cache, run_steps_cached, step

    cfg_t = SimConfig(**_BASE, force_impl="tree")
    state_t, aux_t, rcfg_t = init_cluster(cfg_t)
    assert rcfg_t.integrator == "leapfrog"     # auto resolves to leapfrog
    assert rcfg_t.tree_kavg > 0                # auto-sized at init

    cfg_d = SimConfig(**_BASE, force_impl="default", integrator="leapfrog",
                      leapfrog_n_sub=rcfg_t.leapfrog_n_sub)
    state_d, aux_d, rcfg_d = init_cluster(cfg_d)

    s_t, s_d = state_t, state_d
    for _ in range(3):
        s_t = step(s_t, aux_t, rcfg_t, force_impl=rcfg_t.force_impl)
        s_d = step(s_d, aux_d, rcfg_d, force_impl=rcfg_d.force_impl)
    # N=512/leaf=256: all-P2P -> identical physics to fp tolerance
    np.testing.assert_allclose(np.asarray(s_t.cluster.pos),
                               np.asarray(s_d.cluster.pos), atol=1e-12)
    np.testing.assert_allclose(np.asarray(s_t.cluster.slr),
                               np.asarray(s_d.cluster.slr), atol=1e-25)

    # the cached path is bit-identical to the uncached one
    cache = fresh_cache(state_t, rcfg_t, rcfg_t.integrator,
                        force_impl=rcfg_t.force_impl)
    s_c, _ = run_steps_cached(state_t, cache, aux_t, rcfg_t, 3,
                              force_impl=rcfg_t.force_impl)
    np.testing.assert_array_equal(np.asarray(s_c.cluster.pos),
                                  np.asarray(s_t.cluster.pos))


def test_step_tree_hermite4_block_matches_exact_small_n():
    # round 5: the tier carries jerk, so hermite4_block runs over tree
    # forces. At all-P2P scale (N=512, leaf=256) the tree IS the exact
    # pair sum -> trajectories match the exact-backend block-Hermite to
    # fp tolerance, through the cached production path (run_steps).
    from al26.sim.init import init_cluster
    from al26.sim.step import run_steps

    cfg_t = SimConfig(**_BASE, force_impl="tree",
                      integrator="hermite4_block")
    state_t, aux_t, rcfg_t = init_cluster(cfg_t)
    assert rcfg_t.tree_kavg > 0
    cfg_d = SimConfig(**_BASE, force_impl="default",
                      integrator="hermite4_block", k_fast=rcfg_t.k_fast)
    state_d, aux_d, rcfg_d = init_cluster(cfg_d)

    s_t = run_steps(state_t, aux_t, rcfg_t, 3, force_impl="tree")
    s_d = run_steps(state_d, aux_d, rcfg_d, 3, force_impl="default")
    np.testing.assert_allclose(np.asarray(s_t.cluster.pos),
                               np.asarray(s_d.cluster.pos), atol=1e-10)
    np.testing.assert_allclose(np.asarray(s_t.cluster.slr),
                               np.asarray(s_d.cluster.slr), atol=1e-25)


def test_tree_auto_resolves_hermite4_block_large_n():
    # auto + tree resolves to the block-Hermite above the hermite4
    # cutover (the large-N regime the tier exists for); pure config-level
    # check via resolve_integrator (no init at 10k stars needed)
    from al26.sim.init import resolve_integrator

    cfg = resolve_integrator(
        SimConfig(n=10000, force_impl="tree"), m_total=6000.0)
    assert cfg.integrator == "hermite4_block"
    assert cfg.k_fast and cfg.k_fast > 0
    cfg_small = resolve_integrator(
        SimConfig(n=512, force_impl="tree"), m_total=300.0)
    assert cfg_small.integrator == "leapfrog"


def test_tree_jerk_matches_exact_small_n():
    # all-P2P scale: tree jerk == exact pairwise jerk to fp roundoff
    from al26.ops.tree import tree_acc_jerk_pot

    rng = np.random.default_rng(37)
    n = 1500
    pos = jnp.asarray(rng.normal(size=(n, 3)))
    vel = jnp.asarray(rng.normal(size=(n, 3)))
    mass = jnp.asarray(rng.uniform(0.1, 5.0, n))
    eps2 = 1e-4
    acc_ex, jerk_ex, _ = acc_jerk_pot_chunked(pos, vel, mass, eps2,
                                              block=512)
    acc_t, jerk_t, _, ovf = tree_acc_jerk_pot(
        pos, vel, mass, eps2, leaf=128, theta=0.75, kavg=16, with_jerk=True)
    assert not bool(ovf)
    np.testing.assert_allclose(np.asarray(jerk_t), np.asarray(jerk_ex),
                               rtol=0, atol=1e-11)
    np.testing.assert_allclose(np.asarray(acc_t), np.asarray(acc_ex),
                               rtol=0, atol=1e-12)


def test_tree_jerk_monopole_accuracy_bounded():
    # MAC engaged: the monopole jerk (nodes moving at their mass-weighted
    # mean velocity) stays in the same accuracy class as the monopole
    # acceleration — jerk only steers the Hermite timestep/corrector
    from al26.ops.tree import tree_acc_jerk_pot

    rng = np.random.default_rng(41)
    pos, mass = _clumpy(rng, 4096)
    vel = jnp.asarray(rng.normal(size=(4096, 3)))
    eps2 = 1e-4
    _, jerk_ex, _ = acc_jerk_pot_chunked(pos, vel, mass, eps2, block=512)
    cnt = np.asarray(p2p_partner_counts(pos, mass, leaf=64, theta=0.75))
    _, jerk_t, _, ovf = tree_acc_jerk_pot(
        pos, vel, mass, eps2, leaf=64, theta=0.75,
        kavg=int(cnt.mean()) + 4, with_jerk=True)
    assert not bool(ovf)
    rel = np.linalg.norm(np.asarray(jerk_t - jerk_ex), axis=1) \
        / np.maximum(np.linalg.norm(np.asarray(jerk_ex), axis=1), 1e-30)
    assert np.median(rel) < 3e-3
    assert np.percentile(rel, 99) < 1e-1


def test_tree_theta_validated():
    rng = np.random.default_rng(43)
    pos = jnp.asarray(rng.normal(size=(256, 3)))
    mass = jnp.ones(256)
    with pytest.raises(ValueError, match="theta <= 1"):
        tree_acc_pot(pos, mass, 1e-4, leaf=128, theta=1.5, kavg=8)
    with pytest.raises(ValueError, match="must be > 0"):
        tree_acc_pot(pos, mass, 1e-4, leaf=128, theta=0.0, kavg=8)
    from al26.sim.init import init_cluster
    with pytest.raises(ValueError, match="tree_theta"):
        init_cluster(SimConfig(**_BASE, force_impl="tree", tree_theta=1.5))


def test_tree_rejects_hermite_and_bad_mesh_and_ensemble():
    from al26.sim.init import init_cluster

    with pytest.raises(ValueError, match="supports integrator"):
        init_cluster(SimConfig(**_BASE, force_impl="tree",
                               integrator="hermite4"))

    from al26.sim.driver import run, run_ensemble

    # mesh + tree is supported (round 5) — but the block count must
    # divide by the mesh (n=512 at leaf=256 -> 2 blocks vs 8 devices),
    # and leapfrog cannot ride the mesh sweep
    with pytest.raises(ValueError, match="divide by the mesh"):
        run(SimConfig(**_BASE, force_impl="tree", mesh_shape=(8,)))
    with pytest.raises(ValueError, match="hermite4_block"):
        init_cluster(SimConfig(**_BASE, force_impl="tree",
                               mesh_shape=(8,), tree_leaf=16,
                               integrator="leapfrog"))
    cfg_e = SimConfig(**_BASE, force_impl="tree", ensemble=2)
    with pytest.raises(ValueError, match="single-run"):
        run_ensemble(cfg_e)


# slow lane (round-5 re-tier): mesh-tree equality (the dryrun tree axis compiles+executes the mesh path; rejection/validation tests stay default)
@pytest.mark.slow
def test_tree_mesh_matches_single_chip():
    # the mesh tree sweep (replicated tree, sharded far-field targets +
    # near-field pair list, psum) equals the single-chip tree step to fp
    # tolerance, through the production cached run_steps path on the
    # fake 8-device mesh
    import jax

    from al26.parallel.sharded import make_mesh, shard_state_rows
    from al26.sim.init import init_cluster
    from al26.sim.step import run_steps

    assert len(jax.devices()) == 8
    cfg = SimConfig(**_BASE, force_impl="tree", tree_leaf=16,
                    integrator="hermite4_block", k_fast=32)
    state, aux, rcfg = init_cluster(cfg)
    s_one = run_steps(state, aux, rcfg, 3, force_impl="tree")

    rcfg_m = rcfg.replace(mesh_shape=(8,))
    mesh = make_mesh(8)
    st_m = shard_state_rows(state, mesh)
    s_mesh = run_steps(st_m, aux, rcfg_m, 3, mesh=mesh, force_impl="tree")
    np.testing.assert_allclose(np.asarray(s_mesh.cluster.pos),
                               np.asarray(s_one.cluster.pos), atol=1e-11)
    np.testing.assert_allclose(np.asarray(s_mesh.cluster.slr),
                               np.asarray(s_one.cluster.slr), atol=1e-26)


def test_cli_tree_flags():
    from al26.cli import build_parser, config_from_args

    args = build_parser().parse_args(
        ["-n", "512", "-rc", "1.0", "--force_impl", "tree",
         "--tree_theta", "0.6", "--tree_leaf", "128", "--tree_kavg", "32"]
    )
    cfg = config_from_args(args)
    assert cfg.force_impl == "tree"
    assert cfg.tree_theta == 0.6
    assert cfg.tree_leaf == 128
    assert cfg.tree_kavg == 32


def test_step_tree_relative_mac_tracks_exact():
    # relative MAC through the production cached path: tight alpha on an
    # all-P2P-scale cluster stays within fp distance of the exact
    # block-Hermite (the seeding sweep is EXACT by design; subsequent
    # steps open against the cached acceleration)
    from al26.sim.init import init_cluster
    from al26.sim.step import run_steps

    cfg_t = SimConfig(**_BASE, force_impl="tree", tree_mac="relative",
                      tree_alpha=1e-5)
    state_t, aux_t, rcfg_t = init_cluster(cfg_t)
    assert rcfg_t.integrator == "hermite4_block"  # forced by relative
    assert rcfg_t.tree_kavg > 0
    cfg_d = SimConfig(**_BASE, force_impl="default",
                      integrator="hermite4_block", k_fast=rcfg_t.k_fast)
    state_d, aux_d, rcfg_d = init_cluster(cfg_d)

    s_t = run_steps(state_t, aux_t, rcfg_t, 3, force_impl="tree")
    s_d = run_steps(state_d, aux_d, rcfg_d, 3, force_impl="default")
    assert bool(jnp.all(jnp.isfinite(s_t.cluster.pos)))
    np.testing.assert_allclose(np.asarray(s_t.cluster.pos),
                               np.asarray(s_d.cluster.pos), atol=1e-7)


def test_tree_relative_mac_config_guards():
    from al26.sim.init import init_cluster

    with pytest.raises(ValueError, match="relative"):
        init_cluster(SimConfig(**_BASE, force_impl="tree",
                               tree_mac="relative", integrator="leapfrog"))
    # the reference acceleration rides the force cache: configs that
    # disable it would silently run the exact seeding sweep every step
    # (review r5) — refused at init instead
    with pytest.raises(ValueError, match="force cache"):
        init_cluster(SimConfig(**_BASE, force_impl="tree",
                               tree_mac="relative", force_cache=False))
    with pytest.raises(ValueError, match="force cache"):
        init_cluster(SimConfig(**_BASE, force_impl="tree",
                               tree_mac="relative", natal_kicks=True))
    # defensive _resolve_integ mirrors the relative -> hermite4_block
    # rule for dict-recreated configs that bypass init
    from al26.sim.step import _resolve_integ

    assert _resolve_integ(
        SimConfig(**_BASE, force_impl="tree", tree_mac="relative"), 512
    ) == "hermite4_block"
    with pytest.raises(ValueError, match="tree_alpha"):
        init_cluster(SimConfig(**_BASE, force_impl="tree",
                               tree_mac="relative", tree_alpha=0.0))
    with pytest.raises(ValueError, match="tree_mac"):
        init_cluster(SimConfig(**_BASE, force_impl="tree",
                               tree_mac="nope"))


def test_cli_tree_mac_flags():
    from al26.cli import build_parser, config_from_args

    args = build_parser().parse_args(
        ["-n", "512", "-rc", "1.0", "--force_impl", "tree",
         "--tree_mac", "relative", "--tree_alpha", "1e-3"]
    )
    cfg = config_from_args(args)
    assert cfg.tree_mac == "relative"
    assert cfg.tree_alpha == 1e-3
