"""Gravity kernel and integrator tests (SURVEY.md §4c)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from al26.ops.nbody import (
    acc_jerk_pot_chunked,
    acc_jerk_pot_dense,
    acc_pot_dense,
    half_mass_radius,
    kinetic_energy,
    local_densities,
    potential_energy,
    total_energy,
    virial_radius,
)
from al26.ops.integrators import hermite4_advance, leapfrog_advance
from al26.units import G_INTERNAL
from al26.models.plummer import plummer_positions_velocities


def _numpy_brute_force(pos, mass, eps2, g):
    n = len(pos)
    acc = np.zeros((n, 3))
    pot = np.zeros(n)
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            dx = pos[j] - pos[i]
            r2 = dx @ dx + eps2
            acc[i] += g * mass[j] * dx / r2**1.5
            pot[i] += -g * mass[j] / np.sqrt(r2)
    return acc, pot


def test_acc_pot_vs_numpy():
    rng = np.random.default_rng(0)
    n = 50
    pos = rng.normal(size=(n, 3))
    mass = rng.uniform(0.1, 2.0, n)
    eps2 = 1e-3
    a_np, p_np = _numpy_brute_force(pos, mass, eps2, G_INTERNAL)
    a, p = acc_pot_dense(jnp.asarray(pos), jnp.asarray(mass), eps2)
    np.testing.assert_allclose(np.asarray(a), a_np, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(p), p_np, rtol=1e-10)


def test_chunked_matches_dense():
    rng = np.random.default_rng(1)
    n = 300
    pos = jnp.asarray(rng.normal(size=(n, 3)))
    vel = jnp.asarray(rng.normal(size=(n, 3)))
    mass = jnp.asarray(rng.uniform(0.1, 2.0, n))
    a1, j1, p1 = acc_jerk_pot_dense(pos, vel, mass, 1e-4)
    a2, j2, p2 = acc_jerk_pot_chunked(pos, vel, mass, 1e-4, block=128)
    np.testing.assert_allclose(np.asarray(a1), np.asarray(a2), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(j1), np.asarray(j2), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p2), rtol=1e-12)


def test_jerk_is_time_derivative_of_acc():
    rng = np.random.default_rng(2)
    n = 20
    pos = jnp.asarray(rng.normal(size=(n, 3)))
    vel = jnp.asarray(rng.normal(size=(n, 3)) * 0.1)
    mass = jnp.asarray(rng.uniform(0.5, 1.5, n))
    _, jerk, _ = acc_jerk_pot_dense(pos, vel, mass, 0.0)
    h = 1e-7
    a_plus, _ = acc_pot_dense(pos + h * vel, mass, 0.0)
    a_minus, _ = acc_pot_dense(pos - h * vel, mass, 0.0)
    jerk_fd = (a_plus - a_minus) / (2 * h)
    np.testing.assert_allclose(np.asarray(jerk), np.asarray(jerk_fd),
                               rtol=1e-4, atol=1e-7)


def _kepler_two_body(e=0.5):
    """Two-body problem in internal units: m1=1, m2=1e-3 Msun, a=100 AU."""
    from al26.units import AU_TO_PC
    a = 100 * AU_TO_PC
    m1, m2 = 1.0, 1e-3
    mu = G_INTERNAL * (m1 + m2)
    r_apo = a * (1 + e)
    v_apo = np.sqrt(mu * (2 / r_apo - 1 / a))
    pos = jnp.asarray([[0.0, 0, 0], [r_apo, 0, 0]])
    vel = jnp.asarray([[0.0, 0, 0], [0, v_apo, 0]])
    mass = jnp.asarray([m1, m2])
    period = 2 * np.pi * np.sqrt(a**3 / mu)
    return pos, vel, mass, period, a, e


def test_hermite_kepler_orbit():
    pos, vel, mass, period, a, e = _kepler_two_body(0.5)
    # integrate one full orbit in 100 outer steps (one jitted scan: the
    # eager per-step dispatch dominated the test's wall time)
    dt = period / 100

    @jax.jit
    def orbit(p, v):
        def body(carry, _):
            p, v = carry
            p, v = hermite4_advance(p, v, mass, jnp.asarray(dt), eta=0.02,
                                    eps2=0.0, max_substeps=65536)
            return (p, v), None
        (p, v), _ = jax.lax.scan(body, (p, v), None, length=100)
        return p, v

    p, v = orbit(pos, vel)
    # back to apoapsis
    sep = np.linalg.norm(np.asarray(p[1] - p[0]))
    assert abs(sep / (a * (1 + e)) - 1) < 1e-3
    e0 = float(total_energy(pos, vel, mass))
    e1 = float(total_energy(p, v, mass))
    assert abs((e1 - e0) / e0) < 1e-6


def test_energy_conservation_plummer():
    """Softened Plummer sphere over many steps: |dE/E| small (the
    reference validates energy via BHTree re-evaluation,
    al26_plot.py:281-299)."""
    rng = np.random.default_rng(3)
    n = 128
    pos_np, vel_np = plummer_positions_velocities(rng, n, 1.0, n * 0.5)
    pos = jnp.asarray(pos_np)
    vel = jnp.asarray(vel_np)
    mass = jnp.full(n, 0.5)
    eps2 = 0.125  # BHTree-parity softening at rc=1
    e0 = float(total_energy(pos, vel, mass, eps2))
    dt = jnp.asarray(0.01)  # Myr

    @jax.jit
    def run(p, v):
        def body(carry, _):
            p, v = carry
            p, v = hermite4_advance(p, v, mass, dt, eta=0.1, eps2=eps2)
            return (p, v), None
        (p, v), _ = jax.lax.scan(body, (p, v), None, length=50)
        return p, v

    pos, vel = run(pos, vel)
    e1 = float(total_energy(pos, vel, mass, eps2))
    assert abs((e1 - e0) / e0) < 1e-5, (e0, e1)


def test_leapfrog_energy_bounded():
    rng = np.random.default_rng(4)
    n = 64
    pos_np, vel_np = plummer_positions_velocities(rng, n, 1.0, n * 0.5)
    pos, vel = jnp.asarray(pos_np), jnp.asarray(vel_np)
    mass = jnp.full(n, 0.5)
    eps2 = 0.125
    e0 = float(total_energy(pos, vel, mass, eps2))
    for _ in range(20):
        pos, vel = leapfrog_advance(pos, vel, mass, jnp.asarray(0.01),
                                    n_sub=16, eps2=eps2)
    e1 = float(total_energy(pos, vel, mass, eps2))
    assert abs((e1 - e0) / e0) < 1e-4


def test_cluster_diagnostics():
    rng = np.random.default_rng(5)
    n = 2000
    pos_np, _ = plummer_positions_velocities(rng, n, 1.0, 400.0)
    pos = jnp.asarray(pos_np)
    mass = jnp.full(n, 0.2)
    rv = float(virial_radius(pos, mass))
    assert 0.8 < rv < 1.3
    rh = float(half_mass_radius(pos, mass))
    # Plummer: r_h ~ 0.77 R_vir
    assert 0.6 < rh / rv < 0.95
    rho = np.asarray(local_densities(pos, mass))
    assert rho.shape == (n,) and (rho > 0).all()
    # central density greater than outskirts
    r = np.linalg.norm(pos_np, axis=1)
    assert rho[r < 0.3].mean() > 5 * rho[r > 1.5].mean()


def test_hermite_block_matches_shared_adaptive():
    """Two-group block-timestep Hermite tracks the shared-adaptive
    integrator on a softened Plummer sphere with an injected tight pair
    (the case that forces the shared step down)."""
    from al26.ops.integrators import hermite4_block_advance

    rng = np.random.default_rng(11)
    n = 128
    pos_np, vel_np = plummer_positions_velocities(rng, n, 1.0, n * 0.5)
    # inject a close fast pair to create a genuine fast group
    pos_np[1] = pos_np[0] + [5e-3, 0, 0]
    vel_np[1] = vel_np[0] + [0, 0.5, 0]
    pos = jnp.asarray(pos_np)
    vel = jnp.asarray(vel_np)
    mass = jnp.full(n, 0.5)
    eps2 = 1e-4
    dt = jnp.asarray(0.005)
    @jax.jit
    def run_both(p, v):
        def body(carry, _):
            p_r, v_r, p_b, v_b = carry
            p_r, v_r = hermite4_advance(p_r, v_r, mass, dt, eta=0.02,
                                        eps2=eps2, max_substeps=65536)
            p_b, v_b = hermite4_block_advance(p_b, v_b, mass, dt,
                                              k_fast=16, eta=0.02,
                                              eps2=eps2, max_substeps=65536)
            return (p_r, v_r, p_b, v_b), None
        out, _ = jax.lax.scan(body, (p, v, p, v), None, length=10)
        return out

    p_ref, v_ref, p_blk, v_blk = run_both(pos, vel)
    scale = float(jnp.max(jnp.abs(p_ref)))
    err = float(jnp.max(jnp.abs(p_blk - p_ref))) / scale
    assert err < 2e-4, err
    e_ref = float(total_energy(p_ref, v_ref, mass, eps2))
    e_blk = float(total_energy(p_blk, v_blk, mass, eps2))
    assert abs((e_blk - e_ref) / e_ref) < 1e-4


def test_hermite_block_energy_conservation():
    from al26.ops.integrators import hermite4_block_advance

    rng = np.random.default_rng(12)
    n = 96
    pos_np, vel_np = plummer_positions_velocities(rng, n, 1.0, n * 0.5)
    pos, vel = jnp.asarray(pos_np), jnp.asarray(vel_np)
    mass = jnp.full(n, 0.5)
    eps2 = 0.125
    e0 = float(total_energy(pos, vel, mass, eps2))

    @jax.jit
    def run(p, v):
        def body(carry, _):
            p, v = carry
            p, v = hermite4_block_advance(p, v, mass, jnp.asarray(0.01),
                                          k_fast=16, eta=0.1, eps2=eps2)
            return (p, v), None
        (p, v), _ = jax.lax.scan(body, (p, v), None, length=40)
        return p, v

    pos, vel = run(pos, vel)
    e1 = float(total_energy(pos, vel, mass, eps2))
    assert abs((e1 - e0) / e0) < 1e-5, (e0, e1)
