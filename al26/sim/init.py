"""Cluster initialisation: the `init_cluster` equivalent
(al26_nbody.py:1492-1610) plus interloper spawning (al26_nbody.py:1448-1490).

Everything here runs once on the host (numpy + table lookups); the result is
a device-resident `SimState` plus a `SimAux` bundle of fixed-shape auxiliary
arrays (massive-star candidate slots, AGB rate grids) consumed by the jitted
step.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SimConfig
from ..models import agb as agb_mod
from ..models import discs, imf
from ..models.fractal import fractal_positions_velocities
from ..models.plummer import plummer_positions_velocities
from ..models.stellar import evolution as stellar
from ..models.yields import feh_for_z, massive_star_yields, read_slrs
from ..state import Cluster, N_CH, N_ISO, SimState
from ..units import KMS_TO_PCMYR


@jax.tree_util.register_dataclass
@dataclass
class SimAux:
    """Fixed-shape auxiliary inputs to the step (not part of the evolving
    state)."""

    hm_idx: jax.Array        # [H] candidate massive-star indices (m0 >= 13)
    hm_slot_valid: jax.Array  # [H] bool: False for padding slots (ensemble
    #                           realizations pad to a common width; a padded
    #                           slot repeats index 0 and MUST be masked or
    #                           star 0's contribution double-counts)
    msrc_idx: jax.Array      # [M] indices of every star whose mass evolves
    #                           (m0 >= stellar.SN_MIN_MASS): the sources of
    #                           the force-cache mass-delta correction
    #                           (sim.step), a superset of hm_idx
    msrc_valid: jax.Array    # [M] bool: False for padding slots
    agb_grid_t: jax.Array    # [G] Myr (zeros when interloper disabled)
    agb_grid_rates: jax.Array  # [S,G] Msun/Myr
    kick_vel: jax.Array      # [H,3] pc/Myr pre-drawn natal-kick velocities,
    #                           aligned with hm_idx slots; applied once at
    #                           each star's SN when cfg.natal_kicks (the
    #                           reference's commented-out kick block,
    #                           al26_nbody.py:846-865). Drawn from a
    #                           dedicated seed stream so cold init and
    #                           resume agree and the main RNG stream is
    #                           untouched.
    stellar_tbl: stellar.PhaseTable  # per-star (m0, z)-only phase
    #                           constants, precomputed once — the per-step
    #                           stellar.evolve re-ran the Hurley fits every
    #                           step on constant inputs;
    #                           evolve_from_table is ~10 elementwise ops.
    #                           Stored in the precision it was computed in
    #                           (f64 under x64) for bit-identical results.

    def replace(self, **kw):
        import dataclasses
        return dataclasses.replace(self, **kw)


def _dtype(cfg: SimConfig):
    return jnp.float64 if cfg.dtype == "f64" else jnp.float32


def _draw_kicks(cfg: SimConfig, n_slots: int) -> np.ndarray:
    """Pre-drawn natal-kick velocity vectors, [n_slots, 3] pc/Myr.

    Three iid Gaussian components of dispersion cfg.kick_sigma_kms — the
    Hobbs et al. (2005) Maxwellian pulsar-kick model (the distribution
    family SeBa's natal_kick_* attributes come from; the reference reads
    but never applies them, al26_nbody.py:846-865). Dedicated seed stream:
    independent of the IMF/IC draws, reproducible across resume."""
    krng = np.random.default_rng([cfg.seed, 0x6B69636B])  # ascii "kick"
    return krng.normal(0.0, cfg.kick_sigma_kms,
                       (n_slots, 3)) * KMS_TO_PCMYR


def _mass_source_slots(cfg: SimConfig, m0: np.ndarray,
                       is_interloper: np.ndarray | None = None):
    """Indices of stars whose mass evolves in time (m0 >= the SN cut,
    excluding the interloper, whose mass is pinned) — the sources of the
    force-cache mass-delta correction."""
    sel = m0 >= stellar.SN_MIN_MASS
    if is_interloper is not None:
        sel = sel & ~is_interloper
    idx = np.flatnonzero(sel)
    if len(idx) == 0:
        idx = np.array([0])
        return idx, np.zeros(1, bool)
    return idx, np.ones(len(idx), bool)


def _stellar_table(cfg: SimConfig, m0: np.ndarray, dtype):
    """stellar.PhaseTable from the initial masses, as numpy arrays.

    Computed on the CPU backend (hundreds of small eager ops whose results
    stay on the host: on an accelerator each would be a launch plus a copy
    back) from the STATE-dtype m0, so the table holds exactly
    the values the per-step stellar.evolve used to compute (including the
    promotion to f64 under x64 — the arrays keep that precision)."""
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        tbl = stellar.phase_table(jnp.asarray(np.asarray(m0, dtype)),
                                  z=cfg.metallicity, tracks=cfg.mass_tracks)
    return stellar.PhaseTable(*(np.asarray(a) for a in tbl))


def _hm_candidate_slots(cfg: SimConfig, m0: np.ndarray):
    """Massive-star candidate slots (m0 >= threshold) with an explicit
    validity mask. A cluster with NO candidate gets one MASKED fallback
    slot (shapes must be nonempty): the slot must be invalid, because a
    low-mass star's mdot is exactly 0.0 every step — which sn_injection
    reads as a core collapse, falsely flagging star 0 kicked (and, under
    cfg.natal_kicks, ejecting it at ~265 km/s). Mirrors
    _mass_source_slots' masked fallback. Shared by build_aux (resume) and
    init_cluster (cold start) so the two paths cannot diverge."""
    idx = np.flatnonzero(m0 >= cfg.high_mass_threshold)
    if len(idx) == 0:
        return np.array([0]), np.zeros(1, bool)
    return idx, np.ones(len(idx), bool)


def build_aux(cfg: SimConfig, m0: np.ndarray, dtype,
              data_dir: str | None = None,
              is_interloper: np.ndarray | None = None) -> SimAux:
    """Fixed-shape aux bundle from the initial masses: massive-star
    candidate slots (m0 >= threshold) and the AGB rate grids. Shared by
    cold init and checkpoint resume."""
    hm_candidates, hm_valid = _hm_candidate_slots(cfg, m0)
    msrc_idx, msrc_valid = _mass_source_slots(cfg, m0, is_interloper)
    agb_grid_t = np.zeros(1)
    agb_grid_rates = np.zeros((N_ISO, 1))
    if cfg.interloper:
        tables = agb_mod.read_agbs(data_dir)
        table = agb_mod.find_agb(tables, cfg.interloper_mass)
        agb_grid_t = table.grid_t
        agb_grid_rates = np.stack([table.grid_26al, table.grid_60fe])
    return SimAux(
        hm_idx=jnp.asarray(hm_candidates, dtype=jnp.int32),
        hm_slot_valid=jnp.asarray(hm_valid),
        msrc_idx=jnp.asarray(msrc_idx, dtype=jnp.int32),
        msrc_valid=jnp.asarray(msrc_valid),
        agb_grid_t=jnp.asarray(agb_grid_t, dtype=dtype),
        agb_grid_rates=jnp.asarray(agb_grid_rates, dtype=dtype),
        kick_vel=jnp.asarray(_draw_kicks(cfg, len(hm_candidates)),
                             dtype=dtype),
        stellar_tbl=stellar.PhaseTable(
            *(jnp.asarray(a) for a in _stellar_table(cfg, m0, dtype))
        ),
    )


def resolve_integrator(cfg: SimConfig, m_total: float) -> SimConfig:
    """Resolve integrator="auto", the BHTree-parity leapfrog substep count
    (internal dt = 1/64 N-body time unit, the AMUSE BHTree default;
    al26_nbody.py:59,1712-1714), and the block-timestep fast-group size.

    auto -> hermite4 (ph4-parity shared adaptive step) up to 8192 stars,
    hermite4_block above: the two-group block-timestep Hermite is BOTH more
    accurate than the reference's default BHTree leapfrog (4th order +
    adaptive close-encounter group vs 2nd order fixed substeps) and far
    cheaper at large N — the shared adaptive step collapses there, because
    the min over N of the Aarseth criterion forces every star onto the
    tightest binary's substep."""
    from ..units import G_INTERNAL

    integ = cfg.integrator
    if cfg.force_impl == "tree":
        # round 5: the tier carries acc AND jerk (monopole far-field
        # jerk + exact near-field jerk, ops.tree.tree_acc_jerk_pot), so
        # the block-timestep Hermite runs over tree forces — ONE tree
        # sweep per step through the force cache. auto: BHTree-parity
        # leapfrog at small N, hermite4_block in the large-N regime the
        # tier exists for. The shared-adaptive hermite4 stays rejected
        # (a full tree build+sweep per substep defeats the tier).
        if cfg.tree_mac not in ("geometric", "relative"):
            raise ValueError(
                f"tree_mac={cfg.tree_mac!r}: 'geometric' or 'relative'"
            )
        if cfg.mesh_shape is not None:
            # mesh tree (parallel.tree_mesh): replicated tree build,
            # sharded far-field targets + near-field pair list;
            # hermite4_block-only (the leapfrog acc-only path is not
            # wired through the mesh sweep)
            if integ == "auto":
                integ = "hermite4_block"
            elif integ != "hermite4_block":
                raise ValueError(
                    "force_impl='tree' under a mesh requires "
                    f"integrator='hermite4_block'; got {integ!r}"
                )
            n_dev = int(np.prod(cfg.mesh_shape))
            nblocks = -(-cfg.n // cfg.tree_leaf)
            b = 1 << max(1, (nblocks - 1).bit_length())
            if b % n_dev:
                raise ValueError(
                    f"tree block count {b} (n={cfg.n}, tree_leaf="
                    f"{cfg.tree_leaf}) must divide by the mesh size "
                    f"{n_dev}; lower tree_leaf"
                )
        if cfg.tree_mac == "relative":
            # the reference acceleration rides the force cache on the
            # hermite4_block path (sim.step); leapfrog's interior
            # substeps carry no acceleration channel to thread it
            if integ == "auto":
                integ = "hermite4_block"
            elif integ != "hermite4_block":
                raise ValueError(
                    "tree_mac='relative' requires "
                    f"integrator='hermite4_block'; got {integ!r}"
                )
            if cfg.tree_alpha <= 0.0:
                raise ValueError(
                    f"tree_alpha={cfg.tree_alpha}: must be > 0"
                )
            if not cfg.force_cache or cfg.natal_kicks:
                # the reference acceleration rides the force cache;
                # without it every step would silently run the exact
                # O(N^2) seeding sweep (review r5) — refuse instead
                raise ValueError(
                    "tree_mac='relative' requires the force cache "
                    "(force_cache=True and natal_kicks=False — kicks "
                    "disable the Hermite cache, sim.step._cacheable)"
                )
        elif integ == "auto":
            integ = "leapfrog" if cfg.n <= 8192 else "hermite4_block"
        elif integ not in ("leapfrog", "hermite4_block"):
            raise ValueError(
                "force_impl='tree' supports integrator='leapfrog' or "
                f"'hermite4_block'; got integrator={integ!r}"
            )
        if not 0.0 < cfg.tree_theta <= 1.0:
            # the geometric MAC's no-self-interaction argument needs
            # theta <= 1 (ops.tree._check_theta; advisor r4). Validated
            # in every tree_mac: the cache-seeding first sweep of a run
            # is always geometric.
            raise ValueError(
                f"tree_theta={cfg.tree_theta}: must be in (0, 1]"
            )
    elif integ == "auto":
        integ = "hermite4" if cfg.n <= 8192 else "hermite4_block"
    n_sub = cfg.leapfrog_n_sub
    if integ == "leapfrog" and n_sub is None:
        t_nbody = float(np.sqrt(cfg.rc**3 / (G_INTERNAL * m_total)))
        raw = cfg.dt / (t_nbody / 64.0)
        n_sub = int(max(1, 2 ** int(np.ceil(np.log2(max(raw, 1.0))))))
    elif n_sub is None:
        n_sub = 8
    k_fast = cfg.k_fast
    if integ == "hermite4_block" and k_fast is None:
        # the fast group only needs to hold the close encounters that set
        # the shared-step minimum; n/128 bounded to [256, 512] keeps the
        # subcycle cost (S_sub * K * N pairs) well under the two full
        # sweeps. Measured at N=102400/f32: |dE/E| = 4.1e-6/Myr at k=256,
        # 2.8e-6 at k=1024 — drift is flat in k while the subcycle cost
        # grows with k, so small k wins (docs/precision.md).
        k_fast = int(max(256, min(512, cfg.n // 128)))
    return cfg.replace(integrator=integ, leapfrog_n_sub=n_sub, k_fast=k_fast)


def init_cluster(cfg: SimConfig, data_dir: str | None = None,
                 as_numpy: bool = False):
    """Build the initial SimState/SimAux for a fresh run.

    Returns (state, aux, resolved_cfg): interloper parameters with random
    defaults (closest approach, velocity; al26_nbody.py:1666-1676) are
    resolved into the returned config so they are recorded in checkpoints.

    as_numpy=True keeps every array on the host (numpy): ensemble init
    stacks many realizations and transfers ONCE instead of ~45 small
    device transfers per realization.
    """
    rng = np.random.default_rng(cfg.seed)
    dtype = _dtype(cfg)

    # resolve the mass-track family (like resolve_integrator: the
    # resolved literal is what checkpoints record). None + sn_parity_mode
    # -> the SeBa-calibrated reference-outcome tracks, for library
    # callers as well as the CLI; an EXPLICIT "lc18" + parity keeps
    # rule-parity (docs/stellar_model.md firing-band table).
    if cfg.mass_tracks is None:
        cfg = cfg.replace(
            mass_tracks="seba" if cfg.sn_parity_mode else "lc18"
        )

    # metallicity feeds the Hurley+2000 lifetime fits (valid over the
    # published range) and selects the LC18 [Fe/H] anchor/yield sets
    # (models/stellar/evolution.py docstring). The reference itself always
    # runs Z=0.02 (al26_nbody.py:467,483).
    if not (1e-4 <= cfg.metallicity <= 0.03):
        raise ValueError(
            f"metallicity Z={cfg.metallicity} outside the Hurley et al. "
            "(2000) fit validity range [1e-4, 0.03]"
        )
    # mass-track family validation up front (seba is solar-Z-only)
    stellar.check_tracks(cfg.mass_tracks, cfg.metallicity)

    # -- masses (IMF with >=13 Msun re-roll, al26_nbody.py:1508-1510) ------
    masses = imf.generate_masses(
        rng, cfg.n, cfg.star_min_mass, cfg.star_max_mass,
        no_massive_star_requirement=cfg.no_massive_star_requirement,
        massive_threshold=cfg.high_mass_threshold,
    )
    m_total = float(masses.sum())
    cfg = resolve_integrator(cfg, m_total)

    # -- positions / velocities --------------------------------------------
    if cfg.model == "plummer":
        pos, vel = plummer_positions_velocities(rng, cfg.n, cfg.rc, m_total)
    elif cfg.model == "fractal":
        pos, vel = fractal_positions_velocities(
            rng, cfg.n, cfg.rc, m_total, cfg.fractal_dimension
        )
    else:
        raise ValueError(
            'Invalid choice of cluster model, must be either "plummer" or '
            '"fractal"!'
        )

    # -- discs ---------------------------------------------------------
    lm = (masses >= cfg.low_mass_min) & (masses <= cfg.low_mass_max)
    hm = masses >= cfg.high_mass_threshold
    tau_disk = discs.draw_disk_lifetimes(rng, cfg.n, cfg.disk_lifetime_mean)
    r_disk = np.full(cfg.n, discs.disk_radius_pc(cfg.disk_radius))

    # -- per-star yield data for massive stars -----------------------------
    # init-time stellar math runs on the CPU backend: many small eager jnp
    # ops whose results are needed on the host (see _stellar_table)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        total_wind_loss = np.where(
            hm, np.asarray(stellar.total_wind_loss(
                jnp.asarray(masses), z=cfg.metallicity,
                tracks=cfg.mass_tracks)), 0.0
        )  # remnant anchors follow cfg.metallicity onto the LC18 [Fe/H]
        #    grid (models.stellar.lc18_anchors) and cfg.mass_tracks onto
        #    the track family, like the yield tables follow feh
    # yield tables follow cfg.metallicity onto the nearest LC18 [Fe/H]
    # grid point (solar Z=0.02 -> feh=0, the reference's fixed choice)
    # and cfg.yields_vel onto the rotation-velocity reduction (300 =
    # reference parity for every track family)
    slrs = read_slrs(data_dir, feh=feh_for_z(cfg.metallicity),
                     vel=cfg.yields_vel)
    ydata = massive_star_yields(masses, slrs, total_wind_loss,
                                cfg.high_mass_threshold)

    # -- optional interloper -------------------------------------------
    n_total = cfg.n + (1 if cfg.interloper else 0)
    agb_grid_t = np.zeros(1)
    agb_grid_rates = np.zeros((N_ISO, 1))
    resolved = cfg
    if cfg.interloper:
        # resolve randomised defaults (al26_nbody.py:1666-1676)
        ri = cfg.interloper_radius
        if ri is None:
            ri = float(rng.uniform(0.0, cfg.rc))
        di = cfg.interloper_distance
        if di is None:
            di = 2.0 * cfg.rc
        vi = cfg.interloper_velocity
        if vi is None:
            vi = float(rng.uniform(0.0, 100.0))
        resolved = cfg.replace(
            interloper_radius=ri, interloper_distance=di,
            interloper_velocity=vi,
        )
        tables = agb_mod.read_agbs(data_dir)
        table = agb_mod.find_agb(tables, cfg.interloper_mass)
        agb_grid_t = table.grid_t
        agb_grid_rates = np.stack([table.grid_26al, table.grid_60fe])

        # spawned at (-distance, closest_approach, 0) moving along +x
        # (al26_nbody.py:1479-1485)
        pos = np.vstack([pos, [-di, ri, 0.0]])
        vel = np.vstack([vel, [vi * KMS_TO_PCMYR, 0.0, 0.0]])
        masses = np.append(masses, cfg.interloper_mass)
        tau_disk = np.append(tau_disk, 0.0)
        r_disk = np.append(r_disk, 0.0)
        lm = np.append(lm, False)
        hm = np.append(hm, False)
        total_wind_loss = np.append(total_wind_loss, 0.0)
        for k in ydata:
            ydata[k] = np.append(ydata[k], 0.0)

    is_interloper = np.zeros(n_total, bool)
    if cfg.interloper:
        is_interloper[-1] = True

    # -- tree-tier near-field budget (like resolve_integrator: the
    # resolved literal is what checkpoints record) — measured on the
    # realised initial positions, x2 slack for relaxation drift; runtime
    # overflow past the budget NaN-poisons the forces (ops.tree)
    if resolved.force_impl == "tree" and resolved.tree_kavg == 0:
        from ..ops.tree import p2p_partner_counts

        if resolved.tree_mac == "relative":
            # the relative criterion needs a reference acceleration:
            # one exact sweep on the default device (the Pallas kernel
            # where ops.backend.kernel_here says so, the chunked XLA
            # sweep otherwise). Budget = max of the geometric counts
            # (the cache-seeding first sweep of every run/resume) and
            # the relative counts the per-step sweeps settle at.
            from ..ops.nbody import acc_jerk_pot_chunked
            from ..ops import backend
            from ..ops.pallas_nbody import pallas_acc_jerk_pot

            pos_d = jnp.asarray(pos, dtype)
            mass_d = jnp.asarray(masses, dtype)
            if backend.kernel_here(len(masses), pos_d.dtype):
                a_ex, _, _ = pallas_acc_jerk_pot(pos_d, pos_d * 0.0,
                                                 mass_d, resolved.eps2)
            else:
                a_ex, _, _ = jax.jit(acc_jerk_pot_chunked)(
                    pos_d, pos_d * 0.0, mass_d,
                    jnp.asarray(resolved.eps2, dtype))
            aref = jnp.sqrt(jnp.sum(a_ex * a_ex, axis=-1))
            cnt_rel = np.asarray(p2p_partner_counts(
                pos_d, mass_d, leaf=resolved.tree_leaf,
                theta=resolved.tree_alpha, aref=aref,
            ))
            cnt_geo = np.asarray(p2p_partner_counts(
                pos_d, mass_d, leaf=resolved.tree_leaf,
                theta=resolved.tree_theta,
            ))
            kavg = int(2.0 * max(cnt_rel.mean(), cnt_geo.mean())) + 8
        else:
            # small n: CPU (a device dispatch costs more than the
            # count); production n: the default device — the dense
            # [B, 2B] mask sweep is minutes of host CPU at N >= 4e5
            if resolved.n >= 65536:
                cnt = np.asarray(p2p_partner_counts(
                    jnp.asarray(pos, dtype), jnp.asarray(masses, dtype),
                    leaf=resolved.tree_leaf, theta=resolved.tree_theta,
                ))
            else:
                with jax.default_device(cpu):
                    cnt = np.asarray(p2p_partner_counts(
                        jnp.asarray(pos), jnp.asarray(masses),
                        leaf=resolved.tree_leaf, theta=resolved.tree_theta,
                    ))
            kavg = int(2.0 * cnt.mean()) + 8
        resolved = resolved.replace(tree_kavg=kavg)

    # -- fixed massive-star candidate slots ---------------------------------
    hm_candidates, hm_valid = _hm_candidate_slots(cfg, masses)

    with jax.default_device(cpu):
        mdot0 = np.asarray(
            stellar.wind_mdot(jnp.asarray(masses),
                              jnp.zeros_like(jnp.asarray(masses)),
                              z=cfg.metallicity, tracks=cfg.mass_tracks)
        )

    if as_numpy:
        np_float = np.float64 if cfg.dtype == "f64" else np.float32
        f = lambda a: np.asarray(a, dtype=np_float)
        zeros_f = lambda *shape: np.zeros(shape, np_float)
        zeros_b = lambda *shape: np.zeros(shape, bool)
        mk_bool = np.asarray
        scalar_f = lambda: np.zeros((), np_float)
        scalar_i = lambda: np.zeros((), np.int32)
        idx = lambda a: np.asarray(a, dtype=np.int32)
        ones_b = lambda k: np.ones(k, bool)
    else:
        f = lambda a: jnp.asarray(a, dtype=dtype)
        zeros_f = lambda *shape: jnp.zeros(shape, dtype)
        zeros_b = lambda *shape: jnp.zeros(shape, bool)
        mk_bool = jnp.asarray
        scalar_f = lambda: jnp.zeros((), dtype)
        scalar_i = lambda: jnp.zeros((), jnp.int32)
        idx = lambda a: jnp.asarray(a, dtype=jnp.int32)
        ones_b = lambda k: jnp.ones(k, bool)
    cluster = Cluster(
        pos=f(pos), vel=f(vel), mass=f(masses),
        m0=f(masses), mdot=f(mdot0),
        kicked=zeros_b(n_total),
        r_disk=f(r_disk), tau_disk=f(tau_disk),
        disk_alive=mk_bool(lm),
        m_disk_gas=f(0.1 * masses),               # al26_nbody.py:1545
        m_disk_dust=f(0.01 * 0.1 * masses),       # al26_nbody.py:1546
        mass_27al=f(cfg.mass_frac_27al * masses),  # al26_nbody.py:1555
        mass_56fe=f(cfg.mass_frac_56fe * masses),  # al26_nbody.py:1567
        slr=zeros_f(n_total, N_ISO, N_CH),
        slr_final=zeros_f(n_total, N_ISO, N_CH),
        agb_raw=zeros_f(n_total, N_ISO),
        wind_ratio=f(np.stack([ydata["wind_ratio_26al"],
                               ydata["wind_ratio_60fe"]], axis=-1)),
        sn_yield=f(np.stack([ydata["sn_yield_26al"],
                             ydata["sn_yield_60fe"]], axis=-1)),
        total_wind_loss=f(total_wind_loss),
        is_interloper=mk_bool(is_interloper),
    )
    state = SimState(
        cluster=cluster,
        time=scalar_f(),
        step_count=scalar_i(),
    )
    msrc_idx, msrc_valid = _mass_source_slots(cfg, masses, is_interloper)
    aux = SimAux(
        hm_idx=idx(hm_candidates),
        hm_slot_valid=mk_bool(hm_valid),
        msrc_idx=idx(msrc_idx),
        msrc_valid=mk_bool(msrc_valid),
        agb_grid_t=f(agb_grid_t),
        agb_grid_rates=f(agb_grid_rates),
        kick_vel=f(_draw_kicks(resolved, len(hm_candidates))),
        # NOT passed through f: the table keeps its computed precision
        # (f64 under x64) so evolve_from_table reproduces the per-step
        # evolve's promote-then-cast results bit-identically
        stellar_tbl=stellar.PhaseTable(*(
            (a if as_numpy else jnp.asarray(a))
            for a in _stellar_table(resolved, masses, dtype)
        )),
    )
    return state, aux, resolved
