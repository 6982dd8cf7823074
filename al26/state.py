"""Cluster state pytree.

The reference stores ~30 per-star attributes on an AMUSE particle set
(al26_nbody.py:1540-1604) spread across three mirrored particle containers
(cluster / gravity / stellar) that are synchronised through channels each step
(al26_nbody.py:871-876). Here the whole simulation state is ONE pytree of
fixed-shape arrays (SoA) that lives on device; there is nothing to
synchronise and the entire step is a single jitted program.

Layout conventions:
  * isotope axis  (S=2): 0 = 26Al, 1 = 60Fe
  * channel axis  (C=4): 0 = local wind, 1 = global wind, 2 = SNe, 3 = AGB
  * units: Msun / pc / Myr everywhere (see al26.units)

Dead stars / discs / empty slots are represented by masks — shapes never
change under jit.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

# isotope indices
ISO_26AL = 0
ISO_60FE = 1
N_ISO = 2

# channel indices
CH_LOCAL = 0
CH_GLOBAL = 1
CH_SNE = 2
CH_AGB = 3
N_CH = 4

CHANNEL_NAMES = ("local", "global", "sne", "agb")
ISO_NAMES = ("26al", "60fe")


@jax.tree_util.register_dataclass
@dataclass
class Cluster:
    """Per-star state. All arrays have leading dimension N (stars).

    An optional leading ensemble axis can be added with vmap — every op in
    al26 is written to be vmappable over whole clusters (SURVEY.md §2c
    item 4: ensemble Monte-Carlo is the dominant parallel axis).
    """

    # -- dynamics ----------------------------------------------------------
    pos: jax.Array            # [N,3] pc
    vel: jax.Array            # [N,3] pc/Myr
    mass: jax.Array           # [N]   Msun (current — drops with wind loss/SN)
    # -- stellar evolution -------------------------------------------------
    m0: jax.Array             # [N]   Msun initial mass (track lookup key)
    mdot: jax.Array           # [N]   Msun/Myr wind mass-loss rate (>=0)
    kicked: jax.Array         # [N]   bool: SN already processed (al26:1543)
    # -- discs -------------------------------------------------------------
    r_disk: jax.Array         # [N]   pc
    tau_disk: jax.Array       # [N]   Myr, pre-drawn disc lifetime
    disk_alive: jax.Array     # [N]   bool
    m_disk_gas: jax.Array     # [N]   Msun (0.1 * m,  al26:1545)
    m_disk_dust: jax.Array    # [N]   Msun (0.01 * gas, al26:1546)
    # -- stable isotopes ---------------------------------------------------
    mass_27al: jax.Array      # [N]   Msun (8.5e-6 m, al26:1555)
    mass_56fe: jax.Array      # [N]   Msun (1.828e-4 m, al26:1567)
    # -- SLR reservoirs ----------------------------------------------------
    slr: jax.Array            # [N,S,C]  Msun, decaying accumulators
    slr_final: jax.Array      # [N,S,C]  Msun, snapshot at disc death
    agb_raw: jax.Array        # [N,S]    Msun, AGB channel without decay
    # -- per-star yield data (set at init for massive stars) ----------------
    wind_ratio: jax.Array     # [N,S]  dimensionless SLR fraction of wind
    sn_yield: jax.Array       # [N,S]  Msun instantaneous SN SLR yield
    total_wind_loss: jax.Array  # [N]  Msun (m0 - m_remnant, al26:467-493)
    # -- flags ---------------------------------------------------------
    is_interloper: jax.Array  # [N] bool

    @property
    def n(self) -> int:
        return self.pos.shape[-2]

    # -- mass-class masks (al26_nbody.py:1194-1216) -----------------------
    def high_mass_mask(self, threshold: float = 13.0) -> jax.Array:
        """CURRENT-mass classification (the reference's
        get_high_mass_star_indices rule, al26_nbody.py:1194-1216). NOTE:
        the step does NOT use this for wind/SN source validity — that is
        INITIAL-mass (m0) based via SimAux.hm_slot_valid, so a 13-14 Msun
        star keeps its sources after winds push it below threshold
        (sim/step.py; sn_parity_mode restores the current-mass rule)."""
        return self.mass >= threshold

    def low_mass_mask(self, lo: float = 0.1, hi: float = 3.0) -> jax.Array:
        return (self.mass >= lo) & (self.mass <= hi) & ~self.is_interloper

    def replace(self, **kw) -> "Cluster":
        return dataclasses.replace(self, **kw)


@jax.tree_util.register_dataclass
@dataclass
class SimState:
    """Full simulation state advanced by one jitted `step`."""

    cluster: Cluster
    time: jax.Array           # scalar, Myr
    step_count: jax.Array     # scalar int32

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)


def empty_cluster(n: int, dtype=jnp.float64) -> Cluster:
    """Allocate a zeroed cluster of n stars."""
    f = lambda *shape: jnp.zeros(shape, dtype=dtype)
    b = lambda *shape: jnp.zeros(shape, dtype=bool)
    return Cluster(
        pos=f(n, 3), vel=f(n, 3), mass=f(n),
        m0=f(n), mdot=f(n), kicked=b(n),
        r_disk=f(n), tau_disk=f(n), disk_alive=b(n),
        m_disk_gas=f(n), m_disk_dust=f(n),
        mass_27al=f(n), mass_56fe=f(n),
        slr=f(n, N_ISO, N_CH), slr_final=f(n, N_ISO, N_CH),
        agb_raw=f(n, N_ISO),
        wind_ratio=f(n, N_ISO), sn_yield=f(n, N_ISO),
        total_wind_loss=f(n),
        is_interloper=b(n),
    )


def cluster_to_numpy(c: Cluster) -> dict:
    """Pull a cluster to host as a dict of numpy arrays (I/O boundary).

    Uses ONE batched device_get: per-field np.asarray would issue ~45
    sequential device->host transfers, each with its own latency."""
    host = jax.device_get(c)
    return {
        fld.name: np.asarray(getattr(host, fld.name))
        for fld in dataclasses.fields(c)
    }


def cluster_from_numpy(d: dict, dtype=jnp.float64) -> Cluster:
    kw = {}
    for fld in dataclasses.fields(Cluster):
        a = np.asarray(d[fld.name])
        if a.dtype == np.bool_:
            kw[fld.name] = jnp.asarray(a)
        else:
            kw[fld.name] = jnp.asarray(a, dtype=dtype)
    return Cluster(**kw)
