"""Hand-built AMUSE-format state pickle, for testing reference-file loading
WITHOUT AMUSE installed.

The reference pickles `State{cluster: amuse Particles, converter, metadata}`
(al26_nbody.py:281-293, 347-378). The classes below replicate AMUSE's real
module paths and instance layouts:

  amuse.datamodel.particles.Particles        _private.attribute_storage
  amuse.datamodel.memory.InMemoryAttributeStorage
      .mapping_from_attribute_to_quantities, .particle_keys
  amuse.datamodel.memory.InMemoryVectorQuantityAttribute  .name, .quantity
  amuse.datamodel.memory.InMemoryUnitlessAttribute        .name, .values
  amuse.units.quantities.{Scalar,Vector}Quantity  .unit, .number (__slots__)
  amuse.units.core.{base_unit, named_unit, factor_unit, mul_unit, div_unit,
      pow_unit}   (unit expression algebra)
  amuse.units.nbody_system.nbody_to_si       (opaque; stubbed on load)

`build_state_pickle` registers them under fake `amuse.*` / `al26_nbody`
modules ONLY while pickling, so the byte stream records the real AMUSE
class paths; the modules are removed afterwards, which forces loading to go
through `al26.io.compat`'s tolerant unpickler + graph miner — exactly
the situation with a genuine reference file on a machine without AMUSE.

To exercise the unit conversion for real, positions/velocities are stored
in SI (m, m/s) as the reference's nbody_to_si-converted sets are, masses in
MSun, disc lifetimes in Myr, and mdot in MSun/yr.
"""
from __future__ import annotations

import pickle
import sys
import types
from datetime import datetime

import numpy as np

from al26.units import MSUN_SI, MYR_SI, PC_SI, YR_SI

_AMUSE_MODULES = [
    "amuse", "amuse.datamodel", "amuse.datamodel.particles",
    "amuse.datamodel.base", "amuse.datamodel.memory", "amuse.units",
    "amuse.units.core", "amuse.units.quantities",
    "amuse.units.nbody_system", "al26_nbody",
]


def _make_class(module: str, name: str, slots=None):
    ns = {"__module__": module}
    if slots is not None:
        ns["__slots__"] = slots
    return type(name, (object,), ns)


def _build_classes():
    C = {}
    C["Particles"] = _make_class("amuse.datamodel.particles", "Particles")
    C["PrivateProperties"] = _make_class(
        "amuse.datamodel.particles", "PrivateProperties")
    C["CollectionAttributes"] = _make_class(
        "amuse.datamodel.base", "CollectionAttributes")
    C["InMemoryAttributeStorage"] = _make_class(
        "amuse.datamodel.memory", "InMemoryAttributeStorage")
    C["InMemoryVectorQuantityAttribute"] = _make_class(
        "amuse.datamodel.memory", "InMemoryVectorQuantityAttribute")
    C["InMemoryUnitlessAttribute"] = _make_class(
        "amuse.datamodel.memory", "InMemoryUnitlessAttribute")
    # real AMUSE quantities use __slots__ ('unit', 'number')
    C["ScalarQuantity"] = _make_class(
        "amuse.units.quantities", "ScalarQuantity", ("unit", "number"))
    C["VectorQuantity"] = _make_class(
        "amuse.units.quantities", "VectorQuantity", ("unit", "number"))
    for u in ("base_unit", "named_unit", "factor_unit", "mul_unit",
              "div_unit", "pow_unit"):
        C[u] = _make_class("amuse.units.core", u)
    C["nbody_to_si"] = _make_class("amuse.units.nbody_system", "nbody_to_si")
    C["State"] = _make_class("al26_nbody", "State")
    C["Metadata"] = _make_class("al26_nbody", "Metadata")
    return C


def _units(C):
    def base(quantity, name, symbol):
        u = C["base_unit"]()
        u.__dict__.update(quantity=quantity, name=name, symbol=symbol,
                          system="si")
        return u

    def factor(f, unit):
        u = C["factor_unit"]()
        u.__dict__.update(local_factor=f, local_unit=unit)
        return u

    def named(quantity, name, symbol, unit):
        u = C["named_unit"]()
        u.__dict__.update(quantity=quantity, name=name, symbol=symbol,
                          local_unit=unit)
        return u

    def div(lh, rh):
        u = C["div_unit"]()
        u.__dict__.update(left_hand=lh, right_hand=rh)
        return u

    m = base("length", "meter", "m")
    kg = base("mass", "kilogram", "kg")
    s = base("time", "second", "s")
    U = {"m": m, "kg": kg, "s": s}
    U["MSun"] = named("mass", "solar mass", "MSun", factor(MSUN_SI, kg))
    U["parsec"] = named("length", "parsec", "parsec", factor(PC_SI, m))
    U["yr"] = named("time", "year", "yr", factor(YR_SI, s))
    U["Myr"] = named("time", "million year", "Myr", factor(MYR_SI, s))
    U["m_per_s"] = div(m, s)
    U["MSun_per_yr"] = div(U["MSun"], U["yr"])
    return U


# column name -> (fixture storage unit key, factor FROM our canonical column
# convention (compat._UNIT_BY_ATTR) TO the fixture's storage unit)
def _storage_plan(U):
    return {
        "mass": ("MSun", 1.0), "initial_mass": ("MSun", 1.0),
        "x": ("m", PC_SI), "y": ("m", PC_SI), "z": ("m", PC_SI),
        "vx": ("m_per_s", PC_SI / MYR_SI),
        "vy": ("m_per_s", PC_SI / MYR_SI),
        "vz": ("m_per_s", PC_SI / MYR_SI),
        "mdot": ("MSun_per_yr", 1.0e-6),       # MSun/Myr -> MSun/yr
        "r_disk": ("m", PC_SI), "tau_disk": ("Myr", 1.0),
        "m_disk_gas": ("MSun", 1.0), "m_disk_dust": ("MSun", 1.0),
        "mass_27al": ("MSun", 1.0), "mass_56fe": ("MSun", 1.0),
        "total_wind_loss": ("MSun", 1.0),
        "radius": ("m", PC_SI),
    }


def build_state_pickle(columns: dict[str, np.ndarray], n: int, rc: float,
                       time_myr: float, t_f_myr: float,
                       filename: str, key_seed: int = 0,
                       now: "datetime | None" = None) -> bytes:
    """Pickle a reference-layout State whose cluster carries `columns`
    (given in OUR canonical column units, compat._UNIT_BY_ATTR).
    `key_seed` seeds the AMUSE-style random uint64 particle keys; `now`
    pins the metadata timestamps (the checked-in binary fixture needs a
    reproducible byte stream, scripts/gen_amuse_fixture.py)."""
    C = _build_classes()
    U = _units(C)
    plan = _storage_plan(U)

    mapping = {}
    for name, values in columns.items():
        values = np.asarray(values)
        if name == "key":
            continue
        if name in plan:
            ukey, f = plan[name]
            q = C["VectorQuantity"]()
            q.unit = U[ukey]
            q.number = values * f
            attr = C["InMemoryVectorQuantityAttribute"]()
            attr.__dict__.update(name=name, quantity=q)
        elif name.startswith("mass_") or name.startswith("wind_yield") or \
                name.startswith("sn_yield"):
            q = C["VectorQuantity"]()
            q.unit = U["MSun"]
            q.number = values
            attr = C["InMemoryVectorQuantityAttribute"]()
            attr.__dict__.update(name=name, quantity=q)
        else:
            attr = C["InMemoryUnitlessAttribute"]()
            attr.__dict__.update(name=name, values=values)
        mapping[name] = attr

    # AMUSE draws random uint64 particle keys
    # (amuse.datamodel.base.UniqueKeyGenerator); replicate unless the
    # caller pinned a key column, plus the storage's sorted-key ancillary
    # arrays real InMemoryAttributeStorage instances carry
    keys = np.asarray(columns.get(
        "key",
        np.random.default_rng(key_seed).integers(1, 2**63, n,
                                                 dtype=np.uint64),
    ))
    order = np.argsort(keys)
    storage = C["InMemoryAttributeStorage"]()
    storage.__dict__.update(
        mapping_from_attribute_to_quantities=mapping,
        particle_keys=keys,
        sorted_keys=keys[order],
        sorted_indices=order.astype(np.int64),
        index_array=np.arange(n, dtype=np.int64),
        keys_set=set(keys.tolist()),
        __version__=2,
    )
    coll = C["CollectionAttributes"]()
    coll.__dict__.update(_attributes={})
    private = C["PrivateProperties"]()
    private.__dict__.update(attribute_storage=storage, version=2,
                            timestamp=None, previous=None,
                            collection_attributes=coll)
    cluster = C["Particles"]()
    cluster.__dict__.update(_private=private)

    import argparse
    args = argparse.Namespace(
        n=n, rc=rc, model="plummer", fractal_dimension=2.0,
        disk_radius=100.0, final_time=t_f_myr, filename=filename,
        reload=None, n_checkpoint=None, verbose=False,
        star_min_mass=0.01, star_max_mass=150.0,
        no_massive_star_requirement=False, adaptive_timestep=False,
        interloper=False,
    )
    md = C["Metadata"]()
    tq = C["ScalarQuantity"]()
    tq.unit = U["Myr"]
    tq.number = time_myr
    tfq = C["ScalarQuantity"]()
    tfq.unit = U["Myr"]
    tfq.number = t_f_myr
    now = now or datetime.now()
    md.__dict__.update(
        sim_start=now, sim_start_str=now.strftime("%d/%m/%Y %H:%M:%S"),
        sim_last=now, sim_last_str=now.strftime("%d/%m/%Y %H:%M:%S"),
        args=args, model="plummer", nstars=n, cluster_radius=rc,
        filename=filename, time=tq, t_f=tfq,
        completion=time_myr / t_f_myr,
        most_recent_checkpoint=int(round(time_myr / t_f_myr * 100)),
    )
    conv = C["nbody_to_si"]()
    # real nbody_to_si converters record their two defining SI quantities
    # (total mass, length scale); the loader treats the converter as
    # opaque but the stream should carry the genuine shape
    m_tot = C["ScalarQuantity"]()
    m_tot.unit = U["kg"]
    m_tot.number = float(np.asarray(columns["mass"]).sum()) * MSUN_SI
    l_scale = C["ScalarQuantity"]()
    l_scale.unit = U["m"]
    l_scale.number = rc * PC_SI
    conv.__dict__.update(value1=m_tot, value2=l_scale)
    state = C["State"]()
    state.__dict__.update(cluster=cluster, converter=conv, metadata=md)

    # register fake amuse modules ONLY for the dump
    saved = {}
    try:
        for mod in _AMUSE_MODULES:
            saved[mod] = sys.modules.get(mod)
            mobj = types.ModuleType(mod)
            sys.modules[mod] = mobj
        for cls in C.values():
            sys.modules[cls.__module__].__dict__[cls.__name__] = cls
        return pickle.dumps(state, protocol=2)
    finally:
        for mod, prev in saved.items():
            if prev is None:
                sys.modules.pop(mod, None)
            else:
                sys.modules[mod] = prev
