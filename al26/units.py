"""Unit system for the cluster/SLR simulation.

Design stance (SURVEY.md §7): no runtime unit objects inside jit. The whole
simulation state lives in a single fixed internal convention,

    mass     -> solar masses  (Msun)
    length   -> parsec        (pc)
    time     -> megayear      (Myr)
    velocity -> pc / Myr

and conversion happens only at I/O boundaries (CLI flags, data tables,
checkpoints). This module holds the conversion constants plus a tiny
`Unit`/`Quantity` pair used by the host-side compatibility layer
(`al26.io.compat`) that mimics the `.value_in(unit)` API the reference's
AMUSE-based postprocessing expects (reference: al26_nbody.py:62-74 declares
the same aliases as AMUSE units).

Numeric values of the base constants follow the CODATA/IAU values used by the
reference's unit layer so converted quantities agree to full float64
precision (reference comments al26_nbody.py:64-74).
"""
from __future__ import annotations

from dataclasses import dataclass

# ---------------------------------------------------------------------------
# Base SI values of the units we care about (all floats, SI: kg, m, s)
# ---------------------------------------------------------------------------
KG_SI = 1.0
MSUN_SI = 1.98892e30             # kg, AMUSE units.MSun (1.9884099e33 g in ref comment)
YR_SI = 3.1556926e7              # s,  AMUSE units.yr
MYR_SI = 1.0e6 * YR_SI           # s
AU_SI = 1.495978707e11           # m,  AMUSE units.au
PC_SI = 3.0856775814913673e16    # m,  AMUSE units.parsec
KM_SI = 1.0e3                    # m
KMS_SI = 1.0e3                   # m/s

# Newton's constant, SI (CODATA 2006 value, as used by AMUSE constants.G)
G_SI = 6.67428e-11               # m^3 kg^-1 s^-2

# ---------------------------------------------------------------------------
# Internal unit system: (Msun, pc, Myr)
# ---------------------------------------------------------------------------
# G in pc^3 Msun^-1 Myr^-2
G_INTERNAL = G_SI * MSUN_SI * MYR_SI**2 / PC_SI**3

# velocity conversions
PCMYR_TO_KMS = PC_SI / MYR_SI / KMS_SI     # 1 pc/Myr in km/s  (~0.9778)
KMS_TO_PCMYR = 1.0 / PCMYR_TO_KMS

# length conversions
AU_TO_PC = AU_SI / PC_SI
PC_TO_AU = 1.0 / AU_TO_PC
PC_TO_KM = PC_SI / KM_SI

# mass conversions
MSUN_TO_KG = MSUN_SI
KG_TO_MSUN = 1.0 / MSUN_SI

# time conversions
MYR_TO_S = MYR_SI
S_TO_MYR = 1.0 / MYR_SI
MYR_TO_YR = 1.0e6

# mass-loss-rate conversions
MSUNYR_TO_MSUNMYR = 1.0e6        # Msun/yr -> Msun/Myr
MSUNMYR_TO_KGS = MSUN_SI / MYR_SI

# Decay constant: the reference hard-codes ln2 as 0.693147 (al26_nbody.py:1050)
LN2_REFERENCE = 0.693147


# ---------------------------------------------------------------------------
# Host-side unit objects (I/O boundary only — NEVER inside jit)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Unit:
    """A named unit with a conversion factor to SI base units.

    ``si_factor`` is the value of 1 of this unit expressed in SI
    (kg / m / s composites collapse to a single float because every unit we
    handle is a pure product of powers with a fixed exponent signature; we
    additionally record the signature to catch unit errors at the
    boundaries).
    """

    name: str
    si_factor: float
    # exponents (mass, length, time) — used only for sanity checks
    sig: tuple = (0, 0, 0)

    def __mul__(self, other: "Unit") -> "Unit":
        return Unit(
            f"{self.name}*{other.name}",
            self.si_factor * other.si_factor,
            tuple(a + b for a, b in zip(self.sig, other.sig)),
        )

    def __truediv__(self, other: "Unit") -> "Unit":
        return Unit(
            f"{self.name}/{other.name}",
            self.si_factor / other.si_factor,
            tuple(a - b for a, b in zip(self.sig, other.sig)),
        )

    def __pow__(self, p: int) -> "Unit":
        return Unit(
            f"{self.name}**{p}",
            self.si_factor**p,
            tuple(a * p for a in self.sig),
        )

    # numpy must DEFER on `ndarray | unit` so __ror__ builds ONE
    # Quantity(array) instead of an object ndarray of per-element
    # Quantities (the reference does exactly `array | units.kg`,
    # al26_plot.py:533,540)
    __array_ufunc__ = None

    def __ror__(self, value) -> "Quantity":
        """AMUSE's construction syntax ``value | unit`` (the reference
        builds quantities this way throughout, e.g. postprocess.py:100)."""
        return Quantity(value, self)


kg = Unit("kg", 1.0, (1, 0, 0))
msol = Unit("MSun", MSUN_SI, (1, 0, 0))
m = Unit("m", 1.0, (0, 1, 0))
km = Unit("km", KM_SI, (0, 1, 0))
au = Unit("au", AU_SI, (0, 1, 0))
pc = Unit("parsec", PC_SI, (0, 1, 0))
s = Unit("s", 1.0, (0, 0, 1))
yr = Unit("yr", YR_SI, (0, 0, 1))
myr = Unit("Myr", MYR_SI, (0, 0, 1))
kms = Unit("kms", KMS_SI, (0, 1, -1))
msolyr = Unit("MSun/yr", MSUN_SI / YR_SI, (1, 0, -1))
pcmyr = Unit("parsec/Myr", PC_SI / MYR_SI, (0, 1, -1))
msolmyr = Unit("MSun/Myr", MSUN_SI / MYR_SI, (1, 0, -1))


class Quantity:
    """Minimal unit-tagged value for the I/O boundary.

    Mirrors the subset of the AMUSE quantity API that the reference's
    post-processing relies on (``.value_in(unit)``, arithmetic, comparison;
    reference usage e.g. plotting/postprocess.py:79, plot_slr_statistics.py:43).
    Values may be scalars or numpy arrays.
    """

    __slots__ = ("value", "unit")

    def __init__(self, value, unit: Unit):
        self.value = value
        self.unit = unit

    def value_in(self, unit: Unit):
        if unit.sig != self.unit.sig:
            raise ValueError(
                f"Incompatible units: {self.unit.name} -> {unit.name}"
            )
        return self.value * (self.unit.si_factor / unit.si_factor)

    def in_(self, unit: Unit) -> "Quantity":
        return Quantity(self.value_in(unit), unit)

    # -- arithmetic -------------------------------------------------------
    def _coerce(self, other):
        if isinstance(other, Quantity):
            return other.value_in(self.unit)
        raise TypeError("Quantity arithmetic requires another Quantity")

    def __add__(self, other):
        return Quantity(self.value + self._coerce(other), self.unit)

    def __sub__(self, other):
        return Quantity(self.value - self._coerce(other), self.unit)

    def __mul__(self, other):
        if isinstance(other, Quantity):
            return Quantity(self.value * other.value, self.unit * other.unit)
        return Quantity(self.value * other, self.unit)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Quantity):
            if other.unit.sig == self.unit.sig:
                # dimensionless ratio
                return self.value / other.value_in(self.unit)
            return Quantity(self.value / other.value, self.unit / other.unit)
        return Quantity(self.value / other, self.unit)

    def __neg__(self):
        return Quantity(-self.value, self.unit)

    def __lt__(self, other):
        return self.value < self._coerce(other)

    def __le__(self, other):
        return self.value <= self._coerce(other)

    def __gt__(self, other):
        return self.value > self._coerce(other)

    def __ge__(self, other):
        return self.value >= self._coerce(other)

    def __eq__(self, other):
        try:
            return self.value == self._coerce(other)
        except (TypeError, ValueError):
            return NotImplemented

    def __getitem__(self, idx):
        return Quantity(self.value[idx], self.unit)

    def __len__(self):
        return len(self.value)

    def __repr__(self):
        return f"Quantity({self.value!r} | {self.unit.name})"

    def sum(self):
        return Quantity(self.value.sum(), self.unit)
