"""al26: star-cluster N-body + SLR disc-enrichment framework on accelerators.

A ground-up JAX/XLA/Pallas re-design of the capabilities of
jweatson/26al-nbody (see SURVEY.md): direct N-body dynamics of young star
clusters coupled to stellar evolution and short-lived-radioisotope
(26Al/60Fe) enrichment of protoplanetary discs, with reference-compatible
checkpoint formats, ensembles via vmap and multi-device scaling via
jax.sharding.
"""
__version__ = "0.1.0"

from .config import SimConfig
from .state import Cluster, SimState
