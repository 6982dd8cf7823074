"""Shared helpers for the stellar-model calibration modules.

Single source for the package data root (al26/data, holding the
shipped LC18 raw tables, SeBa event dumps and AGB wind tables these
modules calibrate on at import) and the one interpolation convention
they all use: log-log linear between anchors, clamped at the grid ends
(replacing a copy of the same expression in evolution, lc18_anchors,
seba_anchors and agb_calibration each).
"""
from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np

# al26/data — this file lives at al26/models/stellar/common.py
DATA_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "data",
)


def loglog_interp(m0, log_m, log_y):
    """exp(interp(log m0)) over (log_m, log_y) anchors, clamped to the
    grid ends. jnp or numpy input; anchors are host-side numpy arrays
    (converted at trace time, so this is jit/vmap-safe).

    The linear-space clip is NOT redundant with jnp.interp's own
    end-clamping: it also sanitizes nonpositive m0 (a padded zero-mass
    slot evaluated under a mask would otherwise take log(0) = -inf or
    log(<0) = nan, and a nan survives the masking arithmetic). Its
    exp/log round-trip of the endpoints is inexact by 1 ulp, but the
    subsequent interp clamps out-of-grid x to the endpoint VALUES, so
    results on the current grids are bit-identical to clamping in log
    space (verified in the round-4 dedup review)."""
    x = jnp.log(jnp.clip(m0, np.exp(log_m[0]), np.exp(log_m[-1])))
    return jnp.exp(jnp.interp(x, jnp.asarray(log_m), jnp.asarray(log_y)))
