"""The one precision policy for f32 contractions (ops.backend.einsum):
every dot in a lowered step asks for HIGHEST, so none can run in TF32 on
the GPU (about three decimal digits). Lowering happens on the CPU; the
StableHLO records the requested precision whatever the backend."""
import re

import jax
import pytest

from al26.config import SimConfig
from al26.sim import init_cluster


def _dots(text: str):
    return [ln for ln in text.splitlines()
            if re.search(r"stablehlo\.dot(_general)?\b", ln)]


def _assert_highest(lowered) -> None:
    dots = _dots(lowered.as_text())
    assert dots, "expected contractions in the lowered step"
    loose = [d for d in dots if d.count("HIGHEST") < 2]
    assert not loose, "dots without HIGHEST precision:\n" + "\n".join(
        d.strip()[:200] for d in loose[:5])


@pytest.mark.parametrize("kw,force_impl", [
    (dict(n=64), "auto"),                                   # hermite4
    (dict(n=64, integrator="leapfrog"), "auto"),
    (dict(n=256, integrator="hermite4_block", k_fast=32), "pallas"),
    (dict(n=256, force_impl="tree", tree_leaf=32), "tree"),
])
def test_lowered_step_dots_are_highest(kw, force_impl):
    from al26.sim.step import run_steps

    cfg = SimConfig(rc=1.0, final_time=1.0, seed=3, dtype="f32", **kw)
    state, aux, cfg = init_cluster(cfg)
    with jax.enable_x64(False):
        lowered = run_steps.trace(state, aux, cfg, 2,
                                  force_impl=force_impl).lower()
    _assert_highest(lowered)


def test_lowered_ensemble_step_dots_are_highest():
    from al26.parallel.ensemble import ensemble_run_steps, init_ensemble

    cfg = SimConfig(n=32, rc=1.0, final_time=1.0, seed=4, dtype="f32",
                    no_massive_star_requirement=True)
    bs, ba, cfgs = init_ensemble(cfg, 2)
    lowered = ensemble_run_steps.trace(bs, ba, cfgs[0], 2, flat=True).lower()
    _assert_highest(lowered)
