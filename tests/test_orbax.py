"""Orbax device-state checkpoint backend (io/orbax_backend.py): sharded
save/restore without gathering, driver integration, resume continuation."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from al26.config import SimConfig
from al26.io.orbax_backend import (
    latest_step, load_sharded_state, save_sharded_state,
)
from al26.sim import init_cluster
from al26.sim.step import run_steps


def test_sharded_roundtrip_preserves_values_and_sharding(tmp_path):
    from al26.parallel.sharded import make_mesh, shard_state_rows

    cfg = SimConfig(n=64, rc=0.5, seed=3, no_massive_star_requirement=True)
    state, aux, cfg = init_cluster(cfg)
    mesh = make_mesh(4)
    state = shard_state_rows(state, mesh)
    save_sharded_state(str(tmp_path / "ck"), 7, state, cfg)
    assert latest_step(str(tmp_path / "ck")) == 7

    restored, cfg_dict, step = load_sharded_state(
        str(tmp_path / "ck"), template=state
    )
    assert step == 7
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                   np.asarray(b)),
        state, restored,
    )
    # restored ONTO the template's shardings (no host gather)
    assert restored.cluster.pos.sharding == state.cluster.pos.sharding
    # config round-trips through the leaf encoding (None/str/tuple/scalars)
    cfg2 = SimConfig.from_dict(cfg_dict)
    assert cfg2 == cfg


def test_driver_writes_orbax_tree_and_restore_matches_final(tmp_path):
    from al26.sim.driver import run

    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        cfg = SimConfig(n=32, rc=0.5, final_time=0.5, seed=5,
                        filename="orun", n_plot=5, steps_per_plot=4,
                        orbax_dir=str(tmp_path / "orbax"))
        res = run(cfg, progress=False)
    finally:
        os.chdir(cwd)
    # saves land after steps 1, 5, 9, 13, 17, 20(final)
    steps = sorted(int(d) for d in os.listdir(tmp_path / "orbax")
                   if d.isdigit())
    assert steps[0] == 1 and steps[-1] == cfg.n_steps and len(steps) == 6
    template = jax.tree.map(lambda x: x, res.state)
    restored, cfg_dict, _ = load_sharded_state(str(tmp_path / "orbax"),
                                               template=template)
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                   np.asarray(b)),
        res.state, restored,
    )


def test_orbax_resume_continues_bitwise(tmp_path):
    """Restore a mid-run device state and scan the remaining steps: must
    land bitwise on the uninterrupted final state (same programs, same
    operands — the orbax tree stores the exact device arrays)."""
    from al26.sim.driver import run

    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        cfg = SimConfig(n=32, rc=0.5, final_time=0.5, seed=6,
                        filename="orun2", n_plot=5, steps_per_plot=4,
                        orbax_dir=str(tmp_path / "orbax2"))
        res = run(cfg, progress=False)
        state0, aux, cfg_r = init_cluster(cfg)
        mid, cfg_dict, step = load_sharded_state(
            str(tmp_path / "orbax2"), step=9, template=state0
        )
        assert int(mid.step_count) == 9
        cfg2 = SimConfig.from_dict(cfg_dict)
        assert cfg2 == cfg_r  # resolved config stored alongside the state
        out = mid
        # driver chunking from step 9: 1 step (save), 3, then 1+3, ... —
        # run_steps without a cache on CPU is chunk-size independent
        out = run_steps(out, aux, cfg2, cfg2.n_steps - 9)
        np.testing.assert_array_equal(np.asarray(out.cluster.pos),
                                      np.asarray(res.state.cluster.pos))
        # deposition sums fuse differently between the driver's 1+3-step
        # chunk programs and the single 11-step scan: last-bit only
        np.testing.assert_allclose(np.asarray(out.cluster.slr),
                                   np.asarray(res.state.cluster.slr),
                                   rtol=1e-12, atol=1e-33)
    finally:
        os.chdir(cwd)


def test_missing_tree_raises(tmp_path):
    with pytest.raises(IOError, match="no orbax checkpoints"):
        load_sharded_state(str(tmp_path / "nope"))
