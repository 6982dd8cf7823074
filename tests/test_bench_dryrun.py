"""Dry-run the bench's multi-device branches on the fake 8-device CPU
mesh, so the 2-D ensemble bench is exercised before real devices run
it. bench.py is phase-based (every measurement a timeout-bounded
subprocess); the phase FUNCTIONS are exercised here in-process at toy
sizes."""
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def test_bench_ensemble_2d_dryruns_on_fake_mesh():
    import jax

    assert len(jax.devices()) == 8  # conftest's fake CPU mesh
    import bench

    out = bench.phase_ensemble2d(n=128, steps=3)
    assert out["s_per_myr"] > 0.0


# slow lane (round-5 re-tier): sharded headline phase dryrun (the worker-protocol and 2-D phase dryruns stay default)
@pytest.mark.slow
def test_bench_headline_sharded_dryruns_on_fake_mesh():
    import bench

    out = bench.phase_headline(n=512)
    assert out["gpairs"] > 0.0 and out["ndev"] == 8


def test_bench_worker_phase_protocol(capsys):
    # the orchestrator's contract: a worker phase prints ONE RESULT line
    # of JSON on stdout — and a worker that finds no GPU exits non-zero
    # before measuring anything
    import json

    import bench

    with pytest.raises(SystemExit) as exc:
        bench.run_worker(["ensemble", "n_real=8", "n=64", "steps=2"])
    assert exc.value.code not in (None, 0)
    assert "RESULT " not in capsys.readouterr().out
    bench.print_result(["ensemble", "n_real=8", "n=64", "steps=2"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("RESULT ")]
    assert len(lines) == 1
    out = json.loads(lines[0][len("RESULT "):])
    assert out["s_per_myr"] > 0.0
