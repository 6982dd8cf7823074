"""Async checkpoint writer: ordering, error propagation, and end-to-end
equivalence with synchronous saves (the reference's inline save path,
al26_nbody.py:347-401)."""
import hashlib
import os
import threading
import time

import pytest

from al26.io.async_writer import AsyncCheckpointWriter


def test_jobs_run_in_submission_order():
    seen = []
    ev = threading.Event()

    with AsyncCheckpointWriter() as w:
        def slow():
            ev.wait(5.0)
            seen.append(0)

        w.submit(slow)
        for k in range(1, 20):
            w.submit(lambda k=k: seen.append(k))
        ev.set()
        w.flush()
    assert seen == list(range(20))


def test_error_reraised_on_driver_thread():
    w = AsyncCheckpointWriter()

    def boom():
        raise ValueError("disc full")

    w.submit(boom)
    with pytest.raises(RuntimeError, match="checkpoint save failed"):
        # the failure surfaces at the next interaction, not silently
        for _ in range(100):
            w.flush()
            time.sleep(0.01)
    # after re-raise the writer is usable again and close() is clean
    w.submit(lambda: None)
    w.close()


def test_failure_skips_later_jobs():
    ran = []
    w = AsyncCheckpointWriter()
    w.submit(lambda: (_ for _ in ()).throw(IOError("x")))
    w.submit(lambda: ran.append(1))
    with pytest.raises(RuntimeError):
        w.close()
    assert ran == []  # a save after a failed save must not run out of order


def _digest_dir(path, skip_substr=None):
    out = {}
    for name in sorted(os.listdir(path)):
        p = os.path.join(path, name)
        if os.path.isfile(p):
            with open(p, "rb") as f:
                data = f.read()
            out[name] = hashlib.sha256(data).hexdigest()
    return out


@pytest.mark.slow
def test_async_and_sync_runs_write_identical_files(tmp_path):
    """End-to-end: the background writer must be invisible in the output —
    same files, same bytes — modulo the pickled Metadata timestamps, so
    compare the deterministic artifacts (yields + CSV) byte-for-byte and
    the state-file SET by name."""
    from al26.config import SimConfig
    from al26.sim.driver import run

    outs = {}
    for mode, async_on in (("async", True), ("sync", False)):
        d = tmp_path / mode
        d.mkdir()
        cwd = os.getcwd()
        os.chdir(d)
        try:
            cfg = SimConfig(n=32, rc=0.5, final_time=0.5, seed=5,
                            filename="run", n_plot=5, steps_per_plot=4,
                            async_saves=async_on)
            run(cfg, progress=False)
        finally:
            os.chdir(cwd)
        outs[mode] = _digest_dir(d)
    assert set(outs["async"]) == set(outs["sync"])
    for name in outs["async"]:
        if "-state-" in name:
            continue  # pickled Metadata embeds wall-clock timestamps
        assert outs["async"][name] == outs["sync"][name], name


def test_drain_gate_survives_reraise():
    """Jobs queued in the FAILED epoch never run, even after the failure
    was re-raised: the old `_error is None` drain gate was cleared by
    _reraise while same-epoch jobs could still be queued, letting a save
    land on top of a torn checkpoint (round-3 review finding). New-epoch
    jobs still run — the writer stays usable."""
    ran = []
    w = AsyncCheckpointWriter()
    # simulate the instant after a job of epoch 0 failed, with another
    # epoch-0 job still queued (bypassing submit, which would re-raise)
    w._error = IOError("x")
    w._bad_epoch = 0
    w._q.put((0, lambda: ran.append(1)))
    with pytest.raises(RuntimeError, match="checkpoint save failed"):
        w.flush()
    w.submit(lambda: ran.append(2))  # fresh epoch: runs
    w.close()
    assert ran == [2]
