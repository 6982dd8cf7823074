"""Orbax checkpoint backend for sharded device state.

The reference's checkpoints (pickle+zstd State files, al26_nbody.py:347-439)
and our reference-format writers (io.checkpoint) are HOST-side formats: the
full cluster is gathered to one process and pickled. That is right for the
post-processing pipeline, but on a multi-host device mesh a row-sharded
SimState would have to be all-gathered through one host first — O(N) data
funnelled through a single machine per save.

This module adds an orbax-backed device-state checkpoint as an ADDITIONAL
backend for mesh-sharded runs (SimConfig.orbax_dir): every host writes its
own shards (orbax/tensorstore OCDBT), nothing is gathered, and restore
re-shards directly onto the target mesh. The reference-format files keep
being written by the driver for the analysis pipeline; the orbax tree is
the fast resume path for the large sharded runs.

Layout per save:  <orbax_dir>/<step>/  (orbax StandardCheckpointer tree
holding the SimState pytree) + <orbax_dir>/<step>.cfg.json (the resolved
SimConfig — JSON, since orbax stores array leaves only).
"""
from __future__ import annotations

import json
import os
from typing import Optional

import jax


def _checkpointer():
    import orbax.checkpoint as ocp

    return ocp.StandardCheckpointer()


def _path(orbax_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(orbax_dir), str(step))


def save_sharded_state(orbax_dir: str, step: int, state, cfg) -> None:
    """Write the (possibly sharded) SimState without gathering: each
    process stores the shards it owns. The resolved config goes into a
    JSON sidecar next to the tree."""
    ckptr = _checkpointer()
    ckptr.save(_path(orbax_dir, step), state, force=True)
    ckptr.wait_until_finished()
    if jax.process_index() == 0:
        d = {k: (list(v) if isinstance(v, tuple) else v)
             for k, v in cfg.to_dict().items()}
        # atomic: the sidecar is the step's completeness marker —
        # latest_step skips steps without one, so a crash between the
        # tree finalisation and this write cannot brick the next resume
        sidecar = _path(orbax_dir, step) + ".cfg.json"
        with open(sidecar + ".tmp", "w") as f:
            json.dump(d, f)
        os.replace(sidecar + ".tmp", sidecar)


def latest_step(orbax_dir: str) -> Optional[int]:
    """Highest step with a COMPLETE save (tree + cfg sidecar)."""
    if not os.path.isdir(orbax_dir):
        return None
    steps = [int(d) for d in os.listdir(orbax_dir)
             if d.isdigit()
             and os.path.exists(os.path.join(orbax_dir, d + ".cfg.json"))]
    return max(steps) if steps else None


def drop_steps_above(orbax_dir: str, step: int) -> None:
    """Delete orbax steps above `step` — the orbax analogue of the
    driver's _drop_stale_state_files: a -nc resume rewrites the timeline,
    and a later latest_step must not pick the abandoned one."""
    import shutil

    if not os.path.isdir(orbax_dir):
        return
    for d in os.listdir(orbax_dir):
        name = d[:-len(".cfg.json")] if d.endswith(".cfg.json") else d
        if name.isdigit() and int(name) > step:
            p = os.path.join(orbax_dir, d)
            shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)


def load_sharded_state(orbax_dir: str, step: Optional[int] = None,
                       template=None):
    """Restore (state, cfg_dict). With `template` (an abstract or concrete
    SimState pytree carrying the target shardings — e.g. the freshly
    initialised state already laid out over the target mesh), arrays
    restore DIRECTLY onto those shardings, never materialising on one
    host. Without a template the restore is host-materialised."""
    import orbax.checkpoint as ocp

    if step is None:
        step = latest_step(orbax_dir)
        if step is None:
            raise IOError(f"no orbax checkpoints under {orbax_dir!r}")
    ckptr = _checkpointer()
    if template is None:
        state = ckptr.restore(_path(orbax_dir, step))
    else:
        target = jax.tree.map(ocp.utils.to_shape_dtype_struct, template)
        state = ckptr.restore(_path(orbax_dir, step), target)
    with open(_path(orbax_dir, step) + ".cfg.json") as f:
        cfg_dict = json.load(f)
    if isinstance(cfg_dict.get("mesh_shape"), list):
        cfg_dict["mesh_shape"] = tuple(cfg_dict["mesh_shape"])
    return state, cfg_dict, step
