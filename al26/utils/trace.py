"""Reduce a `jax.profiler` trace to per-operation device times.

    with jax.profiler.trace(d):
        ...
    ops, window = device_op_times(d)

`ops` maps each operation name on the GPU planes to (count, total ns);
`window` is (first start, last end, busy ns) over those events, so the
idle share of the window is 1 - busy / (last end - first start).
"""
from __future__ import annotations

import glob
import os


def latest_xplane(trace_dir: str) -> str:
    files = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                   "*.xplane.pb"))
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    return max(files, key=os.path.getmtime)


def device_op_times(trace_dir: str, device_prefix: str = "/device:GPU"):
    from jax.profiler import ProfileData

    data = ProfileData.from_file(latest_xplane(trace_dir))
    ops: dict = {}
    spans = []
    for plane in data.planes:
        if not plane.name.startswith(device_prefix):
            continue
        for line in plane.lines:
            # the per-stream lines carry the kernels; the summary lines
            # ("XLA Modules", "XLA Ops", "Steps") would double count
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                cnt, tot = ops.get(ev.name, (0, 0))
                ops[ev.name] = (cnt + 1, tot + ev.duration_ns)
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not spans:
        return ops, (0, 0, 0)
    spans.sort()
    busy, cur_s, cur_e = 0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return ops, (spans[0][0], max(e for _, e in spans), busy)
