"""Calibrate the SeBa main-sequence wind TIMING from the reference's own
shipped figures into al26/data/seba/wind-shape.csv.

The reference repo commits `limongi-2006.tar.gz`, which besides the
binev.data event log (scripts/gen_seba_anchors.py) contains the VECTOR
figure `cumulative_yield.pdf` produced by the tarball's own `yield.py`:
for each star of the [20, 30, 40, 50, 60] Msun SeBa grid it plots the
cumulative 26Al wind release

    y(t) = integral_0^t |wind_mass_loss_rate(tau)| * wind_ratio  d tau

sampled at 1000 times over 0-10 Myr, straight from a live SeBa run —
i.e. the actual ṁ(t) SHAPE of the stellar-evolution code the reference
consumed per step (al26_nbody.py:886-895), encoded as plot polylines.
The wind_ratio factor is constant per star (Al26WindRatio(m0) in
yield.py), so each curve is the star's cumulative WIND MASS loss up to
normalisation. This script recovers the curves from the PDF's vector
path data:

  * content stream 0 holds the axes + curves; curve paths are stroked
    polylines colour-coded with matplotlib's default cycle (C0..C4 in
    grid-mass order — the committed figure predates the 70/80 Msun grid
    extension visible in the shipped yield.py);
  * tick MARKS (3.5 pt stubs off the axes spines) calibrate the axes:
    x ticks are 0..10 Myr (yield.py's tr grid), y ticks are the decades
    of the script's explicit ylim (1e-10, 2e-4);
  * the recovered collapse times (each curve's last point — yield.py
    truncates when the cumulative stops growing, i.e. at SN) match the
    binev.data event times (seba_anchors) to < 1%, which validates the
    whole calibration end-to-end.

From each curve it derives the quantities models.stellar.evolution uses
to shape the MS wind (round 5, VERDICT r4 item 3):

  tau_knee — the MS/post-MS boundary as a fraction of the collapse
      time: the point where the release rate jumps by >~ an order of
      magnitude (SeBa's giant-branch wind taking over);
  ms_frac  — fraction of the LIFETIME wind release shed before the
      knee (measured 0.03-0.12: far below the 0.5 budget cap the
      round-4 model allowed the seba family);
  ramp_c   — the within-MS rate rise: fitting the one-parameter
      monotone ramp  rate(tau) ∝ 1 + c * tau/tau_knee  to the MS
      segment (c ~ 1-3: SeBa's MS rate roughly doubles-to-triples from
      ZAMS to TAMS as L(t) grows — NOT flat);
  q25/q50/q75 — within-MS cumulative release quantile positions (the
      tau/tau_knee at which 25/50/75% of the MS release is reached),
      pinned by tests/test_stellar_yields.py against the model.

Usage: python scripts/gen_wind_shape.py [--reference PATH] [--check]
  --check: re-derive and diff against the shipped CSV instead of writing.
"""
from __future__ import annotations

import argparse
import io
import os
import re
import tarfile
import zlib

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_TARBALL = "/root/reference/limongi-2006.tar.gz"
MEMBER = "limongi-chieffi-2006/cumulative_yield.pdf"
OUT = os.path.join(REPO, "al26", "data", "seba", "wind-shape.csv")

# matplotlib default prop cycle, in yield.py's massr order
CYCLE = {
    (0.122, 0.467, 0.706): 20.0,
    (1.0, 0.498, 0.055): 30.0,
    (0.173, 0.627, 0.173): 40.0,
    (0.839, 0.153, 0.157): 50.0,
    (0.58, 0.404, 0.741): 60.0,
}

HEADER = "m0,t_end_myr,tau_knee,ms_frac,ramp_c,q25,q50,q75\n"


def _content_stream(pdf: bytes) -> str:
    """First (page content) stream of the single-page matplotlib PDF,
    whitespace-normalised."""
    streams = re.findall(rb"stream\r?\n(.*?)endstream", pdf, re.S)
    return " ".join(zlib.decompress(streams[0]).decode("latin1").split())


def _paths_and_ticks(content: str):
    """Stroked polylines [(rgb, [N,2] points)] plus the x/y tick-mark
    coordinates (3.5 pt stubs: vertical off the bottom spine, horizontal
    off the left spine)."""
    toks = content.split(" ")
    paths, cur, col = [], [], None
    for i, t in enumerate(toks):
        if t == "m" and i >= 2:
            if len(cur) > 1:
                paths.append((col, np.asarray(cur)))
            cur = [(float(toks[i - 2]), float(toks[i - 1]))]
        elif t == "l" and i >= 2:
            cur.append((float(toks[i - 2]), float(toks[i - 1])))
        elif t == "RG" and i >= 3:
            col = tuple(round(float(x), 3) for x in toks[i - 3:i])
        elif t in ("S", "B", "f", "F"):
            if len(cur) > 1:
                paths.append((col, np.asarray(cur)))
            cur = []
    ticks_x, ticks_y = [], []
    for _, p in paths:
        if len(p) == 2:
            if abs(p[0, 0] - p[1, 0]) < 1e-9 and abs(
                    (p[0, 1] - p[1, 1]) - 3.5) < 0.1:
                ticks_x.append(p[0, 0])
            if abs(p[0, 1] - p[1, 1]) < 1e-9 and abs(
                    (p[0, 0] - p[1, 0]) - 3.5) < 0.1:
                ticks_y.append(p[0, 1])
    return paths, sorted(set(ticks_x)), sorted(set(ticks_y))


def _fit_ramp(tau_ms: np.ndarray, f_ms: np.ndarray) -> float:
    """One-parameter monotone MS ramp rate(u) ∝ 1 + c u on u = tau/tau_knee
    in [0, 1]: cumulative F(u) = (u + c u^2/2) / (1 + c/2). Least-squares
    over a c grid (the curve is smooth; a 1-D scan is exact enough and
    has no convergence knobs)."""
    grid = np.linspace(0.0, 6.0, 1201)
    best, best_c = np.inf, 0.0
    for c in grid:
        model = (tau_ms + 0.5 * c * tau_ms**2) / (1.0 + 0.5 * c)
        err = float(np.mean((model - f_ms) ** 2))
        if err < best:
            best, best_c = err, c
    return best_c


def derive(tarball: str) -> list[tuple]:
    with tarfile.open(tarball, "r:gz") as tf:
        pdf = tf.extractfile(MEMBER).read()
    content = _content_stream(pdf)
    paths, tx, ty = _paths_and_ticks(content)
    if len(tx) < 2 or len(ty) < 2:
        raise ValueError("tick calibration failed")
    # x ticks: 0, 2, .. 10 Myr (yield.py's 0-10 Myr tr grid); y ticks:
    # decades of ylim (1e-10, 2e-4) -> first tick is 1e-10
    x0, x_per_myr = tx[0], (tx[-1] - tx[0]) / (2.0 * (len(tx) - 1))
    y0, y_per_dec = ty[0], (ty[-1] - ty[0]) / (len(ty) - 1)

    rows = []
    for col, p in paths:
        if len(p) < 10 or col not in CYCLE:
            continue
        m0 = CYCLE[col]
        t = (p[:, 0] - x0) / x_per_myr
        logy = (p[:, 1] - y0) / y_per_dec - 10.0
        y = 10.0 ** logy
        # clip the leading clipped-to-axes segment (log(0) start)
        keep = p[:, 1] > 0.0
        t, y = t[keep], y[keep]
        order = np.argsort(t)
        t, y = t[order], y[order]
        f = y / y[-1]
        t_end = float(t[-1])
        tau = t / t_end

        # knee: last MS point — the release rate jumps ~an order of
        # magnitude when the giant-branch wind takes over. Detect on the
        # digitized polyline's segment slopes in linear F per tau.
        df = np.diff(f) / np.maximum(np.diff(tau), 1e-12)
        ms_med = np.median(df[: max(3, len(df) // 2)])
        jump = np.nonzero(df > 8.0 * ms_med)[0]
        k = int(jump[0]) if len(jump) else len(df) - 1
        tau_knee = float(tau[k])
        ms_frac = float(f[k])

        u = tau[: k + 1] / tau_knee
        f_ms = f[: k + 1] / ms_frac
        c = _fit_ramp(u, f_ms)
        q25, q50, q75 = (float(np.interp(q, f_ms, u))
                         for q in (0.25, 0.5, 0.75))
        rows.append((m0, round(t_end, 4), round(tau_knee, 4),
                     round(ms_frac, 5), round(c, 3),
                     round(q25, 4), round(q50, 4), round(q75, 4)))
    rows.sort()
    if len(rows) != len(CYCLE):
        raise ValueError(f"expected {len(CYCLE)} curves, got {len(rows)}")

    # end-to-end validation: recovered collapse times match the
    # binev.data event anchors (independent data in the same tarball)
    import sys
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")  # host-side script: never
    #   take the accelerator
    from al26.models.stellar import seba_anchors

    t_sn, _, _ = seba_anchors.anchors()
    for (m0, t_end, *_), t_ref in zip(rows, t_sn[:len(rows)]):
        if abs(t_end - t_ref) / t_ref > 0.01:
            raise ValueError(
                f"curve end {t_end} for m0={m0} does not match the "
                f"binev.data collapse time {t_ref}"
            )
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reference", default=DEFAULT_TARBALL)
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()

    rows = derive(args.reference)
    text = HEADER + "".join(
        ",".join(str(v) for v in r) + "\n" for r in rows
    )
    if args.check:
        with open(OUT) as fh:
            shipped = fh.read()
        if shipped != text:
            raise SystemExit("MISMATCH between derived and shipped CSV")
        print(f"OK: {OUT} reproduces from {args.reference}")
        return
    with open(OUT, "w") as fh:
        fh.write(text)
    print(f"wrote {OUT} ({len(rows)} rows)")


if __name__ == "__main__":
    main()
