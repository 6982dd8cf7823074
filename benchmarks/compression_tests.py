"""Serialization+compression timing harness, equivalent of the reference's
bench/compression/compression-tests.py (results tabulated in its
filetypes.md). Builds a synthetic yields payload (or takes a real
*-yields.ubj.zst file) and times codecs."""
import os
import sys

# `python benchmarks/<script>.py` puts benchmarks/ (not the repo root) on
# sys.path — same bootstrap as the scripts/ entry points
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bz2
import gzip
import lzma
import time
import zlib

import numpy as np


def build_payload(n_stars=1000, n_checkpoints=1000) -> bytes:
    from al26.io import ubjson

    rng = np.random.default_rng(0)
    series = {
        f"{ch}_{iso}": [rng.uniform(size=n_stars).tolist()
                        for _ in range(n_checkpoints)]
        for iso in ("26al", "60fe") for ch in ("local", "global", "sne")
    }
    series["time"] = np.linspace(0, 10, n_checkpoints).tolist()
    t0 = time.time()
    raw = ubjson.dumpb(series)
    print(f"ubjson encode: {time.time()-t0:.3f} s, "
          f"{len(raw)/2**20:.2f} MiB")
    return raw


def main(yields_file: str | None = None) -> None:
    import zstandard as zstd

    if yields_file:
        raw = zstd.ZstdDecompressor().decompress(open(yields_file, "rb").read())
    else:
        raw = build_payload()

    codecs = [
        ("zstd-3", lambda d: zstd.ZstdCompressor(level=3, threads=-1).compress(d)),
        ("zstd-8", lambda d: zstd.ZstdCompressor(level=8, threads=-1).compress(d)),
        ("zstd-19", lambda d: zstd.ZstdCompressor(level=19, threads=-1).compress(d)),
        ("zlib-6", lambda d: zlib.compress(d, 6)),
        ("gzip-6", lambda d: gzip.compress(d, 6)),
        ("bz2-9", lambda d: bz2.compress(d, 9)),
        ("lzma-6", lambda d: lzma.compress(d, preset=6)),
    ]
    print(f"{'codec':>8} {'time (s)':>9} {'MiB':>8} {'ratio':>7} {'MiB/s':>8}")
    size0 = len(raw) / 2**20
    for name, fn in codecs:
        t0 = time.time()
        out = fn(raw)
        dt = time.time() - t0
        print(f"{name:>8} {dt:9.3f} {len(out)/2**20:8.2f} "
              f"{len(raw)/len(out):7.2f} {size0/dt:8.1f}")


if __name__ == "__main__":
    main(*(sys.argv[1:] or [None]))
