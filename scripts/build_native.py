"""Build the C++ native extensions into al26/io/native/.

Usage: python scripts/build_native.py
Compiles _ubjson_native (UBJSON Draft-12 codec accelerator) with the
system compiler via setuptools. The pure-Python codec remains the fallback
when the extension has not been built.
"""
from __future__ import annotations

import os
import shutil
import sys

import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(REPO, "al26", "io", "native")


def build() -> str:
    from setuptools import Distribution, Extension
    from setuptools.command.build_ext import build_ext

    ext = Extension(
        "_ubjson_native",
        sources=[os.path.join(NATIVE_DIR, "ubjson_native.cpp")],
        extra_compile_args=["-O3", "-std=c++17"],
    )
    with tempfile.TemporaryDirectory() as tmp:
        dist = Distribution({"name": "al26_native", "ext_modules": [ext]})
        cmd = build_ext(dist)
        cmd.build_lib = tmp
        cmd.build_temp = os.path.join(tmp, "t")
        cmd.finalize_options()
        cmd.run()
        built = cmd.get_ext_fullpath("_ubjson_native")
        target = os.path.join(NATIVE_DIR, os.path.basename(built))
        shutil.copy2(built, target)
    return target


if __name__ == "__main__":
    path = build()
    print("built", path)
    sys.path.insert(0, NATIVE_DIR)
    import _ubjson_native

    assert _ubjson_native.loadb(_ubjson_native.dumpb({"x": [1.0, 2.0]})) == {
        "x": [1.0, 2.0]
    }
    print("self-test OK")
