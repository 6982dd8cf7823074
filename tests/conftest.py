"""Test configuration: the CPU with 8 fake devices (multi-device sharding
tests run on a virtual mesh, SURVEY.md §4g), float64 enabled, and the
Pallas kernel allowed to run in the interpreter (ops.backend
.allow_interpret) — outside the test session an explicit kernel request
on a CPU process is an error.

JAX_PLATFORMS=cuda keeps the GPU instead: chip_smoke.py runs the
`gpu`-marked tests that way (`python -m pytest tests -m gpu`); they skip
on the CPU through the `gpu` fixture below.
"""
import os

import pytest

_on_card = os.environ.get("JAX_PLATFORMS", "") in ("cuda", "gpu")
if not _on_card:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

if not _on_card:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from al26.ops import backend

backend.allow_interpret()


@pytest.fixture
def gpu():
    """Skip unless this process runs on an NVIDIA GPU (decided when the
    test runs, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest tests -m "
                    "gpu` with JAX_PLATFORMS=cuda on the card "
                    "(chip_smoke.py does)")


def _ensure_native_codec() -> None:
    """Build the C++ UBJSON codec once per session when a compiler is
    available, so a regression in the .cpp cannot rot unnoticed behind a
    skip. Best-effort: on any failure the pure-Python codec remains the
    fallback and tests/test_io.py's skipif still applies — but a broken
    COMPILE on a box with a compiler should be loud, so that surfaces as
    a warning."""
    import glob
    import shutil
    import subprocess
    import sys
    import warnings

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    native = os.path.join(repo, "al26", "io", "native")
    cpp = os.path.join(native, "ubjson_native.cpp")
    sos = glob.glob(os.path.join(native, "_ubjson_native*.so"))
    if sos and all(os.path.getmtime(so) >= os.path.getmtime(cpp)
                   for so in sos):
        return
    if shutil.which("c++") is None and shutil.which("g++") is None:
        return
    try:
        r = subprocess.run(
            [sys.executable,
             os.path.join(repo, "scripts", "build_native.py")],
            capture_output=True, text=True, timeout=300,
        )
    except subprocess.TimeoutExpired:
        # genuinely best-effort: a hung/slow compiler must not abort the
        # whole pytest session at conftest import
        warnings.warn("native codec build timed out (300 s); tests will "
                      "skip the native lane")
        return
    if r.returncode != 0:
        warnings.warn(
            "native codec build FAILED (tests will skip the native lane):\n"
            + "\n".join(r.stderr.strip().splitlines()[-5:])
        )


_ensure_native_codec()
