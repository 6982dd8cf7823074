"""Where the force kernel runs, the one precision policy for f32
contractions, and the compile-cache location.

The hand-written kernel (ops.pallas_nbody) is compiled for NVIDIA GPUs
through Pallas' Triton route. `kernel_here` is the single capability test
every automatic backend choice reads; an explicit kernel request goes
through `kernel_interpret`, which never falls back silently.
"""
from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp

# below this many rows x columns the plain XLA sweep is as fast as a
# kernel launch plus its padding (the dense path handles n <= 2048)
KERNEL_MIN_N = 4096

_interpret_opt_in = False


def allow_interpret(on: bool = True) -> None:
    """Let explicit kernel requests run in the Pallas interpreter on a CPU
    process. Only the test session turns this on (tests/conftest.py); a
    user asking for the kernel on a machine without a GPU gets an error."""
    global _interpret_opt_in
    _interpret_opt_in = bool(on)


def on_gpu() -> bool:
    return jax.default_backend() == "gpu"


def kernel_here(n: int, dtype) -> bool:
    """Should `auto` run the Pallas sweep kernel for an n-source sweep?

    True only on a GPU process, for f32 data with x64 disabled (the
    kernel's index arithmetic is int32), at n >= KERNEL_MIN_N."""
    return (on_gpu() and n >= KERNEL_MIN_N
            and jnp.dtype(dtype) == jnp.float32
            and not jax.config.jax_enable_x64)


def kernel_interpret() -> bool:
    """`interpret` flag for an explicitly requested kernel: compiled on a
    GPU, the interpreter on a CPU process whose test session opted in
    (allow_interpret), and an error everywhere else."""
    if on_gpu():
        return False
    if _interpret_opt_in:
        return True
    raise RuntimeError(
        "the Pallas force kernel runs on an NVIDIA GPU only (this process "
        f"has backend {jax.default_backend()!r}); use force_impl='auto' or "
        "'default' for the XLA sweep"
    )


# The one precision policy for float32 contractions: a dot without an
# explicit precision may run in TF32 on the GPU (about three decimal
# digits), which would put ~1e-3 relative error into forces and yields.
HIGHEST = jax.lax.Precision.HIGHEST
einsum = functools.partial(jnp.einsum, precision=HIGHEST)


def enable_compile_cache() -> str:
    """Persistent compilation cache: JAX's own JAX_COMPILATION_CACHE_DIR
    when the environment sets it (then nothing is set here), else the
    fixed `<repo>/.jax_cache` (a fixed path, so later processes hit it).
    Called by the entry points (cli.main, chip_smoke.py, bench workers),
    never at import. Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.path.join(repo, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
