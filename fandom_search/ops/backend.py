"""Which implementation of the kernels runs: decided by the platform.

  * ``"gpu"`` — the Triton-route Pallas kernels (ops/distance_topk.py,
    ops/smith_waterman.py);
  * ``"cpu"`` — the plain XLA paths, which are also the kernels'
    oracles.  A CPU run happens only when the caller asked for the CPU
    (``--cpu``, or the tests pinning ``JAX_PLATFORMS=cpu``);
  * anything else — an error: nothing here is written for it.

``interpret=True`` (tests) runs the GPU kernels through the Pallas
interpreter on whatever device is present.
"""

from __future__ import annotations

import jax


class UnsupportedPlatformError(RuntimeError):
    pass


def platform() -> str:
    """The platform of the first JAX device."""
    return jax.devices()[0].platform


def use_kernels(interpret: bool = False, plat: str | None = None) -> bool:
    """True when the hand-written kernels run (GPU, or interpret mode),
    False for the plain path (CPU); raises on any other platform."""
    if interpret:
        return True
    plat = platform() if plat is None else plat
    if plat == "gpu":
        return True
    if plat == "cpu":
        return False
    raise UnsupportedPlatformError(
        f"no kernels for platform {plat!r}: this program runs on an "
        f"NVIDIA GPU, or on the CPU when asked for (--cpu)"
    )


def require_gpu(allow_cpu: bool = False) -> str:
    """The platform, after checking it is one a run may use: ``"gpu"``,
    or ``"cpu"`` only with ``allow_cpu``.  There is no silent fallback:
    a run that wanted the GPU and found none stops here."""
    plat = platform()
    if plat == "gpu" or (plat == "cpu" and allow_cpu):
        return plat
    if plat == "cpu":
        raise UnsupportedPlatformError(
            "no GPU found (JAX sees only the CPU); pass --cpu to run on "
            "the CPU deliberately"
        )
    use_kernels(plat=plat)  # raises for any other platform
    return plat
