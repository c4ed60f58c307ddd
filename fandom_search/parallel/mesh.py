"""Device-mesh construction (SURVEY.md section 3 parallelism table).

The reference's only parallelism is a host process pool over fanwork
files; the device equivalent is an SPMD mesh with two logical axes:

  ``works``  — the fanwork/query dimension (pure data parallel; the
               moral successor of Pool.map over files),
  ``script`` — the index dimension (each device holds a slice of the
               script's shingle matrix; per-shard top-k results merge
               with an all_gather + re-top-k collective,
               BASELINE.json:10).

Mesh-size-agnostic by construction: tests run the same code on a
virtual 8-device CPU mesh (SURVEY.md section 5).  The GPUs of one host
reach each other all to all at one rate, so the mesh's shape is chosen
by the algorithm (how many script shards) and not by a topology.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh

from fandom_search.config import MeshConfig

AXIS_WORKS = "works"
AXIS_SCRIPT = "script"

_multihost_initialized = False


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> int:
    """Join a multi-host JAX cluster (SURVEY.md §3).

    Must run before any other jax call in the process.  After it,
    ``jax.devices()`` returns the GLOBAL device list, so ``make_mesh``
    (which consumes ``jax.devices()``) needs no changes for multi-host:
    the identical shard_map code runs, with XLA handing the collectives
    to NCCL.

    Pass all three arguments: nothing on a plain GPU host tells
    jax.distributed about a cluster.  Returns the number of global
    devices.  Idempotent.
    """
    global _multihost_initialized
    if not _multihost_initialized:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        _multihost_initialized = True
    return len(jax.devices())


def mesh_shape_for(n_devices: int, prefer_script: int = 1) -> tuple[int, int]:
    """(works, script) factorization of a device count.

    The works axis carries the heavy data parallelism, so it takes
    every device not claimed by ``prefer_script`` (clamped to the
    largest divisor of ``n_devices`` that is <= prefer_script).
    """
    if n_devices < 1:
        raise ValueError(f"need at least one device, got {n_devices}")
    script = max(d for d in range(1, prefer_script + 1) if n_devices % d == 0)
    return n_devices // script, script


def make_mesh(cfg: MeshConfig, devices=None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    need = cfg.num_devices
    if len(devices) < need:
        raise ValueError(
            f"mesh {cfg.works}x{cfg.script} needs {need} devices, "
            f"have {len(devices)}"
        )
    grid = np.array(devices[:need]).reshape(cfg.works, cfg.script)
    return Mesh(grid, (AXIS_WORKS, AXIS_SCRIPT))
