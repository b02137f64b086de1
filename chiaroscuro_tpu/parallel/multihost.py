"""Multi-process distributed rendering (several hosts or processes).

The reference is strictly single-process (SURVEY.md §2 parallelism
inventory).  Here, the same tile-sharded renderer scales across processes:

- ``initialize()`` wires ``jax.distributed`` (one process per host; XLA
  hands the collectives to NCCL).
- The global device mesh spans all processes; ``render_frame_sharded`` /
  ``sharded_value_and_grad`` (``parallel/sharding.py``) work unchanged —
  psum over the mesh axis is a cross-host all-reduce.
- The counter-based PRNG keys randomness on *global* pixel ids, so an
  N-host render is bitwise identical to the 1-host render.
- ``export_on_process_zero`` implements host-local IO with process-0 export
  (SURVEY.md §5 distributed-communication design).

Unit-tested on the virtual 8-device CPU mesh (tests/test_parallel.py
``test_multihost_*``): the ``initialize()`` single-process no-op, the
global mesh construction, and process-0-only export.  Real multi-host runs
additionally need ``initialize()`` called before first jax use.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Start jax.distributed when running multi-process.

    Nothing on a plain GPU host describes a cluster, so pass the
    coordinator address (``localhost:<port>`` on one host), the process
    count and this process's id.  No-op when already initialized or
    single-process.
    """
    if num_processes is not None and num_processes <= 1:
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise


def global_tile_mesh(axis: str = "tile") -> jax.sharding.Mesh:
    """1-D mesh over every device in the job (all hosts)."""
    return jax.sharding.Mesh(np.asarray(jax.devices()), (axis,))


def is_process_zero() -> bool:
    return jax.process_index() == 0


def export_on_process_zero(path: str, pixels, exposure: float = 5.0) -> None:
    """Gather nothing (the frame is already addressable-shard assembled by
    shard_map's output) and write from process 0 only."""
    if not is_process_zero():
        return
    from chiaroscuro_tpu.render.image_io import write_image

    write_image(path, np.asarray(pixels), exposure)
