"""Device-mesh construction and multi-host initialization.

The reference is single-process single-GPU (cudaSetDevice(0),
src/viterbi/viterbi.cu:134) with no distributed layer; this module is the
new capability (SURVEY.md §2.3 P7): time-blocks of the coded stream are
sharded over a 1-D "blocks" mesh axis spanning all cards and hosts.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
from jax.sharding import Mesh


BLOCK_AXIS = "blocks"


def make_block_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over all (or the given) devices; axis name 'blocks'."""
    devs = list(devices) if devices is not None else jax.devices()
    import numpy as np
    return Mesh(np.array(devs), (BLOCK_AXIS,))


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-host bring-up via jax.distributed (no-op when single-process
    args are not provided and env config is absent)."""
    if coordinator_address is None and num_processes is None:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
