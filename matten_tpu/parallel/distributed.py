"""Multi-host runtime initialization + host-gated utilities.

Replaces the reference's reliance on Lightning/torch.distributed process
management (reference N12, SURVEY.md §5.8): `jax.distributed.initialize`
wires up the multi-host SPMD runtime; collectives ride the intra-host links
inside a host and the network across hosts (mesh construction keeps the
'data' axis outermost so only gradient reductions cross hosts).
`rank_zero_only` mirrors the reference's single rank-awareness point
(utils_wandb.py:72).
"""

from __future__ import annotations

import functools
import logging
from typing import Callable, Optional

import jax

logger = logging.getLogger(__name__)

__all__ = ["initialize_distributed", "is_primary_host", "rank_zero_only", "make_multihost_mesh"]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the multi-host runtime (no-op when single-process).

    With no arguments, jax auto-detects the cluster environment (SLURM,
    etc.); elsewhere pass all three.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        logger.info(
            "distributed runtime: process %d/%d, %d local / %d global devices",
            jax.process_index(),
            jax.process_count(),
            jax.local_device_count(),
            jax.device_count(),
        )
    except (ValueError, RuntimeError) as e:
        logger.info("single-process run (distributed init skipped: %s)", e)


def is_primary_host() -> bool:
    return jax.process_index() == 0


def rank_zero_only(fn: Callable) -> Callable:
    """Run `fn` only on the primary host (checkpoint writes, logging)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if is_primary_host():
            return fn(*args, **kwargs)
        return None

    return wrapped


def make_multihost_mesh(n_graph: int = 1):
    """('data', 'graph') mesh over ALL global devices, data-axis outermost
    so cross-host (DCN) traffic is only the gradient reduction."""
    from matten_tpu.parallel.sharding import make_mesh

    return make_mesh(n_data=jax.device_count() // n_graph, n_graph=n_graph)
