"""Device mesh construction and multi-host bootstrap.

The reference is single-process/single-GPU with no communication backend
(SURVEY.md §2a); its only "transport" is cudaMemcpy.  Here distribution is a
first-class component: a 1-D data-parallel mesh over all devices (NVLink
within a host, the network across hosts via ``jax.distributed``), with
gradient pmean and
advantage-normalization psum as the only collectives (see ppoc_tpu.algo.ppo).
A ``model`` axis slot is reserved for tensor parallelism, though the
reference's <=128-wide MLPs never need it.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    n_devices: Optional[int] = None,
    axis_name: str = "dp",
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a 1-D data-parallel mesh over ``n_devices`` (default: all)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def type_varying(x, axis_name):
    """Mark an array as device-varying over ``axis_name`` (a name or tuple
    of names) for shard_map's varying-axes type system (jax version shim:
    pcast on new jax, pvary on older). Shared by the rollout carry
    (algo/ppo.py) and the pipeline schedule (parallel/pp.py)."""
    axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    try:
        already = set(jax.typeof(x).vma)
        axes = tuple(a for a in axes if a not in already)
    except AttributeError:
        pass
    if not axes:
        return x
    if hasattr(jax.lax, "pcast"):
        return jax.lax.pcast(x, axes, to="varying")
    return jax.lax.pvary(x, axes)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-host bootstrap (the jax.distributed analogue of an MPI/NCCL
    init, which the reference never had).  No-op when single-process args
    are absent and the environment provides no cluster configuration."""
    if coordinator_address is None and num_processes is None:
        # Rely on cluster auto-detection (cluster metadata). Failure is
        # expected on a plain single host (no cluster env) but must not be
        # silently swallowed on a real cluster: surface
        # it as a warning with the cause.
        try:
            jax.distributed.initialize()
        except Exception as e:
            import warnings

            warnings.warn(
                f"jax.distributed auto-initialization failed ({e!r}); "
                f"continuing single-process. On a multi-host cluster pass "
                f"coordinator_address/num_processes/process_id explicitly.",
                stacklevel=2,
            )
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
