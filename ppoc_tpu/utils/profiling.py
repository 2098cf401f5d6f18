"""Tracing / profiling helpers.

The reference's entire observability layer is ``clock()`` around each epoch
printed as ``Time %fs`` (src/main.c:51-54).  The equivalents here
(SURVEY.md §5): a ``jax.profiler`` trace context for real XLA device
traces, and a throughput meter whose sections end in
``jax.block_until_ready`` — JAX returns before the device finishes, so a
timing without the barrier measures the enqueue.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterator, Optional

import jax


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture an XLA profiler trace viewable in TensorBoard/Perfetto.

    Usage::

        with profiling.trace("/tmp/tr"):
            state, _ = train_epoch(state, key)
            sync(state)
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def sync(tree: Any) -> None:
    """Block until everything ``tree`` depends on has run on the device."""
    jax.block_until_ready(tree)


class ThroughputMeter:
    """Steps-per-second accounting across timed sections.

    Equivalent of the reference's per-epoch clock() (src/main.c:51-54) with
    env-steps/s derived the way BASELINE.json's scaling metric needs.
    """

    def __init__(self) -> None:
        self.total_steps = 0
        self.total_seconds = 0.0
        self._t0: Optional[float] = None

    @contextlib.contextmanager
    def section(self, n_steps: int, sync_on: Any = None) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        if sync_on is not None:
            sync(sync_on)
        self.total_seconds += time.perf_counter() - t0
        self.total_steps += n_steps

    @property
    def steps_per_second(self) -> float:
        return self.total_steps / self.total_seconds if self.total_seconds else 0.0

    def report(self) -> Dict[str, float]:
        return {
            "env_steps": float(self.total_steps),
            "seconds": self.total_seconds,
            "env_steps_per_s": self.steps_per_second,
        }
