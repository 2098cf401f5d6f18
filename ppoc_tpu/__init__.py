"""ppoc_tpu: a PPO training framework in JAX.

Built from scratch in JAX/XLA/Pallas with the capabilities of the C/CUDA
reference cube1324/ppo.c (see SURVEY.md).  Compute path: pure-JAX vectorized
environments + XLA-compiled networks (a Pallas flash-attention kernel on
the GPU for long attention windows) + one jitted fit step; scaling path:
shard_map over a data-parallel mesh with psum collectives.
"""
from ppoc_tpu.config import PPOConfig, reference_preset, throughput_preset

__version__ = "0.1.0"
__all__ = ["PPOConfig", "reference_preset", "throughput_preset", "Trainer", "envs",
           "serve", "sweep"]


def __getattr__(name):  # lazy: keep `import ppoc_tpu` free of jax init
    if name == "Trainer":
        from ppoc_tpu.algo.trainer import Trainer
        return Trainer
    if name in ("envs", "serve", "sweep"):
        import importlib
        return importlib.import_module(f"ppoc_tpu.{name}")
    raise AttributeError(f"module 'ppoc_tpu' has no attribute {name!r}")
