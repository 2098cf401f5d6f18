"""Train data-parallel and tensor-parallel on a device mesh.

With one process this uses all local devices; across hosts, call
ppoc_tpu.parallel.initialize_distributed() first and the same code runs on
the global mesh (gradients pmean over the interconnect, env state stays local).
"""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from ppoc_tpu import PPOConfig, Trainer
from ppoc_tpu.parallel import make_mesh

# pure data parallelism over every local device (n_envs / minibatch_size /
# eval_envs must all divide the mesh size)
cfg = PPOConfig(env="pendulum", n_envs=1024, rollout_len=200,
                minibatch_size=8192, fits_per_epoch=1, n_epochs=10,
                eval_envs=256)
Trainer(cfg, mesh=make_mesh()).train()

# 2-D mesh: data parallel x tensor parallel (MLP hidden dim sharded)
if len(jax.devices()) >= 4:
    cfg_tp = cfg.replace(hidden=(256, 256), tp_size=2)
    Trainer(cfg_tp).train(n_epochs=2)

# 2-D mesh: data parallel x pipeline parallel (MLP layers staged)
if len(jax.devices()) >= 4:
    cfg_pp = cfg.replace(hidden=(128, 128, 128), pp_size=2)
    Trainer(cfg_pp).train(n_epochs=2)
