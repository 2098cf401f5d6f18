"""Train mixture-of-experts trunks, single-device and expert-parallel.

The MoE family (models/moe.py) swaps both the policy mean-net and the value
net for a gated mixture of expert MLPs; PPOConfig(ep_size=N) shards the
experts over an 'ep' mesh axis (parallel/ep.py).  With one process this
uses local devices; across hosts, call
ppoc_tpu.parallel.initialize_distributed() first and the experts shard over
the global mesh (mixture psum + router-gradient reduction over the interconnect —
see tests/test_distributed.py::test_two_process_expert_parallel).

Run on CPU: PPOC_PLATFORM=cpu PPOC_CPU_DEVICES=8 python examples/moe_expert_parallel.py
"""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get("PPOC_PLATFORM"):
    import jax
    jax.config.update("jax_platforms", os.environ["PPOC_PLATFORM"])
    if os.environ.get("PPOC_CPU_DEVICES"):
        jax.config.update("jax_num_cpu_devices",
                          int(os.environ["PPOC_CPU_DEVICES"]))

import jax

from ppoc_tpu import PPOConfig, Trainer

# single-device mixture: 4 experts, dense softmax gating
cfg = PPOConfig(env="pendulum", n_envs=64, rollout_len=200,
                minibatch_size=256, fits_per_epoch=4, n_epochs=6,
                eval_envs=64, n_experts=4)
Trainer(cfg).train()

# top-2 gating: the gate keeps the 2 largest expert weights per input
Trainer(cfg.replace(moe_topk=2)).train(n_epochs=2)

# 2-D mesh: data parallel x expert parallel (experts sharded P("ep"),
# router replicated; ep checkpoints interchange with single-device
# trainers of the SAME n_experts — this run uses 8, the ones above 4)
if len(jax.devices()) >= 4:
    Trainer(cfg.replace(n_experts=8, moe_topk=2, ep_size=2)).train(n_epochs=2)
