"""Large-minibatch (throughput) update path: block-shuffled minibatches
and the bf16 XLA update.

At large minibatches the per-row gather of the shuffled minibatch is the
update's bandwidth wall; ``PPOConfig.shuffle_block`` assigns rows to
minibatches in aligned blocks instead (data/buffer.py).  The bf16 backend
runs the same scan phases with bf16 matmul operands and f32 master
weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ppoc_tpu import PPOConfig, envs
from ppoc_tpu.algo import ppo
from ppoc_tpu.data import buffer


def _setup(cfg, seed=0):
    env = envs.make(cfg.env)
    key = jax.random.PRNGKey(seed)
    ts = ppo.init_train_state(cfg, env, key)
    traj, _ = ppo.rollout(cfg, env, ts.policy_params, key,
                          cfg.n_envs, cfg.rollout_len, "jnp")
    adv, tgt = ppo.compute_advantages(cfg, env, ts.v_params, traj, None, "jnp")
    return env, ts, buffer.from_rollout(traj, adv, tgt)


def _bigmb_cfg(**kw):
    base = dict(env="pendulum", n_envs=32, rollout_len=128,
                minibatch_size=4096, n_epochs_value=2, n_epochs_policy=2,
                hidden=(32, 32), kernel_backend="bf16")
    base.update(kw)
    return PPOConfig(**base)


def test_block_permutation_partitions_buffer():
    """Every block id appears exactly once per epoch slice; gathered rows
    equal the row-gather of the expanded ids (block semantics == row
    semantics on block-aligned ids)."""
    from ppoc_tpu.data import buffer as B

    key = jax.random.PRNGKey(0)
    n_rows, mb, blk = 4096, 1024, 128
    n_mb = n_rows // mb
    ids = B.block_permutation_minibatches(key, n_rows, n_mb, mb, blk)
    assert ids.shape == (n_mb, mb // blk)
    flat = np.sort(np.asarray(jax.device_get(ids)).ravel())
    np.testing.assert_array_equal(flat, np.arange(n_rows // blk))

    rows = jnp.arange(n_rows, dtype=jnp.float32)[:, None] * jnp.ones((1, 3))
    got = B.gather_blocks(rows, ids[0], blk)
    row_ids = (np.asarray(jax.device_get(ids[0]))[:, None] * blk
               + np.arange(blk)[None, :]).ravel()
    np.testing.assert_array_equal(np.asarray(jax.device_get(got))[:, 0],
                                  row_ids.astype(np.float32))


def test_shuffle_block_validation():
    from ppoc_tpu.config import validate

    with pytest.raises(ValueError, match="shuffle_block"):
        validate(_bigmb_cfg(shuffle_block=1000))       # does not divide mb
    with pytest.raises(ValueError, match="sequence trunks"):
        validate(PPOConfig(env="recall", rollout_len=6, n_envs=8,
                           minibatch_size=48, attn_dim=8, attn_heads=2,
                           eval_len=6, shuffle_block=8))
    validate(_bigmb_cfg(shuffle_block=512))            # divides: ok


def test_block_shuffle_learns():
    """End-to-end: pendulum training with block-shuffled minibatches still
    reduces the value loss (the statistical-equivalence smoke check; the
    solve-quality A/B runs on the chip)."""
    cfg = PPOConfig(env="pendulum", n_envs=16, rollout_len=64,
                    minibatch_size=256, fits_per_epoch=1, eval_envs=16,
                    eval_len=200, hidden=(32, 32), kernel_backend="jnp",
                    shuffle_block=64, seed=0)
    from ppoc_tpu.algo.trainer import Trainer

    tr = Trainer(cfg)
    m0 = tr.train_epoch()
    for _ in range(4):
        m = tr.train_epoch()
    assert float(m.value_loss) < float(m0.value_loss)


def test_bigmb_update_step_learns():
    """End-to-end update_step under the bf16 backend at big mb: finite
    losses and the value loss drops over a few fits."""
    cfg = _bigmb_cfg()
    env, ts, buf = _setup(cfg)
    traj, _ = ppo.rollout(cfg, env, ts.policy_params, jax.random.PRNGKey(1),
                          cfg.n_envs, cfg.rollout_len, "jnp")
    step = jax.jit(lambda t, k: ppo.update_step(
        cfg, env, t, traj, k, backend="bf16"))
    losses = []
    for i in range(3):
        ts, m = step(ts, jax.random.PRNGKey(20 + i))
        losses.append(float(m.value_loss))
    assert all(np.isfinite(l) for l in losses)
    assert losses[-1] < losses[0]
