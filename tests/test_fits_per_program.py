"""Chunked-epoch dispatch (PPOConfig.fits_per_program).

The fused scan-of-fits epoch program's compile cost grows with
fits_per_epoch x rollout_len; at extreme windows (T=8192 attention)
fits_per_program=N, a compile-size option, compiles a bounded N-fit
program and replays the fused epoch's EXACT key stream in slices — the
contract here is bit-identical training, not merely statistical parity.
"""
import jax
import numpy as np
import pytest

from ppoc_tpu import PPOConfig, Trainer


def _leaves_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(la, lb))


@pytest.mark.parametrize("reset_per_fit", [True, False])
def test_chunked_bit_equals_fused(reset_per_fit):
    base = dict(env="pendulum", n_envs=8, rollout_len=50, minibatch_size=100,
                fits_per_epoch=4, eval_envs=8, eval_len=200, hidden=(16, 16),
                seed=3, reset_per_fit=reset_per_fit)
    fused = Trainer(PPOConfig(**base))
    chunk = Trainer(PPOConfig(**base, fits_per_program=2))
    for _ in range(2):
        m_f = fused.train_epoch()
        m_c = chunk.train_epoch()
    assert _leaves_equal(fused.state, chunk.state)
    np.testing.assert_allclose(
        np.asarray(jax.tree.leaves(m_c)), np.asarray(jax.tree.leaves(m_f)),
        rtol=1e-6)
    # single-chunk degenerate case: the same program modulo the key
    # plumbing — still bit-equal
    whole = Trainer(PPOConfig(**base, fits_per_program=4))
    whole.train_epoch()
    whole.train_epoch()
    assert _leaves_equal(fused.state, whole.state)


def test_chunked_attention_trunk():
    """The motivating regime: a sequence-trunk (attention) epoch runs
    chunked at fits_per_program=1 and still learns/evaluates."""
    cfg = PPOConfig(env="recall", n_envs=8, rollout_len=6, minibatch_size=48,
                    fits_per_epoch=2, fits_per_program=1, eval_envs=16,
                    eval_len=6, hidden=(16,), seed=0, attn_dim=8,
                    attn_layers=1, attn_heads=2)
    tr = Trainer(cfg)
    tr.train_epoch()
    m = tr.evaluate()
    assert np.isfinite(m.R)


def test_validation():
    from ppoc_tpu import config as config_mod

    with pytest.raises(ValueError, match="must divide"):
        Trainer(PPOConfig(env="pendulum", fits_per_epoch=10,
                          fits_per_program=3))
    with pytest.raises(ValueError, match="single-device"):
        config_mod.validate(PPOConfig(env="pendulum", tp_size=2,
                                      fits_per_program=1))
    with pytest.raises(ValueError, match="single-device"):
        config_mod.validate(PPOConfig(env="recall", attn_dim=8, sp_size=2,
                                      rollout_len=8, fits_per_program=1))


def test_validation_mesh():
    import jax
    from jax.sharding import Mesh

    devs = np.array(jax.devices()[:2])
    with pytest.raises(ValueError, match="single-device"):
        Trainer(PPOConfig(env="pendulum", n_envs=8, rollout_len=50,
                          minibatch_size=100, fits_per_program=1),
                mesh=Mesh(devs, ("dp",)))
