"""The XLA update phases (algo/ppo.value_phase / policy_phase: nested
scans of minibatch forward + backward + Adam) against a sequential
reference written out step by step in Python.

The reference replays the reference's schedule by hand
(src/ppo.cu:491-533): per epoch a fresh permutation of the buffer rows
sliced into minibatches with the tail dropped (src/trajectory_buffer.cu:
126-144, src/ppo.cu:475-477), per minibatch the loss gradient and one
textbook Adam step (m, v, bias-corrected, src/adam.cu) in NumPy.  The
phases must land on the same weights, optimizer timesteps and mean losses
to float32 rounding.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ppoc_tpu import PPOConfig, envs
from ppoc_tpu.algo import ppo
from ppoc_tpu.data import buffer
from ppoc_tpu.models import mlp

LOG_2PI = float(np.log(2 * np.pi))


def _setup(cfg, seed=0):
    env = envs.make(cfg.env)
    key = jax.random.PRNGKey(seed)
    ts = ppo.init_train_state(cfg, env, key)
    traj, _ = ppo.rollout(cfg, env, ts.policy_params, key,
                          cfg.n_envs, cfg.rollout_len, "jnp")
    adv, tgt = ppo.compute_advantages(cfg, env, ts.v_params, traj, None,
                                      "jnp")
    return env, ts, buffer.from_rollout(traj, adv, tgt)


def _minibatches(cfg, key_e, n_rows, mb=None):
    """The epoch's [n_mb, mb] row ids: the permutation, tail dropped —
    at block granularity when cfg.shuffle_block is set."""
    n_mb, blk = cfg.num_minibatches, cfg.shuffle_block
    mb = cfg.minibatch_size if mb is None else mb
    if not blk:
        perm = np.asarray(jax.random.permutation(key_e, n_rows))
        return perm[:n_mb * mb].reshape(n_mb, mb)
    ids = np.asarray(jax.random.permutation(key_e, n_rows // blk))
    ids = ids[:n_mb * mb // blk].reshape(n_mb, mb // blk)
    return (ids[:, :, None] * blk + np.arange(blk)).reshape(n_mb, mb)


class _Adam:
    """Textbook Adam on a pytree, in NumPy float32."""

    def __init__(self, params, cfg):
        self.m = jax.tree.map(np.zeros_like, params)
        self.v = jax.tree.map(np.zeros_like, params)
        self.t = 0
        self.b1, self.b2, self.eps = cfg.adam_beta1, cfg.adam_beta2, \
            cfg.adam_eps

    def step(self, params, grads, lr):
        self.t += 1
        b1, b2, t = self.b1, self.b2, self.t
        self.m = jax.tree.map(lambda m, g: b1 * m + (1 - b1) * np.asarray(g),
                              self.m, grads)
        self.v = jax.tree.map(
            lambda v, g: b2 * v + (1 - b2) * np.square(np.asarray(g)),
            self.v, grads)
        return jax.tree.map(
            lambda p, m, v: (p - lr * (m / (1 - b1 ** t))
                             / (np.sqrt(v / (1 - b2 ** t)) + self.eps)
                             ).astype(np.float32),
            params, self.m, self.v)


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


def ref_value_phase(cfg, v_params, buf, key):
    p, opt, losses = _np(v_params), _Adam(_np(v_params), cfg), []
    obs, tgt = np.asarray(buf.obs), np.asarray(buf.target)

    def loss(p, o, t):
        return jnp.mean(jnp.square(mlp.apply(p, o, cfg.activation)[..., 0]
                                   - t))

    grad = jax.jit(jax.value_and_grad(loss))
    for key_e in jax.random.split(key, cfg.n_epochs_value):
        for idx in _minibatches(cfg, key_e, obs.shape[0]):
            l, g = grad(p, obs[idx], tgt[idx])
            p = opt.step(p, g, cfg.lr_v)
            losses.append(float(l))
    return p, opt.t, float(np.mean(losses))


def _policy_loss(cfg, discrete, pol, o, a, lp_old, adv):
    out = mlp.apply(pol["mlp"], o, cfg.activation)
    if discrete:
        logp_all = jax.nn.log_softmax(out, axis=-1)
        logp = jnp.take_along_axis(logp_all, a.astype(jnp.int32),
                                   axis=-1)[..., 0]
        ent = jnp.mean(-jnp.sum(jnp.exp(logp_all) * logp_all, axis=-1))
    else:
        ls = pol["log_std"]
        z = (a - out) * jnp.exp(-ls)
        logp = (-0.5 * a.shape[-1] * LOG_2PI
                - jnp.sum(ls + 0.5 * jnp.square(z), axis=-1))
        ent = 0.5 * a.shape[-1] * (1.0 + LOG_2PI) + jnp.sum(ls)
    ratio = jnp.exp(logp - lp_old)
    clipped = jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps)
    surrogate = -jnp.mean(jnp.minimum(ratio * adv, clipped * adv))
    return surrogate - cfg.ent_coeff * ent, ent


def ref_policy_phase(cfg, discrete, pol, buf, key):
    pol = _np(pol)
    opt_mlp = _Adam(pol["mlp"], cfg)
    opt_ls = _Adam(pol["log_std"], cfg) if "log_std" in pol else None
    cols = [np.asarray(c) for c in (buf.obs, buf.action, buf.log_prob,
                                    buf.advantage)]
    grad = jax.jit(jax.value_and_grad(
        functools.partial(_policy_loss, cfg, discrete), has_aux=True))
    losses, ents = [], []
    for key_e in jax.random.split(key, cfg.n_epochs_policy):
        for idx in _minibatches(cfg, key_e, cols[0].shape[0]):
            (l, e), g = grad(pol, *(c[idx] for c in cols))
            pol = dict(pol, mlp=opt_mlp.step(pol["mlp"], g["mlp"],
                                             cfg.lr_policy))
            if opt_ls is not None:
                pol["log_std"] = opt_ls.step(pol["log_std"], g["log_std"],
                                             cfg.lr_policy)
            losses.append(float(l))
            ents.append(float(e))
    return pol, opt_mlp.t, float(np.mean(losses)), float(np.mean(ents))


def _assert_tree_close(a, b, rtol=1e-4, atol=1e-6):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("mb,hidden,block", [(64, (32, 32), 0),
                                             (96, (16, 16, 16), 0),
                                             (64, (32, 32), 16)])
def test_value_phase_matches_sequential_reference(mb, hidden, block):
    cfg = PPOConfig(env="pendulum", n_envs=8, rollout_len=48,
                    minibatch_size=mb, n_epochs_value=3, hidden=hidden,
                    shuffle_block=block)
    env, ts, buf = _setup(cfg)
    k = jax.random.PRNGKey(7)
    ts2, loss = jax.jit(lambda t: ppo.value_phase(
        cfg, t, buf, k, None, "jnp", cfg.num_minibatches,
        cfg.minibatch_size))(ts)
    p_ref, t_ref, loss_ref = ref_value_phase(cfg, ts.v_params, buf, k)
    assert float(loss) == pytest.approx(loss_ref, rel=1e-5)
    assert int(ts2.opt_v.t) == t_ref == 3 * cfg.num_minibatches
    _assert_tree_close(ts2.v_params, p_ref)


@pytest.mark.parametrize("env_name,ent_coeff", [("pendulum", 0.0),
                                                ("pendulum", 0.01),
                                                ("reacher", 0.0),
                                                ("cartpole", 0.0),
                                                ("acrobot", 0.01)])
def test_policy_phase_matches_sequential_reference(env_name, ent_coeff):
    """Gaussian (1-D and multi-dimensional actions — the reference's CUDA
    logprob kernel was broken for action_dim > 1, src/policy.cu:113-125)
    and categorical policies, with and without the entropy bonus."""
    cfg = PPOConfig(env=env_name, n_envs=8, rollout_len=48,
                    minibatch_size=64, n_epochs_policy=3, hidden=(32, 32),
                    ent_coeff=ent_coeff)
    env, ts, buf = _setup(cfg)
    k = jax.random.PRNGKey(11)
    ts2, loss, ent = jax.jit(lambda t: ppo.policy_phase(
        cfg, env, t, buf, k, None, "jnp", cfg.num_minibatches,
        cfg.minibatch_size))(ts)
    pol_ref, t_ref, loss_ref, ent_ref = ref_policy_phase(
        cfg, env.spec.discrete, ts.policy_params, buf, k)
    assert float(loss) == pytest.approx(loss_ref, rel=1e-4, abs=1e-6)
    assert float(ent) == pytest.approx(ent_ref, rel=1e-5)
    assert int(ts2.opt_policy.t) == t_ref
    _assert_tree_close(ts2.policy_params, pol_ref)


def _dp_mesh(n):
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:n]), ("dp",))


def test_dp_value_phase_matches_sequential_reference():
    """Under data parallelism each shard permutes its own rows with the
    shared key and the minibatch gradient pmeans across shards: the
    reference minibatch is the union of the shards' local minibatches."""
    from jax.sharding import PartitionSpec as P

    N = 4
    cfg = PPOConfig(env="pendulum", n_envs=8, rollout_len=32,
                    minibatch_size=64, n_epochs_value=2, hidden=(16, 16))
    env, ts, buf = _setup(cfg)
    k = jax.random.PRNGKey(3)
    fn = jax.jit(jax.shard_map(
        lambda t, b: ppo.value_phase(cfg, t, b, k, "dp", "jnp",
                                     cfg.num_minibatches,
                                     cfg.minibatch_size // N)[0],
        mesh=_dp_mesh(N), in_specs=(P(), P("dp")), out_specs=P()))
    ts2 = fn(ts, buf)

    n_loc = buf.obs.shape[0] // N
    p, opt = _np(ts.v_params), _Adam(_np(ts.v_params), cfg)
    obs, tgt = np.asarray(buf.obs), np.asarray(buf.target)
    grad = jax.jit(jax.grad(lambda p, o, t: jnp.mean(jnp.square(
        mlp.apply(p, o, cfg.activation)[..., 0] - t))))
    for key_e in jax.random.split(k, cfg.n_epochs_value):
        local = _minibatches(cfg, key_e, n_loc, cfg.minibatch_size // N)
        for j in range(cfg.num_minibatches):
            idx = np.concatenate([s * n_loc + local[j] for s in range(N)])
            p = opt.step(p, grad(p, obs[idx], tgt[idx]), cfg.lr_v)
    assert int(ts2.opt_v.t) == opt.t
    _assert_tree_close(ts2.v_params, p)


def test_bf16_update_step_tracks_float32():
    """The bf16 backend runs the same phases with bf16 matmul operands:
    one update lands within bf16 rounding of the float32 one."""
    cfg = PPOConfig(env="pendulum", n_envs=8, rollout_len=64,
                    minibatch_size=128, n_epochs_value=2, n_epochs_policy=2,
                    hidden=(32, 32))
    env, ts, _ = _setup(cfg)
    traj, _ = ppo.rollout(cfg, env, ts.policy_params, jax.random.PRNGKey(1),
                          cfg.n_envs, cfg.rollout_len, "jnp")
    k = jax.random.PRNGKey(9)
    ts_j, m_j = jax.jit(lambda t: ppo.update_step(cfg, env, t, traj, k))(ts)
    ts_b, m_b = jax.jit(lambda t: ppo.update_step(
        cfg, env, t, traj, k, backend="bf16"))(ts)
    assert float(m_b.value_loss) == pytest.approx(float(m_j.value_loss),
                                                  rel=5e-2)
    for a, b in zip(jax.tree.leaves(ts_j.v_params),
                    jax.tree.leaves(ts_b.v_params)):
        a, b = np.asarray(a), np.asarray(b)
        assert np.linalg.norm(b - a) <= 5e-2 * np.linalg.norm(a)
