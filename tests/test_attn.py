"""Attention model family: mask math, decode/parallel duality, PPO
integration.

The reference has no attention at all (SURVEY §2a: its only sequence
machinery is the GAE scan over time); models/attn.py + algo/recurrent.py
extend the trunk slot with a causal Transformer encoder — the framework's
fourth model family.  Tests cover:

  * decode/parallel duality: the rollout's KV-cache decode (attn.step) and
    the trainer's parallel pass (attn.apply_seq) compute identical outputs;
  * decode_next: the vectorized one-step decode used for the V(s') GAE
    bootstrap equals the shifted parallel outputs at episode-continuing
    steps;
  * episode-boundary masking (tokens must not attend across a done);
  * rollout/update consistency: replayed log-probs match stored ones, so
    first-epoch PPO ratios are 1;
  * the capability differentiator on the `recall` memory env — same bar as
    the GRU family (tests/test_rnn.py);
  * dp-mesh training, checkpoint round-trip (v4 kind-4 trunks),
    from_checkpoint, KV-cache serving, and config validation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ppoc_tpu import PPOConfig, envs
from ppoc_tpu.algo import ppo, recurrent
from ppoc_tpu.algo.trainer import Trainer
from ppoc_tpu.models import attn


def _params(key=0, T=12, obs_dim=4, d=16, layers=2, heads=2, out=2):
    return attn.init(jax.random.PRNGKey(key), obs_dim, d, layers, heads,
                     2 * d, T, (d, 8, out))


def test_decode_matches_parallel():
    """The sequential KV-cache decode (rollout path) reproduces the parallel
    causal-episode-masked pass (update path) step for step."""
    T, E = 12, 3
    p = _params(T=T)
    xs = jax.random.normal(jax.random.PRNGKey(1), (T, E, 4))
    done = jax.random.bernoulli(jax.random.PRNGKey(2), 0.25, (T, E))

    out_par = attn.apply_seq(p, xs, done, "relu")
    cache = attn.initial_cache(p, (E,))
    outs = []
    for t in range(T):
        cache, o = attn.step(p, cache, xs[t], "relu")
        outs.append(o)
        cache = attn.reset_lanes(cache, done[t])
    np.testing.assert_allclose(
        np.asarray(jnp.stack(outs)), np.asarray(out_par), atol=1e-5)


def test_decode_next_matches_shifted_parallel():
    """decode_next(x_{t+1} at pos t+1 over context <= t) must equal the
    parallel pass's row t+1 wherever the episode continues — the property
    that makes it a valid V(s') estimator (compute_values_rnn)."""
    T, E = 10, 4
    p = _params(T=T, out=1)
    xs = jax.random.normal(jax.random.PRNGKey(3), (T, E, 4))
    done = jax.random.bernoulli(jax.random.PRNGKey(4), 0.2, (T, E))
    out_par, ks, vs = attn.apply_seq(p, xs, done, "relu", with_cache=True)
    mask = attn.causal_episode_mask(done)
    pos_idx = jnp.minimum(jnp.arange(T) + 1, T - 1)
    nxt = attn.decode_next(
        p, jnp.roll(xs, -1, axis=0), pos_idx, ks, vs, mask, "relu")
    cont = np.asarray(~done & (jnp.arange(T)[:, None] < T - 1))
    got = np.asarray(nxt)[cont]
    want = np.asarray(jnp.roll(out_par, -1, axis=0))[cont]
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_decode_next_chunked_matches_direct():
    """The T > 256 path pads/reshapes the query axis through lax.map; it
    must equal the direct (unchunked) computation exactly."""
    T, E = 300, 2
    p = _params(T=T + 1, out=1)
    xs = jax.random.normal(jax.random.PRNGKey(8), (T, E, 4))
    done = jax.random.bernoulli(jax.random.PRNGKey(9), 0.1, (T, E))
    _, ks, vs = attn.apply_seq(p, xs, done, "relu", with_cache=True)
    mask = attn.causal_episode_mask(done)
    pos_idx = jnp.arange(T) + 1
    nxt = jnp.roll(xs, -1, axis=0)
    chunked = attn.decode_next(p, nxt, pos_idx, ks, vs, mask, "relu")
    direct = attn._decode_next(p, nxt, pos_idx, ks, vs, mask, "relu")
    np.testing.assert_allclose(np.asarray(chunked), np.asarray(direct),
                               atol=1e-6)


def test_old_checkpoint_pos_table_migrates(tmp_path):
    """Attention checkpoints written before the +1 positional-table change
    load via the adapt_to_template shim (zero-padded pos row + aligned
    Adam moments) instead of failing the shape check."""
    import dataclasses
    import io

    from ppoc_tpu.utils import checkpoint as ck_mod

    cfg = PPOConfig(env="recall", n_envs=8, rollout_len=6, minibatch_size=24,
                    fits_per_epoch=1, eval_envs=8, eval_len=6, hidden=(8,),
                    attn_dim=8, attn_layers=1, attn_heads=2, seed=0)
    tr = Trainer(cfg)
    # forge the OLD layout: strip the extra pos row from a fresh state
    old = jax.device_get(tr.state)

    def strip(trunk):
        a = dict(trunk["attn"])
        a["pos"] = a["pos"][:-1]
        return dict(trunk, attn=a)

    pol = dict(old.policy_params)
    pol["mlp"] = strip(old.policy_params["mlp"])
    fixm = lambda t, ref: jax.tree.map(
        lambda x, n: x[:-1] if (np.ndim(x) == 2 and np.ndim(n) == 2
                                and np.shape(x)[0] == np.shape(n)[0] + 1
                                ) else x, t, ref)
    old = old._replace(
        policy_params=pol,
        v_params=strip(old.v_params),
        opt_policy=old.opt_policy._replace(
            m=fixm(old.opt_policy.m, pol["mlp"]),
            v=fixm(old.opt_policy.v, pol["mlp"])),
        opt_v=old.opt_v._replace(
            m=fixm(old.opt_v.m, strip(jax.device_get(tr.state).v_params)),
            v=fixm(old.opt_v.v, strip(jax.device_get(tr.state).v_params))),
    )
    path = str(tmp_path / "old_attn.bin")
    ck_mod.save(path, cfg, tr.env.spec, old, key=tr.key)
    tr2 = Trainer.from_checkpoint(path)
    # padded row is zeros; everything else byte-identical
    pos2 = jax.device_get(tr2.state.policy_params["mlp"]["attn"]["pos"])
    pos_old = jax.device_get(old.policy_params["mlp"]["attn"]["pos"])
    assert pos2.shape[0] == pos_old.shape[0] + 1
    assert np.array_equal(pos2[:-1], pos_old) and (pos2[-1] == 0).all()


def test_mask_blocks_cross_episode_attention():
    """Tokens after a done must be unaffected by anything before it: replace
    the pre-boundary observations with noise and the post-boundary outputs
    must not move (positions are window-absolute, so a fresh-start replay
    is NOT the invariant — invariance to the masked-out content is)."""
    T, E = 8, 3
    p = _params(T=T)
    xs = jax.random.normal(jax.random.PRNGKey(5), (T, E, 4))
    done = jnp.zeros((T, E), bool).at[2].set(True)
    ys = attn.apply_seq(p, xs, done, "relu")
    xs2 = xs.at[:3].set(jax.random.normal(jax.random.PRNGKey(6), (3, E, 4)))
    ys2 = attn.apply_seq(p, xs2, done, "relu")
    np.testing.assert_allclose(
        np.asarray(ys[3:]), np.asarray(ys2[3:]), atol=1e-6)
    # and WITHOUT the done flag the tails DO move (attention really flows)
    ys3 = attn.apply_seq(p, xs2, jnp.zeros((T, E), bool), "relu")
    assert not np.allclose(np.asarray(ys3[3:]), np.asarray(ys[3:]), atol=1e-4)


def test_window_overflow_raises():
    p = _params(T=6)
    xs = jnp.zeros((8, 2, 4))
    with pytest.raises(ValueError, match="positional table"):
        attn.apply_seq(p, xs, jnp.zeros((8, 2), bool), "relu")


@pytest.mark.parametrize("env_name,discrete", [("recall", False),
                                               ("cartpole", True)])
def test_replayed_log_probs_match_rollout(env_name, discrete):
    """The update path's parallel attention recomputes the same log-probs the
    KV-cache rollout stored: epoch-0 PPO ratios are 1 (float noise only)."""
    env = envs.make(env_name)
    cfg = PPOConfig(env=env_name, n_envs=16, rollout_len=12,
                    minibatch_size=48, hidden=(16,), attn_dim=16,
                    attn_layers=2, attn_heads=2)
    assert env.spec.discrete == discrete
    ts = ppo.init_train_state(cfg, env, jax.random.PRNGKey(0))
    traj, _ = recurrent.rollout_rnn(
        cfg, env, ts.policy_params, jax.random.PRNGKey(1), 16, 12)
    done = jnp.logical_or(traj.terminated, traj.truncated)
    logp, _ = recurrent.policy_log_probs_rnn(
        cfg, ts.policy_params, traj.obs, traj.action, done, discrete)
    np.testing.assert_allclose(
        np.asarray(logp), np.asarray(traj.log_prob), rtol=1e-4, atol=1e-5)


def test_recall_differentiator():
    """Same capability bar as the GRU family: attention solves the recall
    memory task (memoryless policies cap at ~0.5, tests/test_rnn.py)."""
    cfg = PPOConfig(env="recall", n_envs=128, rollout_len=6,
                    minibatch_size=192, fits_per_epoch=8, eval_envs=256,
                    eval_len=6, kernel_backend="jnp", hidden=(32,),
                    seed=1, lr_policy=1e-3, lr_v=1e-3,
                    attn_dim=16, attn_layers=1, attn_heads=2)
    hist = Trainer(cfg).train(n_epochs=5, log=False)
    assert hist[-1]["R"] > 0.9, \
        f"attention should solve recall, got {hist[-1]['R']}"


def test_attn_trains_on_dp_mesh():
    from ppoc_tpu.parallel import make_mesh

    cfg = PPOConfig(env="recall", n_envs=128, rollout_len=6,
                    minibatch_size=192, fits_per_epoch=8, eval_envs=256,
                    eval_len=6, kernel_backend="jnp", hidden=(32,),
                    seed=1, lr_policy=1e-3, lr_v=1e-3,
                    attn_dim=16, attn_layers=1, attn_heads=2)
    hist = Trainer(cfg, mesh=make_mesh()).train(n_epochs=5, log=False)
    assert hist[-1]["R"] > 0.9


def test_checkpoint_roundtrip_and_from_checkpoint(tmp_path):
    cfg = PPOConfig(env="recall", n_envs=32, rollout_len=6,
                    minibatch_size=96, fits_per_epoch=2, eval_envs=64,
                    eval_len=6, hidden=(16,), attn_dim=8, attn_layers=1,
                    attn_heads=2, seed=1)
    tr = Trainer(cfg)
    tr.train(n_epochs=1, log=False, initial_eval=False)
    path = str(tmp_path / "attn.bin")
    tr.save(path)
    tr2 = Trainer.from_checkpoint(path)
    assert tr2.cfg.attn_dim == 8
    a = jax.tree.leaves(jax.device_get(tr.state))
    b = jax.tree.leaves(jax.device_get(tr2.state))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert int(tr2.state.opt_policy.t) == int(tr.state.opt_policy.t) > 0


def test_attention_serving(tmp_path):
    from ppoc_tpu import serve

    cfg = PPOConfig(env="recall", n_envs=128, rollout_len=6,
                    minibatch_size=192, fits_per_epoch=8, eval_envs=128,
                    eval_len=6, hidden=(32,), attn_dim=16, attn_layers=1,
                    attn_heads=2, seed=1, lr_policy=1e-3, lr_v=1e-3)
    tr = Trainer(cfg)
    tr.train(n_epochs=4, log=False)
    path = str(tmp_path / "attn_serve.bin")
    tr.save(path)
    with pytest.raises(ValueError, match="load_attention_policy"):
        serve.load_policy(path)
    with pytest.raises(ValueError, match="load_policy"):
        serve.load_recurrent_policy(path)
    act = serve.load_attention_policy(path)
    env = envs.make("recall")
    correct = 0
    for seed in range(8):
        key = jax.random.PRNGKey(100 + seed)
        state, obs = env.reset(key)
        cache = act.initial_state()
        for t in range(6):
            a, cache = act(np.asarray(obs), cache)
            state, obs, reward, term, trunc = env.step(
                state, jnp.asarray(a), key)
        correct += int(float(reward) > 0.5)
    assert correct >= 7


def test_config_validation():
    with pytest.raises(ValueError, match="reset_per_fit"):
        Trainer(PPOConfig(env="recall", attn_dim=8, reset_per_fit=False))
    with pytest.raises(ValueError, match="cannot combine"):
        Trainer(PPOConfig(env="recall", attn_dim=8, n_experts=4))
    with pytest.raises(ValueError, match="cannot combine"):
        Trainer(PPOConfig(env="recall", attn_dim=8, tp_size=2))
    with pytest.raises(ValueError, match="ONE sequence family"):
        Trainer(PPOConfig(env="recall", attn_dim=8, rnn_hidden=8))
    with pytest.raises(ValueError, match="divisible"):
        Trainer(PPOConfig(env="recall", attn_dim=9, attn_heads=2))


def test_sweep_mirrors_validation():
    from ppoc_tpu import sweep

    with pytest.raises(ValueError, match="reset_per_fit"):
        sweep._validate(
            PPOConfig(env="recall", attn_dim=8, reset_per_fit=False), [0])
    with pytest.raises(ValueError, match="ONE sequence family"):
        sweep._validate(
            PPOConfig(env="recall", attn_dim=8, rnn_hidden=8), [0])


def test_host_bridge_rejects_attention():
    from ppoc_tpu.envs.host import HostTrainer

    class _FakeVenv:
        n_envs = 4
        spec = envs.make("recall").spec

    cfg = PPOConfig(env="recall", n_envs=4, eval_envs=4, rollout_len=6,
                    minibatch_size=8, attn_dim=8)
    with pytest.raises(ValueError, match="host bridge"):
        HostTrainer(cfg, _FakeVenv(), _FakeVenv())


def test_window_extension_curriculum_seam(tmp_path):
    """The recall_xl/xxl curriculum's mechanical seam at reduced scale
    (examples/recall_xl_curriculum.py): train with eval_len > rollout_len
    so the positional table is sized for the LONGER window, checkpoint,
    then Trainer.from_checkpoint with a doubled rollout_len — parameter
    shapes (incl. the positional table) must carry over unchanged and the
    extended-window trainer must train and evaluate."""
    import warnings

    cfg1 = PPOConfig(env="recall", n_envs=8, rollout_len=6,
                     minibatch_size=48, fits_per_epoch=1, eval_envs=16,
                     eval_len=12, kernel_backend="jnp", hidden=(16,),
                     seed=0, attn_dim=8, attn_layers=1, attn_heads=2)
    tr1 = Trainer(cfg1)
    tr1.train_epoch()
    from ppoc_tpu.models import attn as attn_mod

    assert attn_mod.window(tr1.state.v_params) == 13  # max(6, 12) + 1
    p = str(tmp_path / "phase1.bin")
    tr1.save(p)

    tr2 = Trainer.from_checkpoint(p, rollout_len=12, minibatch_size=96)
    assert attn_mod.window(tr2.state.v_params) == 13
    # weights carried bit-for-bit through the window change
    for (a, _), (b, _b) in zip(
            jax.device_get(tr1.state.policy_params["mlp"]["head"]),
            jax.device_get(tr2.state.policy_params["mlp"]["head"])):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    m = jax.tree.map(float, jax.device_get(tr2.train_epoch()))
    assert np.isfinite(m.value_loss)
    ev = tr2.evaluate()
    assert ev.episodes > 0


def test_window_growth_on_load(tmp_path):
    """Positional-table GROWTH: from_checkpoint with a much longer window
    pads the pos table (and its Adam moments) with zero rows, targeting the
    pos leaf by key — each curriculum phase can train with a RIGHT-SIZED
    window instead of paying the final phase's KV length from the start."""
    import warnings

    cfg1 = PPOConfig(env="recall", n_envs=8, rollout_len=6,
                     minibatch_size=48, fits_per_epoch=1, eval_envs=16,
                     eval_len=6, kernel_backend="jnp", hidden=(16,),
                     seed=0, attn_dim=8, attn_layers=1, attn_heads=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tr1 = Trainer(cfg1)
        tr1.train_epoch()
        p = str(tmp_path / "small.bin")
        tr1.save(p)
        tr2 = Trainer.from_checkpoint(p, rollout_len=24, eval_len=24,
                                      minibatch_size=192)
    from ppoc_tpu.models import attn as attn_mod

    assert attn_mod.window(tr1.state.v_params) == 7
    assert attn_mod.window(tr2.state.v_params) == 25
    old = np.asarray(jax.device_get(
        tr1.state.policy_params["mlp"]["attn"]["pos"]))
    new = np.asarray(jax.device_get(
        tr2.state.policy_params["mlp"]["attn"]["pos"]))
    assert np.array_equal(new[:7], old)           # trained rows carried
    assert np.all(new[7:] == 0.0)                 # growth rows zero
    m_pos = np.asarray(jax.device_get(
        tr2.state.opt_policy.m["attn"]["pos"]))
    assert m_pos.shape == new.shape and np.all(m_pos[7:] == 0.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = jax.tree.map(float, jax.device_get(tr2.train_epoch()))
    assert np.isfinite(m.value_loss)


def test_window_growth_warns(tmp_path):
    """Growing the pos table by more than the one-row decode slot emits a
    UserWarning naming the old/new row counts: curriculum loads
    can silence it, accidental short-window loads surface."""
    import warnings

    cfg1 = PPOConfig(env="recall", n_envs=8, rollout_len=6,
                     minibatch_size=48, fits_per_epoch=1, eval_envs=16,
                     eval_len=6, kernel_backend="jnp", hidden=(16,),
                     seed=0, attn_dim=8, attn_layers=1, attn_heads=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tr1 = Trainer(cfg1)
        p = str(tmp_path / "small.bin")
        tr1.save(p)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        Trainer.from_checkpoint(p, rollout_len=24, eval_len=24,
                                 minibatch_size=192)
    msgs = [str(w.message) for w in rec
            if "positional table" in str(w.message)]
    assert msgs and "7 to 25" in msgs[0]
