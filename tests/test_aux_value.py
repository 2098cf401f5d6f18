"""PPG-style auxiliary value head on the policy trunk (aux_value_coeff).

The recall_long seed-trap's measured anatomy:
the CRITIC finds the cue through supervised value regression within ~3
epochs while the POLICY trunk stays cue-blind — zero head readout means
no surrogate gradient into its attention (a chicken-and-egg plateau).
The stabilizer trains an auxiliary scalar head on the policy trunk
against the fit's value targets during the policy phase (Cobbe et al.
2020, Phasic Policy Gradient), injecting the supervised cue-finding
signal into the policy encoder.  Default-off; attention trunks only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ppoc_tpu import PPOConfig, Trainer
from ppoc_tpu import config as config_mod


def _cfg(**kw):
    base = dict(env="recall", n_envs=8, rollout_len=6, minibatch_size=48,
                fits_per_epoch=2, eval_envs=16, eval_len=6, hidden=(16,),
                seed=0, attn_dim=8, attn_layers=1, attn_heads=2)
    base.update(kw)
    return PPOConfig(**base)


def test_default_off_is_identical():
    """aux_value_coeff=0 leaves params and training bit-identical to the
    pre-feature behavior (no aux_head key, same PRNG stream)."""
    t0 = Trainer(_cfg())
    assert "aux_head" not in t0.state.policy_params["mlp"]
    t1 = Trainer(_cfg(aux_value_coeff=0.0))
    for a, b in zip(jax.tree.leaves(t0.state), jax.tree.leaves(t1.state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_aux_head_trains_and_reaches_trunk():
    """With the coeff on, the aux head AND the trunk receive auxiliary
    gradient: aux-head weights move, and the trunk's trajectory diverges
    from the coeff=0 run (same seed) — the injection is real."""
    tr_off = Trainer(_cfg())
    tr_on = Trainer(_cfg(aux_value_coeff=1.0))
    aux0 = jax.tree.map(np.asarray, tr_on.state.policy_params["mlp"]["aux_head"])
    tr_off.train_epoch()
    tr_on.train_epoch()
    aux1 = tr_on.state.policy_params["mlp"]["aux_head"]
    moved = any(not np.array_equal(a, np.asarray(b))
                for a, b in zip(jax.tree.leaves(aux0), jax.tree.leaves(aux1)))
    assert moved, "aux head got no gradient"
    w_off = tr_off.state.policy_params["mlp"]["attn"]["embed"][0]
    w_on = tr_on.state.policy_params["mlp"]["attn"]["embed"][0]
    assert not np.array_equal(np.asarray(w_off), np.asarray(w_on)), \
        "aux loss never reached the policy trunk"
    assert np.isfinite(tr_on.evaluate().R)


def test_checkpoint_roundtrip_kind5(tmp_path):
    """kind-5 trunks (attn + aux head) round-trip bit-exactly including
    the flat Adam moments, and resumed training stays bit-equal."""
    tr = Trainer(_cfg(aux_value_coeff=0.5))
    tr.train_epoch()
    p = str(tmp_path / "aux.bin")
    tr.save(p)
    tr2 = Trainer.from_checkpoint(p)
    assert tr2.cfg.aux_value_coeff == 0.5
    assert "aux_head" in tr2.state.policy_params["mlp"]
    for a, b in zip(jax.tree.leaves(tr.state), jax.tree.leaves(tr2.state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    tr.train_epoch()
    tr2.train_epoch()
    for a, b in zip(jax.tree.leaves(tr.state), jax.tree.leaves(tr2.state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_serving_ignores_aux_head(tmp_path):
    """The decode/serving path acts through the action head only — an
    aux-head checkpoint serves like any other attention checkpoint."""
    from ppoc_tpu import serve

    tr = Trainer(_cfg(aux_value_coeff=1.0))
    p = str(tmp_path / "aux_serve.bin")
    tr.save(p)
    act = serve.load_attention_policy(p)
    s = act.initial_state(4)
    a, s = act(jnp.zeros((4, tr.env.spec.obs_dim)), s)
    assert np.asarray(a).shape == (4, tr.env.spec.action_dim)


def test_validation():
    with pytest.raises(ValueError, match="attention family"):
        config_mod.validate(PPOConfig(env="pendulum", aux_value_coeff=1.0))
    with pytest.raises(ValueError, match="sequence parallel"):
        config_mod.validate(_cfg(aux_value_coeff=1.0, sp_size=2,
                                 rollout_len=8))
