"""Host-environment protocol + trainer: any host-stepped env feeds the
jitted device learner.

Generalizes the actor/learner split the reference hard-codes (CPU rollouts
into the GPU update, src/ppo.cu:479-539) into a protocol:

    venv.spec                  -> EnvSpec
    venv.reset() -> obs        [n, obs_dim]
    venv.step(a) -> (obs_after, next_obs, reward, terminated, truncated)

where ``next_obs`` is the TRUE successor (GAE bootstrap source) and
``obs_after`` is post-auto-reset (what the policy acts on next) — the
semantics of collect_trajectories (src/ppo.cu:54-79).

Implementations: :class:`ppoc_tpu.envs.gym_bridge.GymVecEnv` (any Gymnasium
env) and :class:`NativeHostVecEnv` below (the C++ engine from
ppoc_tpu/native — the reference's "CPU env in native code" path,
src/env.c, running n instances vectorized).
"""
from __future__ import annotations

import functools
import time
from typing import Any, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ppoc_tpu.algo import ppo
from ppoc_tpu.config import PPOConfig
from ppoc_tpu.envs.core import Env, EnvSpec
from ppoc_tpu.models import policy as policy_mod


class NativeHostVecEnv:
    """Host-protocol adapter over the C++ vectorized engine
    (ppoc_tpu.native.NativeVecEnv) with per-env auto-reset."""

    def __init__(self, name: str, n_envs: int, seed: int = 0):
        from ppoc_tpu import envs as jax_envs
        from ppoc_tpu import native

        self._nat = native.NativeVecEnv(name, n_envs)
        self._resetter = native.NativeVecEnv(name, n_envs)
        self.n_envs = n_envs
        self._seed = seed
        self._episode = 0
        # reuse the registry spec so hyperparameters (gamma, horizon) match
        self.spec: EnvSpec = jax_envs.make(name).spec

    def reset(self) -> np.ndarray:
        self._episode += 1
        return self._nat.reset(seed=self._seed + 7919 * self._episode)

    def step(self, actions: np.ndarray):
        a = np.ascontiguousarray(actions, np.float32).reshape(self.n_envs, -1)
        next_obs, reward, term, trunc = self._nat.step(a)
        done = term | trunc
        obs_after = next_obs.copy()
        if done.any():
            # Reset only the finished instances, sourced from a freshly
            # seeded full batch (the C++ reset is vectorized and ~ns/env, so
            # the O(n) refresh is cheaper than plumbing partial resets
            # through the C ABI).
            idx = np.nonzero(done)[0]
            self._episode += 1
            fresh = self._resetter.reset(seed=self._seed + 7919 * self._episode)
            self._nat.states[idx] = self._resetter.states[idx]
            self._nat.steps[idx] = 0
            obs_after[idx] = fresh[idx]
        return obs_after, next_obs, reward, term, trunc

    def close(self):
        pass


class HostPolicy:
    """Numpy mirror of the policy for HOST-side rollouts.

    This is the reference's CPU actor reborn: forward_propagation with BLAS
    + sampling on the host (src/policy.cu:76-89, src/neural_network.cu:163),
    with weights synced from the device ONCE per fit (policy_to_host parity,
    src/ppo.cu:536-538) — so a rollout makes ZERO device round trips, vs one
    per step for the device sampler.  Where the per-step host-device
    crossing dominates, this removes it.

    Forward math mirrors models/policy.py exactly in float32; log-probs are
    what the learner later consumes as the "old" log-probs, so host/device
    float noise cancels by construction (the same stored value enters the
    ratio).
    """

    def __init__(self, policy_params, activation: str, discrete: bool,
                 moe_topk: int = 0):
        host = jax.device_get(policy_params)
        trunk = host["mlp"]
        if isinstance(trunk, dict) and "experts" in trunk:
            # mixture-of-experts trunk (models/moe.py): numpy twin of
            # moe.apply with dense compute + optional top-k gating
            self.router = tuple(np.asarray(a, np.float32)
                                for a in trunk["router"])
            self.experts = [
                (np.asarray(w, np.float32), np.asarray(b, np.float32))
                for w, b in trunk["experts"]
            ]
            self.layers = None
            self.moe_topk = moe_topk
        else:
            self.layers = [(np.asarray(w, np.float32), np.asarray(b, np.float32))
                           for w, b in trunk]
        self.log_std = (None if discrete
                        else np.asarray(host["log_std"], np.float32))
        self.discrete = discrete
        if activation == "relu":
            self.act = lambda x: np.maximum(x, 0.0)
        elif activation == "tanh":
            self.act = np.tanh
        elif activation == "none":
            self.act = lambda x: x
        else:
            raise KeyError(f"unknown activation {activation!r}")

    def forward(self, obs: np.ndarray) -> np.ndarray:
        h = np.asarray(obs, np.float32)
        if self.layers is None:
            return self._forward_moe(h)
        n = len(self.layers)
        for i, (w, b) in enumerate(self.layers):
            h = h @ w + b
            if i < n - 1:
                h = self.act(h)
        return h

    def _forward_moe(self, x: np.ndarray) -> np.ndarray:
        """Numpy twin of models/moe.apply (dense gating, f32)."""
        wr, br = self.router
        logits = x @ wr + br
        logits = logits - logits.max(axis=-1, keepdims=True)
        g = np.exp(logits)
        g /= g.sum(axis=-1, keepdims=True)
        e = g.shape[-1]
        if 0 < self.moe_topk < e:
            idx = np.argsort(-g, axis=-1)[..., : self.moe_topk]
            mask = np.zeros_like(g)
            np.put_along_axis(mask, idx, 1.0, axis=-1)
            g = g * mask
            g /= np.maximum(g.sum(axis=-1, keepdims=True), 1e-9)
        w0, b0 = self.experts[0]
        h = np.einsum("bi,eio->beo", x, w0) + b0
        for l in range(1, len(self.experts)):
            h = self.act(h)
            w, b = self.experts[l]
            h = np.einsum("beo,eoh->beh", h, w) + b
        return np.einsum("be,beo->bo", g, h).astype(np.float32)

    def sample(self, obs: np.ndarray, rng: np.random.Generator,
               deterministic: bool = False):
        """(action, log_prob) for a batch of observations; mirrors
        policy.gaussian_sample / categorical_sample.  ``deterministic``
        serves the Gaussian mean / categorical argmax (the serve.py policy;
        log_probs are still those of the returned action under the
        stochastic policy)."""
        out = self.forward(obs)
        if self.discrete:
            logits = out - out.max(axis=-1, keepdims=True)
            logp_all = logits - np.log(
                np.sum(np.exp(logits), axis=-1, keepdims=True)
            )
            if deterministic:
                a = np.argmax(logits, axis=-1)
            else:
                # Gumbel-max sampling (numpy twin of jax.random.categorical)
                g = rng.gumbel(size=logits.shape).astype(np.float32)
                a = np.argmax(logits + g, axis=-1)
            lp = np.take_along_axis(logp_all, a[:, None], axis=-1)[:, 0]
            return a[:, None].astype(np.int32), lp.astype(np.float32)
        if deterministic:
            k = out.shape[-1]
            lp = (-0.5 * k * np.log(2.0 * np.pi)
                  - np.sum(self.log_std, axis=-1)) * np.ones(out.shape[0])
            return out.astype(np.float32), lp.astype(np.float32)
        mu = out
        eps = rng.standard_normal(mu.shape).astype(np.float32)
        action = mu + eps * np.exp(self.log_std)
        k = action.shape[-1]
        z = (action - mu) * np.exp(-self.log_std)
        lp = (-0.5 * k * np.log(2.0 * np.pi)
              - np.sum(self.log_std + 0.5 * np.square(z), axis=-1))
        return action.astype(np.float32), lp.astype(np.float32)


def collect_host_np(
    cfg: PPOConfig,
    venv,
    policy: HostPolicy,
    rng: np.random.Generator,
    length: int,
    obs0: Optional[np.ndarray] = None,
    force_truncate: bool = True,
    deterministic: bool = False,
) -> Tuple[ppo.Transition, np.ndarray]:
    """All-host rollout: numpy policy + host venv, zero device traffic.

    Same contract as :func:`collect_host`; the trajectory crosses to the
    device ONCE at the end (the reference's buffer_to_device,
    src/ppo.cu:485)."""
    obs = venv.reset() if obs0 is None else obs0
    rows = []
    for _ in range(length):
        action, log_prob = policy.sample(obs, rng, deterministic)
        obs_after, next_obs, reward, term, trunc = venv.step(action)
        rows.append((obs, action, log_prob, next_obs, reward, term, trunc))
        obs = obs_after
    stack = [np.stack(x) for x in zip(*rows)]
    if force_truncate:  # (src/ppo.cu:70-74); eval keeps genuine flags
        stack[6][-1] |= ~stack[5][-1]
    traj = ppo.Transition(*[jnp.asarray(x) for x in stack])
    return traj, obs


@functools.lru_cache(maxsize=32)
def _sampler(activation: str, backend: str, discrete: bool):
    """One persistent jitted sampler per (activation, backend, discrete) —
    a fresh jax.jit wrapper per rollout would retrace/recompile every fit."""
    return jax.jit(functools.partial(
        policy_mod.sample, activation=activation, backend=backend, discrete=discrete,
    ))


def collect_host(
    cfg: PPOConfig,
    venv,
    policy_params,
    key: jax.Array,
    length: int,
    backend: str = "jnp",
    obs0: Optional[np.ndarray] = None,
    force_truncate: bool = True,
) -> Tuple[ppo.Transition, np.ndarray]:
    """Host rollout loop against any host-protocol venv: device policy (one
    batched sample call per step), host env stepping — collect_trajectories
    (src/ppo.cu:54-79) with n_envs instances in lockstep.

    ``obs0=None`` resets the venv at entry; passing the previous call's
    returned observation continues the same episodes (reset_per_fit=False).
    Returns (trajectory, last observation)."""
    sample = _sampler(cfg.activation, backend, venv.spec.discrete)
    obs = venv.reset() if obs0 is None else obs0
    rows = []
    for _ in range(length):
        key, k = jax.random.split(key)
        action, log_prob = jax.device_get(sample(policy_params, jnp.asarray(obs), k))
        obs_after, next_obs, reward, term, trunc = venv.step(np.asarray(action))
        rows.append((obs, action, np.asarray(log_prob), next_obs, reward, term, trunc))
        obs = obs_after
    stack = [np.stack(x) for x in zip(*rows)]
    traj = ppo.Transition(*[jnp.asarray(x) for x in stack])
    if force_truncate:  # (src/ppo.cu:70-74); eval keeps genuine flags
        last_trunc = jnp.logical_or(
            traj.truncated[-1], jnp.logical_not(traj.terminated[-1])
        )
        traj = traj._replace(truncated=traj.truncated.at[-1].set(last_trunc))
    return traj, obs


class HostTrainer:
    """Trainer over host-protocol envs: host actor + jitted device learner.

    API-compatible subset of :class:`ppoc_tpu.algo.trainer.Trainer`
    (train / train_epoch / evaluate / save / load).
    """

    def __init__(self, cfg: PPOConfig, venv, eval_venv, backend: str = "jnp",
                 actor: str = "device", overlap: bool = False):
        if venv.n_envs != cfg.n_envs:
            raise ValueError(
                f"venv has {venv.n_envs} envs but cfg.n_envs is {cfg.n_envs} "
                f"— the minibatch schedule (cfg.num_minibatches) is derived "
                f"from cfg.n_envs * rollout_len"
            )
        if eval_venv.n_envs != cfg.eval_envs:
            raise ValueError(
                f"eval_venv has {eval_venv.n_envs} envs but cfg.eval_envs "
                f"is {cfg.eval_envs}"
            )
        if cfg.num_minibatches < 1:
            raise ValueError(
                f"minibatch_size ({cfg.minibatch_size}) exceeds steps_per_fit "
                f"({cfg.steps_per_fit}): zero minibatches, nothing would train"
            )
        if actor not in ("device", "host"):
            raise ValueError(f"actor must be 'device' or 'host', got {actor!r}")
        if overlap and actor != "host":
            raise ValueError(
                "overlap=True requires actor='host': the device actor's "
                "per-step sampling would serialize against the in-flight "
                "update it is meant to hide"
            )
        if cfg.zero1:
            raise ValueError(
                "zero1 is not supported on the host bridge: its learner "
                "runs single-device (no mesh to shard optimizer state over)"
            )
        if getattr(cfg, "obs_loc", ()):
            raise ValueError(
                "obs_loc/obs_scale apply to on-device envs "
                "(envs.make_for); host-bridge envs use the running "
                "normalization wrappers (obs_norm=True)"
            )
        if cfg.rnn_hidden > 0 or cfg.attn_dim > 0:
            raise ValueError(
                "rnn_hidden/attn_dim > 0 (sequence trunks) is not supported "
                "on the host bridge: the host actor and the learner's row "
                "minibatching are stateless; use an on-device env "
                "(e.g. 'pendulum_po', 'recall') for sequence training"
            )
        self.cfg = cfg
        self.venv = venv
        self.eval_venv = eval_venv
        # spec-only Env shell for the learner (reset/step never called)
        self.env = Env(spec=venv.spec, reset=None, step=None)
        if cfg.n_experts > 1:
            # MoE trunks: the learner must compute log-probs under the SAME
            # gating the actor samples with — encode moe_topk into the
            # backend string (mlp.apply would otherwise parse a plain "jnp"
            # as dense topk=0 gating while HostPolicy uses top-k, corrupting
            # the PPO ratios)
            from ppoc_tpu.models import mlp as mlp_mod

            backend = mlp_mod.moe_backend(
                "bf16" if backend == "bf16" else "jnp", cfg.moe_topk)
        self.backend = backend
        # "host": numpy policy on the host, weights fetched once per fit
        # (the reference's actor/learner split, src/ppo.cu:479-539);
        # "device": batched device sampling, one round trip per step.
        self.actor = actor
        self.key = jax.random.PRNGKey(cfg.seed)
        k_init, self.key = jax.random.split(self.key)
        self.state = ppo.init_train_state(cfg, self.env, k_init)
        self._update = jax.jit(functools.partial(
            ppo.update_step, cfg, self.env, backend=self.backend
        ))
        self._obs = None  # persistent rollout obs when reset_per_fit=False
        # overlap=True: the actor collects window i+1 while the device fits
        # window i (see train_epoch); the next window rides here
        self.overlap = overlap
        self._pending = None

    def _host_rng(self, key) -> np.random.Generator:
        return np.random.default_rng(
            [int(x) for x in np.asarray(jax.device_get(key), np.uint32).ravel()]
        )

    def _collect(self, k_roll):
        """One training window against self.venv with the CURRENT device
        weights; threads the persistent obs for reset_per_fit=False."""
        obs0 = None if self.cfg.reset_per_fit else self._obs
        if self.actor == "host":
            pol = HostPolicy(self.state.policy_params, self.cfg.activation,
                             self.env.spec.discrete,
                             moe_topk=self.cfg.moe_topk)
            traj, last_obs = collect_host_np(
                self.cfg, self.venv, pol, self._host_rng(k_roll),
                self.cfg.rollout_len, obs0=obs0,
            )
        else:
            traj, last_obs = collect_host(
                self.cfg, self.venv, self.state.policy_params, k_roll,
                self.cfg.rollout_len, self.backend, obs0=obs0,
            )
        if not self.cfg.reset_per_fit:
            self._obs = last_obs
        return traj

    def train_fit(self):
        k_roll, k_upd, self.key = jax.random.split(self.key, 3)
        traj = self._collect(k_roll)
        self.state, metrics = self._update(self.state, traj, k_upd)
        return metrics

    def _train_fit_overlapped(self):
        """Actor/learner overlap (beats the reference's strictly serial
        loop, src/ppo.cu:479-539): dispatch the jitted update for window i
        (JAX async dispatch returns immediately), then collect window i+1
        on the host WHILE the device crunches — with the pre-update
        (one-fit-stale) actor weights, whose HostPolicy fetch reads an
        already-materialized buffer and does not block on the in-flight
        update.  Off-policy delta: each window's data is one Adam-phase
        stale relative to the params it updates; PPO's ratio uses the
        STORED log-probs, so the objective stays well-formed — the clip
        just sees slightly larger ratios.  Measured learning curves match
        the serial loop (tests/test_host_trainer.py; chip A/B in
        docs/RESULTS.md)."""
        k_roll, k_upd, self.key = jax.random.split(self.key, 3)
        if self._pending is None:      # prime: synchronous first window
            self._pending = self._collect(k_roll)
            k_roll, self.key = jax.random.split(self.key)
        traj = self._pending
        new_state, metrics = self._update(self.state, traj, k_upd)
        self._pending = self._collect(k_roll)   # overlaps with the update
        self.state = new_state
        return metrics

    def train_epoch(self):
        fit = self._train_fit_overlapped if self.overlap else self.train_fit
        all_metrics = [fit() for _ in range(self.cfg.fits_per_epoch)]
        # mean over fits, matching the device trainer's per-epoch metrics
        return jax.tree.map(lambda *xs: jnp.mean(jnp.stack(xs)), *all_metrics)

    def evaluate(self, deterministic: bool = False) -> ppo.EvalMetrics:
        """Stochastic-policy eval by default (reference parity,
        src/ppo.cu:560-583); ``deterministic=True`` serves the Gaussian
        mean / categorical argmax — the canonical 'solved' protocol for
        benchmark envs — via the host numpy policy."""
        k, self.key = jax.random.split(self.key)
        if self.actor == "host" or deterministic:
            pol = HostPolicy(self.state.policy_params, self.cfg.activation,
                             self.env.spec.discrete,
                             moe_topk=self.cfg.moe_topk)
            traj, _ = collect_host_np(
                self.cfg, self.eval_venv, pol, self._host_rng(k),
                self.cfg.eval_len, force_truncate=False,
                deterministic=deterministic,
            )
        else:
            traj, _ = collect_host(
                self.cfg, self.eval_venv, self.state.policy_params, k,
                self.cfg.eval_len, self.backend, force_truncate=False,
            )
        if getattr(self.cfg, "eval_estimator", "completed") == "reference":
            m = ppo.eval_metrics_reference(traj, self.env.spec.gamma)
        else:
            m = ppo.eval_metrics_from_traj(traj, self.env.spec.gamma)
        return jax.tree.map(float, jax.device_get(m))

    def train(self, n_epochs: Optional[int] = None, log: bool = True,
              stop_at_R: Optional[float] = None,
              checkpoint_path: Optional[str] = None,
              checkpoint_every: int = 1,
              initial_eval: bool = False,
              eval_deterministic: bool = False,
              on_epoch_end=None,
              epoch_offset: int = 0) -> List[dict]:
        """Epoch loop; same signature as Trainer.train (periodic checkpoints
        included — NOTE host env objects are not serializable, so a resumed
        host run restores optimization state + RNG but starts from fresh env
        resets).  ``initial_eval`` defaults False here: a host eval costs a
        full eval_len rollout of real env stepping.  ``eval_deterministic``
        scores epochs (and stop_at_R) with the mean policy — the canonical
        benchmark protocol.  ``on_epoch_end(i, row)`` is called after each
        epoch's checkpoint; truthy return stops training cleanly (the CLI's
        graceful-preemption hook, same contract as Trainer.train)."""
        n_epochs = self.cfg.n_epochs if n_epochs is None else n_epochs
        history: List[dict] = []
        if initial_eval:
            m0 = self.evaluate(deterministic=eval_deterministic)
            if log:
                print(f"J: {m0.J:f} R: {m0.R:f} Episodes: {int(m0.episodes)}",
                      flush=True)
        for i in range(n_epochs):
            tic = time.perf_counter()
            fm = self.train_epoch()
            fm = jax.tree.map(float, jax.device_get(fm))
            toc = time.perf_counter()  # train time only, like Trainer.train
            ev = self.evaluate(deterministic=eval_deterministic)
            row = {"epoch": i, "entropy": fm.entropy,
                   "time_s": toc - tic,
                   "J": ev.J, "R": ev.R, "episodes": int(ev.episodes)}
            history.append(row)
            if log:
                print(f"Epoch: {i} Entropy: {row['entropy']:f} "
                      f"Time {row['time_s']:f}s J: {row['J']:f} R: {row['R']:f} "
                      f"Episodes: {row['episodes']}", flush=True)
            if (checkpoint_path is not None and checkpoint_every > 0
                    and (i + 1) % checkpoint_every == 0):
                self.save(checkpoint_path,
                          meta={"epochs_done": epoch_offset + i + 1})
            if stop_at_R is not None and ev.R >= stop_at_R:
                break
            if on_epoch_end is not None and on_epoch_end(i, row):
                break
        return history

    def save(self, path: str, meta=None) -> None:
        from ppoc_tpu.envs.wrappers import RunningObsNorm
        from ppoc_tpu.utils import checkpoint
        # checkpoint.save clears any stale normalization sidecars at this
        # path EXCEPT the ones this trainer owns and re-writes (atomically,
        # via rename) right below — the binary checkpoint layout is a frozen
        # contract, so stats ride alongside
        stats = getattr(self.venv, "stats", None)
        rstats = getattr(self.venv, "ret_stats", None)
        keep = tuple(
            s for s, present in ((".obsnorm.npz", stats is not None),
                                 (".retnorm.npz", rstats is not None))
            if present)
        checkpoint.save(path, self.cfg, self.env.spec, self.state,
                        key=self.key, keep_sidecars=keep, meta=meta)
        if stats is not None:
            # clip/eps live on the RunningObsNorm wrapper that OWNS the obs
            # stats (stacked wrappers re-expose them via a pass-through
            # property) — walk the chain to it
            owner = self.venv
            while owner is not None and not isinstance(owner, RunningObsNorm):
                owner = getattr(owner, "venv", None)
            owner = owner if owner is not None else self.venv
            stats.save(path + ".obsnorm.npz",
                       clip=np.float64(getattr(owner, "clip", 10.0)),
                       eps=np.float64(getattr(owner, "eps", 1e-8)))
        if rstats is not None:
            rstats.save(path + ".retnorm.npz")

    def load(self, path: str) -> None:
        """Restore optimizer state + PRNG key (+ obs-norm statistics when
        the venv is norm-wrapped and the sidecar exists).  NOTE: unlike the
        device Trainer, host envs (live Gymnasium objects) are not
        serializable, so a resumed host run continues from fresh env resets —
        optimization state is exact, the env stream is not."""
        import os
        import warnings

        from ppoc_tpu.utils import checkpoint
        ck = checkpoint.load(path, template=self.state)
        self.state = ck.state
        if ck.key is not None:
            self.key = ck.key
        # overlap mode: a pending window was collected by the PRE-load
        # policy with its log-probs — consuming it would make the first
        # post-load update an uncontrolled off-policy step (far beyond the
        # documented one-fit-stale contract); drop it so the next fit
        # primes a fresh window under the loaded weights
        self._pending = None
        stats = getattr(self.venv, "stats", None)
        sidecar = path + ".obsnorm.npz"
        if os.path.exists(sidecar):
            if stats is None:
                warnings.warn(
                    f"{path} was trained with running obs normalization "
                    f"({sidecar} exists) but this trainer's venv is not "
                    f"norm-wrapped (obs_norm=False?) — the restored policy "
                    f"would see RAW observations and misbehave")
            else:
                loaded = np.load(sidecar)
                stats.load_state_dict(loaded)
                # an eval venv with its OWN stats object (not shared with
                # the train venv) must be restored too
                estats = getattr(self.eval_venv, "stats", None)
                if estats is not None and estats is not stats:
                    estats.load_state_dict(loaded)
        elif stats is not None:
            warnings.warn(
                f"{path} has no obs-norm sidecar but this trainer's venv is "
                f"norm-wrapped — the checkpoint was trained on raw "
                f"observations; statistics start from scratch")
        rstats = getattr(self.venv, "ret_stats", None)
        if rstats is not None and os.path.exists(path + ".retnorm.npz"):
            rstats.load_state_dict(np.load(path + ".retnorm.npz"))
