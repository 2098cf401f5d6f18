"""Environment wrappers: observation normalization (static + running).

The reference has no wrapper layer (its env vtable is consumed raw,
include/env.h:7-15); this module adds the transforms sparse-reward and
wide-scale configs need:

- :func:`normalize_obs` — STATIC affine observation normalization over a
  pure-JAX Env.  A pure recomposition of the env's reset/step, so
  vmap/jit/scan see one fused function and the wrapped env trains at
  identical speed, and the train step stays replayable bit-for-bit from a
  checkpoint.  For the in-repo envs the true observation bounds are known,
  so the affine map is exact.
- :class:`RunningObsNorm` — RUNNING-statistics normalization over a
  host-protocol venv (envs/host.py), for Gymnasium envs whose observation
  scale is unknown a priori (BipedalWalker's lidar vs joint-velocity
  channels).  Statistics live on the host actor, so the jitted learner is
  untouched; train and eval venvs share one :class:`RunningStats` so the
  eval policy sees the same feature space it was trained in.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .core import Env, EnvSpec, register


def normalize_obs(env: Env, low, high, name: str = None) -> Env:
    """Affine-map observations from [low, high] to [-1, 1] per dimension.

    ``low``/``high`` are the per-dimension observation bounds (arrays of
    length obs_dim).  Physics, rewards and episode structure are untouched —
    the native-oracle lockstep tests of the base env remain valid.
    """
    low = jnp.asarray(low, jnp.float32)
    high = jnp.asarray(high, jnp.float32)
    mid = (high + low) / 2.0
    half = (high - low) / 2.0

    def norm(obs):
        return (obs - mid) / half

    def reset(key):
        state, obs = env.reset(key)
        return state, norm(obs)

    def step(state, action, key):
        state2, obs, reward, term, trunc = env.step(state, action, key)
        return state2, norm(obs), reward, term, trunc

    spec = EnvSpec(
        name=name or env.spec.name + "_norm",
        obs_dim=env.spec.obs_dim,
        action_dim=env.spec.action_dim,
        horizon=env.spec.horizon,
        gamma=env.spec.gamma,
        discrete=env.spec.discrete,
        action_low=env.spec.action_low,
        action_high=env.spec.action_high,
    )
    return Env(spec=spec, reset=reset, step=step)


def affine_obs(env: Env, loc, scale, name: str = None) -> Env:
    """Normalize observations as ``(obs - loc) / scale`` per dimension.

    The config-carried form of static observation normalization
    (PPOConfig.obs_loc / obs_scale): the statistics ride in the config — so
    they replay bit-exactly through checkpoints, sweeps and serving — and
    usually come from :func:`calibrate` (a random-policy measurement run).
    Physics, rewards and episode structure are untouched.

    The wrapped spec name gains an ``#affine`` suffix, so nothing keyed by
    env name mistakes the wrapped env for its base (whose raw
    observations differ).
    """
    loc = jnp.asarray(loc, jnp.float32)
    scale = jnp.asarray(scale, jnp.float32)

    def norm(obs):
        return (obs - loc) / scale

    def reset(key):
        state, obs = env.reset(key)
        return state, norm(obs)

    def step(state, action, key):
        state2, obs, reward, term, trunc = env.step(state, action, key)
        return state2, norm(obs), reward, term, trunc

    spec = EnvSpec(
        name=name or env.spec.name + "#affine",
        obs_dim=env.spec.obs_dim,
        action_dim=env.spec.action_dim,
        horizon=env.spec.horizon,
        gamma=env.spec.gamma,
        discrete=env.spec.discrete,
        action_low=env.spec.action_low,
        action_high=env.spec.action_high,
    )
    return Env(spec=spec, reset=reset, step=step)


def calibrate(cfg, n_envs: int = 64, n_steps: int = 200, seed: int = 0):
    """Measure observation statistics with a random policy and return a
    config whose ``obs_loc`` / ``obs_scale`` normalize them.

    The device-native route to observation normalization for on-device
    envs: run ``n_envs`` x ``n_steps`` uniform-random-action steps of the
    BASE env, take per-dimension mean/std, and bake them into the config —
    a generic version of the hand-derived ``mountain_car_norm`` recipe.  Pure measurement: the training run itself stays
    bit-replayable because the statistics are constants in the config.
    """
    from . import make
    from .core import vector_autoreset_step, vector_reset

    env = make(cfg.env)
    spec = env.spec
    key = jax.random.PRNGKey(seed)
    k_reset, k_scan = jax.random.split(key)
    state, obs = vector_reset(env, k_reset, n_envs)

    def step_fn(carry, key_t):
        state, obs = carry
        k_act, k_env = jax.random.split(key_t)
        if spec.discrete:
            action = jax.random.randint(
                k_act, (n_envs, 1), 0, spec.action_dim)
        else:
            action = jax.random.uniform(
                k_act, (n_envs, spec.action_dim), jnp.float32,
                spec.action_low, spec.action_high)
        state2, obs2, _, _, _, _ = vector_autoreset_step(
            env, state, action, k_env)
        return (state2, obs2), obs

    @jax.jit
    def run():
        _, all_obs = jax.lax.scan(
            step_fn, (state, obs), jax.random.split(k_scan, n_steps))
        flat = all_obs.reshape(-1, spec.obs_dim)
        return jnp.mean(flat, axis=0), jnp.std(flat, axis=0)

    mean, std = jax.device_get(run())
    std = np.maximum(np.asarray(std), 1e-6)
    return cfg.replace(obs_loc=tuple(float(x) for x in mean),
                       obs_scale=tuple(float(x) for x in std))


def mask_obs(env: Env, keep, name: Optional[str] = None) -> Env:
    """Partial observability: expose only the observation dims in ``keep``.

    Physics, rewards and episode structure are untouched — this makes a
    fully-observed env into a memory task for the recurrent model family
    (models/gru.py).  Like :func:`normalize_obs`, a pure recomposition, so
    vmap/jit/scan fuse straight through it.
    """
    keep = jnp.asarray(keep, jnp.int32)

    def reset(key):
        state, obs = env.reset(key)
        return state, obs[keep]

    def step(state, action, key):
        state2, obs, reward, term, trunc = env.step(state, action, key)
        return state2, obs[keep], reward, term, trunc

    spec = EnvSpec(
        name=name or env.spec.name + "_po",
        obs_dim=int(keep.shape[0]),
        action_dim=env.spec.action_dim,
        horizon=env.spec.horizon,
        gamma=env.spec.gamma,
        discrete=env.spec.discrete,
        action_low=env.spec.action_low,
        action_high=env.spec.action_high,
    )
    return Env(spec=spec, reset=reset, step=step)


@register("pendulum_po")
def make_pendulum_po() -> Env:
    """Pendulum with the angular velocity HIDDEN (obs = cos/sin theta only).

    The classic partially-observable control benchmark: a memoryless policy
    cannot tell which way the pendulum is swinging, so it plateaus far from
    the fully-observed solve; a recurrent policy recovers the velocity from
    consecutive angles.
    """
    from .core import make as _make

    return mask_obs(_make("pendulum"), [0, 1], name="pendulum_po")


def stack_obs(env: Env, k: int, name: Optional[str] = None) -> Env:
    """Frame stacking: observe the last ``k`` observations concatenated.

    The memoryless counterpart to the recurrent trunk for partially-
    observable envs — an MLP over k stacked frames can difference
    consecutive angles where a single frame hides the velocity
    (``pendulum_po_stack`` below solves pendulum_po this way).  The window
    lives in the env-state pytree ([k, obs_dim], newest last), so it rides
    vmap/scan/auto-reset like any other state; reset fills the window with
    the first observation.
    """
    base_dim = env.spec.obs_dim

    def reset(key):
        state, obs = env.reset(key)
        window = jnp.tile(obs[None], (k, 1))
        return (state, window), window.reshape(-1)

    def step(wrapped, action, key):
        state, window = wrapped
        state2, obs, reward, term, trunc = env.step(state, action, key)
        window2 = jnp.concatenate([window[1:], obs[None]], axis=0)
        return (state2, window2), window2.reshape(-1), reward, term, trunc

    spec = EnvSpec(
        name=name or f"{env.spec.name}_stack{k}",
        obs_dim=base_dim * k,
        action_dim=env.spec.action_dim,
        horizon=env.spec.horizon,
        gamma=env.spec.gamma,
        discrete=env.spec.discrete,
        action_low=env.spec.action_low,
        action_high=env.spec.action_high,
    )
    return Env(spec=spec, reset=reset, step=step)


@register("cartpole_po")
def make_cartpole_po() -> Env:
    """CartPole with BOTH velocities hidden (obs = cart position, pole
    angle).  The memoryless ceiling is low (~50 steps measured — the policy
    cannot tell which way the pole is falling); a GRU policy recovers the
    velocities and balances."""
    from .core import make as _make

    return mask_obs(_make("cartpole"), [0, 2], name="cartpole_po")


@register("pendulum_po_stack")
def make_pendulum_po_stack() -> Env:
    """pendulum_po with 4 stacked frames: the frame-difference route to the
    hidden velocity, solvable by a plain MLP (contrast with the GRU route,
    docs/RESULTS.md)."""
    from .core import make as _make

    return stack_obs(_make("pendulum_po"), 4, name="pendulum_po_stack")


class RunningStats:
    """Numerically stable running mean/variance over observation rows.

    Batched Welford (Chan's parallel merge — the same algebra as the
    device-side shard merge in ops/welford.py, kept in float64 on the host).
    One instance is SHARED between the training and eval venv wrappers so
    evaluation sees the training feature space.
    """

    def __init__(self, dim: int):
        self.count = 0.0
        self.mean = np.zeros(dim, np.float64)
        self.m2 = np.zeros(dim, np.float64)

    def update(self, batch: np.ndarray) -> None:
        b = np.asarray(batch, np.float64).reshape(-1, self.mean.shape[0])
        n = b.shape[0]
        if n == 0:
            return
        bmean = b.mean(axis=0)
        bm2 = np.square(b - bmean).sum(axis=0)
        tot = self.count + n
        delta = bmean - self.mean
        self.mean = self.mean + delta * (n / tot)
        self.m2 = self.m2 + bm2 + np.square(delta) * (self.count * n / tot)
        self.count = tot

    def variance(self) -> np.ndarray:
        if self.count < 1:
            return np.ones_like(self.m2)
        return self.m2 / self.count

    def normalize(self, x: np.ndarray, clip: float, eps: float = 1e-8
                  ) -> np.ndarray:
        if self.count < 2:     # no information yet: identity (initial eval)
            return np.asarray(x, np.float32)
        z = (np.asarray(x, np.float64) - self.mean) / np.sqrt(
            self.variance() + eps)
        return np.clip(z, -clip, clip).astype(np.float32)

    # -- persistence (sidecar next to the binary checkpoint) ----------------
    def state_dict(self) -> dict:
        return {"count": np.float64(self.count), "mean": self.mean,
                "m2": self.m2}

    def load_state_dict(self, d) -> None:
        self.count = float(d["count"])
        self.mean = np.asarray(d["mean"], np.float64).copy()
        self.m2 = np.asarray(d["m2"], np.float64).copy()

    def save(self, path: str, **extra) -> None:
        """Atomic write (tmp + rename): a crash mid-save leaves either the
        old valid sidecar or the new one, never a truncated zip.  ``extra``
        scalars (clip/eps) ride along so serving replays the exact
        normalization."""
        import os
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **self.state_dict(), **extra)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "RunningStats":
        d = np.load(path)
        out = cls(int(np.asarray(d["mean"]).shape[0]))
        out.load_state_dict(d)
        return out


class RunningObsNorm:
    """Host-protocol venv wrapper: normalize observations with RUNNING
    mean/variance (the standard PPO practice for envs with unknown,
    heterogeneous observation scales — BipedalWalker's hull angles vs lidar).

    Wraps any host-protocol venv (envs/host.py contract).  Statistics update
    on the actor side only; the jitted learner and the pure-JAX fast path
    are untouched.  Pass ``update=False`` (with a shared ``stats``) for the
    eval venv so evaluation reads the training statistics without polluting
    them.
    """

    def __init__(self, venv, stats: Optional[RunningStats] = None,
                 update: bool = True, clip: float = 10.0, eps: float = 1e-8):
        self.venv = venv
        self.spec = venv.spec
        self.n_envs = venv.n_envs
        self.stats = RunningStats(venv.spec.obs_dim) if stats is None else stats
        self.update = update
        self.clip = float(clip)
        self.eps = float(eps)

    def _norm(self, x: np.ndarray) -> np.ndarray:
        return self.stats.normalize(x, self.clip, self.eps)

    def reset(self) -> np.ndarray:
        obs = self.venv.reset()
        if self.update:
            self.stats.update(obs)
        return self._norm(obs)

    def step(self, actions: np.ndarray):
        obs_after, next_obs, reward, term, trunc = self.venv.step(actions)
        if self.update:
            self.stats.update(obs_after)
        # both streams normalized with the SAME (post-update) statistics so
        # the GAE bootstrap V(next_obs) and the policy input agree;
        # next_obs differs from obs_after only at done rows, so normalize
        # once and patch those rows rather than paying a second full pass
        n_after = self._norm(obs_after)
        done = np.nonzero(np.asarray(term) | np.asarray(trunc))[0]
        if done.size == 0:
            n_next = n_after
        else:
            n_next = n_after.copy()
            n_next[done] = self._norm(next_obs[done])
        return n_after, n_next, reward, term, trunc

    def close(self):
        self.venv.close()


class RunningRewardNorm:
    """Host-protocol venv wrapper: scale rewards by the running standard
    deviation of the DISCOUNTED RETURN (the VecNormalize recipe) so the
    value-loss scale is O(1) regardless of the env's reward magnitude.

    Rewards are divided (not centered — centering would change optimal
    behavior) by ``std(G_t)`` where ``G_t = gamma * G_{t-1} + r_t`` per env,
    reset at episode ends.  Train-venv only: evaluation must see RAW rewards
    or reported J/R become meaningless.  Stacks outside/inside
    :class:`RunningObsNorm` (the obs ``stats`` attribute passes through).
    """

    def __init__(self, venv, gamma: float, clip: float = 10.0,
                 eps: float = 1e-8, update: bool = True,
                 ret_stats: Optional[RunningStats] = None):
        self.venv = venv
        self.spec = venv.spec
        self.n_envs = venv.n_envs
        self.gamma = float(gamma)
        self.clip = float(clip)
        self.eps = float(eps)
        self.update = update
        self.ret_stats = RunningStats(1) if ret_stats is None else ret_stats
        self._ret = np.zeros(venv.n_envs, np.float64)

    # obs-norm statistics (if any inner wrapper has them) pass through so
    # HostTrainer.save/load and serving keep working when stacked
    @property
    def stats(self):
        return getattr(self.venv, "stats", None)

    def reset(self) -> np.ndarray:
        self._ret[:] = 0.0
        return self.venv.reset()

    def step(self, actions: np.ndarray):
        obs_after, next_obs, reward, term, trunc = self.venv.step(actions)
        r = np.asarray(reward, np.float64)
        self._ret = self.gamma * self._ret + r
        if self.update:
            self.ret_stats.update(self._ret[:, None])
        done = np.asarray(term) | np.asarray(trunc)
        self._ret[done] = 0.0
        if self.ret_stats.count >= 2:
            scale = np.sqrt(self.ret_stats.variance()[0] + self.eps)
            r = np.clip(r / scale, -self.clip, self.clip)
        return obs_after, next_obs, r.astype(np.float32), term, trunc

    def close(self):
        self.venv.close()


@register("mountain_car_norm")
def make_mountain_car_norm() -> Env:
    """MountainCarContinuous with observations mapped to [-1, 1].

    The raw observation scales differ by 26x (position in [-1.2, 0.6],
    velocity in [-0.07, 0.07]); with the reference's uniform-bound weight
    init the velocity signal — the one that matters for the energy-pumping
    solution — is nearly invisible to the first layer.  Normalizing is the
    config-level change that makes the sparse-reward task solvable without
    touching the algorithm.
    """
    from . import mountain_car as mc

    base = mc.make_mountain_car()
    return normalize_obs(
        base,
        low=np.array([mc.MIN_POSITION, -mc.MAX_SPEED], np.float32),
        high=np.array([mc.MAX_POSITION, mc.MAX_SPEED], np.float32),
        name="mountain_car_norm",
    )
