"""Host-environment bridge: train on arbitrary Gymnasium envs.

Capability-parity replacement for the reference's embedded-CPython bridge
(``src/gym_env.c`` + ``scripts/gym_env.py``, components 14-15 in SURVEY.md):
the reference embeds a Python interpreter inside its C binary to step ONE
Gymnasium env per rollout step; here the framework *is* Python, so the bridge
is the other way around — a vectorized Gymnasium actor on the host feeding
the jitted device learner (``ppo.update_step``).

This is the actor/learner split the reference has (CPU rollouts, GPU
updates, src/ppo.cu:479-539) and the pure-JAX envs deliberately collapse;
it exists so users can bring ANY Gymnasium env, not just the in-repo
physics.  Per policy step there is exactly ONE device round trip (batched
action sampling for all n_envs), vs the reference's per-step C->Python
crossing for a single env (src/gym_env.c:61-93).

Env ids follow the reference's registry (scripts/gym_env.py:11-17):
id 0 = Pendulum-v1, id 1 = BipedalWalker-v3; any Gymnasium id string works.
"""
from __future__ import annotations

import numpy as np

from ppoc_tpu.config import PPOConfig
from ppoc_tpu.envs.core import EnvSpec

# reference env-id table (scripts/gym_env.py:11-17)
ENV_IDS = {0: "Pendulum-v1", 1: "BipedalWalker-v3"}


class _make_env_fn:
    """Picklable env factory (AsyncVectorEnv ships it to worker processes)."""

    def __init__(self, env_id: str):
        self.env_id = env_id

    def __call__(self):
        import gymnasium

        return gymnasium.make(self.env_id)


def _gymnasium():
    try:
        import gymnasium
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "the Gymnasium bridge needs the 'gymnasium' package; the pure-JAX "
            "envs (ppoc_tpu.envs.make) have no such dependency"
        ) from e
    return gymnasium


class GymVecEnv:
    """n_envs Gymnasium instances with per-env auto-reset, stepped through
    ``gymnasium.vector`` (``vector_mode``: "sync" = one process,
    "async" = one worker process per env for CPU-heavy physics like
    Box2D/BipedalWalker).

    Mirrors the reference rollout semantics (collect_trajectories,
    src/ppo.cu:54-79): ``step`` returns the TRUE successor observation for
    GAE bootstrapping plus the post-reset observation the policy acts on
    next (SAME_STEP autoreset: the final pre-reset observation arrives in
    ``info["final_obs"]``).
    """

    def __init__(self, env_id, n_envs: int, seed: int = 0,
                 vector_mode: str = "sync"):
        gymnasium = _gymnasium()
        try:
            from gymnasium.vector import (
                AsyncVectorEnv, AutoresetMode, SyncVectorEnv,
            )
        except ImportError as e:
            raise ImportError(
                f"the vectorized bridge needs gymnasium >= 1.1 "
                f"(AutoresetMode.SAME_STEP); installed version "
                f"{getattr(gymnasium, '__version__', '?')} lacks it — "
                f"upgrade with `pip install -U gymnasium`"
            ) from e

        if isinstance(env_id, int):
            env_id = ENV_IDS[env_id]
        self.name = env_id
        self.n_envs = n_envs
        self._seed = seed
        if vector_mode not in ("sync", "async"):
            raise ValueError(f"vector_mode must be 'sync' or 'async', got {vector_mode!r}")
        vec_cls = AsyncVectorEnv if vector_mode == "async" else SyncVectorEnv
        self.venv = vec_cls(
            [_make_env_fn(env_id) for _ in range(n_envs)],
            autoreset_mode=AutoresetMode.SAME_STEP,
        )
        obs_space = self.venv.single_observation_space
        act_space = self.venv.single_action_space
        discrete = hasattr(act_space, "n")
        gspec = gymnasium.spec(env_id)
        horizon = gspec.max_episode_steps or 1000
        if not discrete:
            # EnvSpec carries SCALAR action bounds; silently taking dim 0
            # would mis-scale asymmetric Boxes — validate.
            low = np.asarray(act_space.low, np.float32).reshape(-1)
            high = np.asarray(act_space.high, np.float32).reshape(-1)
            if not (np.all(low == low[0]) and np.all(high == high[0])):
                raise ValueError(
                    f"{env_id}: per-dimension action bounds differ "
                    f"(low={low.tolist()}, high={high.tolist()}); EnvSpec "
                    f"supports a single scalar bound pair — wrap the env with "
                    f"a RescaleAction transform first"
                )
        self.spec = EnvSpec(
            name=f"gym:{env_id}",
            obs_dim=int(np.prod(obs_space.shape)),
            action_dim=int(act_space.n) if discrete else int(np.prod(act_space.shape)),
            horizon=int(horizon),
            gamma=0.99,  # reference fixes gamma for gym envs (src/gym_env.c:102)
            discrete=discrete,
            action_low=float(getattr(act_space, "low", [-1.0])[0]) if not discrete else -1.0,
            action_high=float(getattr(act_space, "high", [1.0])[0]) if not discrete else 1.0,
        )
        self._episode = 0

    def reset(self) -> np.ndarray:
        self._episode += 1
        obs, _ = self.venv.reset(seed=self._seed + 1000 * self._episode)
        return np.asarray(obs, np.float32).reshape(self.n_envs, -1)

    def step(self, actions: np.ndarray):
        if self.spec.discrete:
            a = np.asarray(actions).reshape(self.n_envs, -1)[:, 0].astype(np.int64)
        else:
            a = np.asarray(actions, np.float32).reshape(
                self.n_envs, *self.venv.single_action_space.shape
            )
        obs, reward, term, trunc, info = self.venv.step(a)
        obs_after = np.asarray(obs, np.float32).reshape(self.n_envs, -1)
        next_obs = obs_after.copy()
        done = term | trunc
        if done.any():
            # SAME_STEP autoreset: obs is the fresh reset; the true (final)
            # successor the GAE bootstrap needs is in info["final_obs"]
            final = info.get("final_obs")
            for i in np.nonzero(done)[0]:
                next_obs[i] = np.asarray(final[i], np.float32).reshape(-1)
        return (obs_after, next_obs, np.asarray(reward, np.float32),
                np.asarray(term, bool), np.asarray(trunc, bool))

    def close(self):
        self.venv.close()


def collect_host(cfg, venv, policy_params, key, length, backend="jnp"):
    """Host rollout against a Gymnasium venv — delegates to the generic
    host-protocol collector (ppoc_tpu.envs.host.collect_host)."""
    from ppoc_tpu.envs.host import collect_host as _collect
    return _collect(cfg, venv, policy_params, key, length, backend)


class GymTrainer:
    """Trainer over a host Gymnasium env: host actor + jitted device learner.

    Thin construction wrapper around :class:`ppoc_tpu.envs.host.HostTrainer`
    with GymVecEnv actors (train/eval), preserving the reference env-id
    table (scripts/gym_env.py:11-17).
    """

    def __new__(cls, cfg: PPOConfig, env_id, backend: str = "jnp",
                vector_mode: str = "sync", actor: str = "device",
                obs_norm: bool = False, obs_clip: float = 10.0,
                reward_norm: bool = False, overlap: bool = False):
        from ppoc_tpu.envs.host import HostTrainer
        from ppoc_tpu.envs.wrappers import RunningObsNorm, RunningRewardNorm

        # make the checkpoint self-describing regardless of how the caller
        # built cfg: the embedded config must name the env actually trained
        # (serve.load_policy resolves its spec from cfg.env)
        if cfg.env != f"gym:{env_id}":
            cfg = cfg.replace(env=f"gym:{env_id}")
        venv = GymVecEnv(env_id, cfg.n_envs, seed=cfg.seed,
                         vector_mode=vector_mode)
        eval_venv = GymVecEnv(env_id, cfg.eval_envs, seed=cfg.seed + 7777,
                              vector_mode=vector_mode)
        if obs_norm:
            # one RunningStats shared train->eval; eval reads, never writes
            venv = RunningObsNorm(venv, clip=obs_clip, update=True)
            eval_venv = RunningObsNorm(eval_venv, stats=venv.stats,
                                       clip=obs_clip, update=False)
        if reward_norm:
            # TRAIN side only — evaluation must report raw-reward J/R
            venv = RunningRewardNorm(venv, gamma=venv.spec.gamma)
        return HostTrainer(cfg, venv, eval_venv, backend=backend, actor=actor,
                           overlap=overlap)
