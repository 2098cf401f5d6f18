"""Policy serving: rebuild a trained policy from a checkpoint and act.

The reference's deployment flow is ``load_ppo`` + per-step ``sample_action``
(src/ppo.cu:610-648, src/policy.cu:76-89 — implemented but never wired into
main).  Here it is a first-class two-liner:

    act = ppoc_tpu.serve.load_policy("model.bin")
    action = act(obs)                  # [B, obs_dim] -> [B, act_dim]

``act`` is one jitted device call per batch; ``deterministic=True`` (the
default) serves the Gaussian mean / categorical argmax, ``False`` samples
the stochastic policy like the reference's evaluator.
"""
from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp


def _resolve_spec(cfg, dims):
    """EnvSpec for a checkpoint: the registry entry named by cfg.env when
    its dims MATCH the file's, else a spec built from the file's own dims —
    the file is the ground truth (a checkpoint saved with a stale/default
    cfg.env, e.g. by an older host-bridge driver that never rewrote it,
    must not serve with the wrong observation contract)."""
    from ppoc_tpu import envs
    from ppoc_tpu.envs.core import EnvSpec

    try:
        spec = envs.make(cfg.env).spec
        if (spec.obs_dim == dims["obs_dim"]
                and spec.action_dim == dims["action_dim"]
                and spec.discrete == dims["discrete"]):
            return spec
        import warnings

        warnings.warn(
            f"checkpoint dims {dims} do not match env {cfg.env!r} "
            f"({spec.obs_dim}/{spec.action_dim}); serving with the file's "
            f"dims", stacklevel=3,
        )
    except KeyError:
        pass  # host-bridge env ids have no registry entry
    return EnvSpec(
        name=cfg.env, obs_dim=dims["obs_dim"],
        action_dim=dims["action_dim"], horizon=0, gamma=0.99,
        discrete=dims["discrete"],
    )


def load_policy(path: str, deterministic: bool = True,
                seed: int = 0) -> Callable:
    """Load a version-3 checkpoint and return ``act(obs) -> action``.

    Batched: ``obs`` is [B, obs_dim] (a single [obs_dim] vector is also
    accepted).  Discrete checkpoints return int32 class indices [B, 1];
    continuous ones return [B, act_dim] actions.
    """
    from ppoc_tpu import envs
    from ppoc_tpu.models import mlp, policy as policy_mod
    from ppoc_tpu.utils import checkpoint

    ck = checkpoint.load(path)
    if ck.cfg is None:
        raise ValueError(
            f"{path}: version-2 checkpoint has no embedded config; "
            f"re-save it with this version (Trainer.save) first"
        )
    cfg = ck.cfg
    spec = _resolve_spec(cfg, ck.dims)
    params = ck.state.policy_params
    from ppoc_tpu.models import attn, gru

    if gru.is_rnn(params["mlp"]):
        raise ValueError(
            f"{path} holds a recurrent (GRU) policy, which needs a hidden "
            f"state between steps; use serve.load_recurrent_policy instead"
        )
    if attn.is_attn(params["mlp"]):
        raise ValueError(
            f"{path} holds an attention policy, which needs a KV cache "
            f"between steps; use serve.load_attention_policy instead"
        )
    # MoE checkpoints serve through the same structural dispatch in
    # mlp.apply; the backend string carries the trained gating top-k
    backend = (mlp.moe_backend("jnp", cfg.moe_topk)
               if getattr(cfg, "n_experts", 1) > 1 else "jnp")
    key_holder = {"key": jax.random.PRNGKey(seed)}

    # a policy trained under RunningObsNorm (envs/wrappers.py) expects
    # normalized inputs; HostTrainer.save writes the statistics as a sidecar.
    # Config-carried affine normalization (cfg.obs_loc/obs_scale, the
    # on-device-env form) replays from the checkpoint's config directly.
    norm = _affine_norm(cfg)
    import os
    if norm is not None and os.path.exists(path + ".obsnorm.npz"):
        raise ValueError(
            f"{path} carries BOTH config obs_loc/obs_scale and an "
            f".obsnorm.npz sidecar; ambiguous normalization")
    if os.path.exists(path + ".obsnorm.npz"):
        import numpy as np

        from ppoc_tpu.envs.wrappers import RunningStats

        sidecar = np.load(path + ".obsnorm.npz")
        stats = RunningStats(int(np.asarray(sidecar["mean"]).shape[0]))
        stats.load_state_dict(sidecar)
        # replay the exact training-time normalization (clip/eps ride in
        # the sidecar; older sidecars fall back to the wrapper defaults)
        clip = float(sidecar["clip"]) if "clip" in sidecar else 10.0
        eps = float(sidecar["eps"]) if "eps" in sidecar else 1e-8
        norm = lambda o: stats.normalize(o, clip=clip, eps=eps)

    if spec.discrete:
        @jax.jit
        def _det(obs):
            logits = mlp.apply(params["mlp"], obs, cfg.activation, backend)
            return jnp.argmax(logits, axis=-1)[..., None].astype(jnp.int32)

        @jax.jit
        def _sto(obs, key):
            a, _ = policy_mod.categorical_sample(
                params, obs, key, cfg.activation, backend)
            return a
    else:
        @jax.jit
        def _det(obs):
            return policy_mod.gaussian_mean(params, obs, cfg.activation, backend)

        @jax.jit
        def _sto(obs, key):
            a, _ = policy_mod.gaussian_sample(
                params, obs, key, cfg.activation, backend)
            return a

    def act(obs, key: Optional[jax.Array] = None):
        if norm is not None:
            obs = norm(obs)
        obs = jnp.asarray(obs, jnp.float32)
        single = obs.ndim == 1
        if single:
            obs = obs[None]
        if deterministic:
            out = _det(obs)
        else:
            if key is None:
                key_holder["key"], key = jax.random.split(key_holder["key"])
            out = _sto(obs, key)
        return out[0] if single else out

    act.recurrent = False
    act.cfg = cfg
    act.spec = spec
    return act


def _affine_norm(cfg):
    """obs -> (obs - loc) / scale closure from the config, or None.

    The serving twin of envs.make_for's affine_obs wrapper — a policy
    trained on normalized observations must see normalized ones here too.
    """
    loc = getattr(cfg, "obs_loc", ())
    if not loc:
        return None
    import numpy as np

    loc_a = np.asarray(loc, np.float32)
    scale_a = np.asarray(cfg.obs_scale, np.float32)
    return lambda o: (np.asarray(o, np.float32) - loc_a) / scale_a


def load_recurrent_policy(path: str, deterministic: bool = True,
                          seed: int = 0):
    """Load a GRU-trunk checkpoint (models/gru.py) and return a stateful
    actor.

        act = ppoc_tpu.serve.load_recurrent_policy("model.bin")
        h = act.initial_state(batch_size)
        action, h = act(obs, h)           # [B, obs] -> ([B, act], [B, H])

    The caller owns the hidden state — zero it (``initial_state``) at every
    episode start.  One jitted device call per step, like load_policy.
    """
    from ppoc_tpu.models import gru, policy as policy_mod
    from ppoc_tpu.utils import checkpoint

    ck = checkpoint.load(path)
    if ck.cfg is None:
        raise ValueError(f"{path}: checkpoint has no embedded config")
    cfg = ck.cfg
    params = ck.state.policy_params
    if not gru.is_rnn(params["mlp"]):
        raise ValueError(
            f"{path} holds a feedforward policy; use serve.load_policy")
    discrete = ck.dims["discrete"]
    key_holder = {"key": jax.random.PRNGKey(seed)}
    norm = _affine_norm(cfg)

    @jax.jit
    def _step(obs, h, key):
        h2, out = gru.step(params["mlp"], h, obs, cfg.activation)
        action, _ = policy_mod.act_from_out(
            out, key, discrete, params.get("log_std"), deterministic)
        return action, h2

    def act(obs, h, key: Optional[jax.Array] = None):
        if norm is not None:
            obs = norm(obs)
        obs = jnp.asarray(obs, jnp.float32)
        single = obs.ndim == 1
        if single:
            obs = obs[None]
            h = h[None] if h.ndim == 1 else h
        if key is None:
            key_holder["key"], key = jax.random.split(key_holder["key"])
        a, h2 = _step(obs, h, key)
        return (a[0], h2[0]) if single else (a, h2)

    act.initial_state = lambda batch_size=None: gru.initial_state(
        params["mlp"], () if batch_size is None else (batch_size,))
    act.recurrent = True
    act.cfg = cfg
    # same actor-surface contract as load_policy (act.spec for consumers
    # that size buffers / check discreteness)
    act.spec = _resolve_spec(cfg, ck.dims)
    return act


def load_attention_policy(path: str, deterministic: bool = True,
                          seed: int = 0):
    """Load an attention-trunk checkpoint (models/attn.py) and return a
    stateful actor whose per-episode state is the decode KV cache.

        act = ppoc_tpu.serve.load_attention_policy("model.bin")
        s = act.initial_state(batch_size)
        action, s = act(obs, s)               # [B, obs] -> ([B, act], cache)
        s = act.reset_lanes(s, done)          # at episode ends

    The caller owns the cache: build a fresh one per window
    (``initial_state``) and advance finished lanes with ``reset_lanes`` —
    the same episode-boundary contract the training rollout uses
    (algo/recurrent.rollout_rnn).  Episodes longer than the trained window
    clamp to its final position (models/attn.step) — context stops growing
    but acting continues.
    """
    from ppoc_tpu.models import attn, policy as policy_mod
    from ppoc_tpu.utils import checkpoint

    ck = checkpoint.load(path)
    if ck.cfg is None:
        raise ValueError(f"{path}: checkpoint has no embedded config")
    cfg = ck.cfg
    params = ck.state.policy_params
    if not attn.is_attn(params["mlp"]):
        raise ValueError(
            f"{path} holds a non-attention policy; use serve.load_policy "
            f"(feedforward/MoE) or serve.load_recurrent_policy (GRU/LSTM)")
    discrete = ck.dims["discrete"]
    key_holder = {"key": jax.random.PRNGKey(seed)}
    norm = _affine_norm(cfg)

    @jax.jit
    def _step(obs, cache, key):
        cache2, out = attn.step(params["mlp"], cache, obs, cfg.activation)
        action, _ = policy_mod.act_from_out(
            out, key, discrete, params.get("log_std"), deterministic)
        return action, cache2

    def act(obs, cache, key: Optional[jax.Array] = None):
        if norm is not None:
            obs = norm(obs)
        obs = jnp.asarray(obs, jnp.float32)
        single = obs.ndim == 1
        if single:
            obs = obs[None]
        if key is None:
            key_holder["key"], key = jax.random.split(key_holder["key"])
        a, cache2 = _step(obs, cache, key)
        return (a[0], cache2) if single else (a, cache2)

    act.initial_state = lambda batch_size=None: attn.initial_cache(
        params["mlp"], (1,) if batch_size is None else (batch_size,))
    act.reset_lanes = attn.reset_lanes
    act.window = attn.window(params["mlp"])
    act.recurrent = True
    act.cfg = cfg
    act.spec = _resolve_spec(cfg, ck.dims)
    return act


# --------------------------------------------------------------------------
# HTTP inference server
# --------------------------------------------------------------------------

def make_server(path: str, host: str = "127.0.0.1", port: int = 8000,
                deterministic: bool = True, seed: int = 0):
    """An HTTP policy server over a checkpoint (stdlib-only, threaded).

    The production face of the serving API — the reference's deployment
    story stops at load_ppo + sample_action in-process (src/ppo.cu:610-648);
    this exposes the same act() over the wire so non-Python actors can
    consume a trained policy.

    Endpoints (JSON):
      GET  /spec  -> {env, obs_dim, action_dim, discrete, recurrent, hidden}
      POST /act   -> body {"obs": [[...]] | [...], "h": [[...]]?}
                     reply {"action": ..., "h": ...?}   (h: recurrent only;
                     omit h (or null) at episode start — zeros are used)

    Attention checkpoints serve STATEFULLY: their per-step KV cache is too
    large to round-trip as JSON, so the server keeps it per session —
      POST /act {"obs": ..., "session": "my-id", "done": [bools]?}
    creates the session's cache on first use (batch size fixed by that
    call), advances it each call, and moves finished lanes' episode starts
    when "done" is given (the rollout contract, attn.reset_lanes);
    {"session": "my-id", "close": true} frees it.  At most 64 live
    sessions (LRU-evicted).

    Device calls are serialized with a lock (one chip, one program); batch
    your observations client-side for throughput.  Returns the configured
    HTTPServer — call serve_forever() (blocking) or run it in a thread.
    """
    import http.server
    import json
    import threading

    import numpy as np

    from ppoc_tpu.models import attn as attn_mod, gru
    from ppoc_tpu.utils import checkpoint

    # dispatch on the trunk kind directly — catching load_policy's
    # ValueError would mask unrelated load failures (corrupt file/sidecar)
    # behind a misleading "use the other loader" message
    trunk = checkpoint.load(path).state.policy_params["mlp"]
    attention = attn_mod.is_attn(trunk)
    recurrent = gru.is_rnn(trunk)
    loader = (load_attention_policy if attention
              else load_recurrent_policy if recurrent else load_policy)
    act = loader(path, deterministic=deterministic, seed=seed)
    spec = act.spec
    lock = threading.Lock()
    rnn_hidden = int(act.cfg.rnn_hidden) if recurrent else 0
    sessions = {}  # attention: session id -> KV cache (insertion = LRU)
    MAX_SESSIONS = 64

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _reply(self, code, obj):
            body = json.dumps(obj).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/spec":
                return self._reply(404, {"error": f"unknown path {self.path}"})
            info = {
                "env": spec.name, "obs_dim": spec.obs_dim,
                "action_dim": spec.action_dim, "discrete": spec.discrete,
                "recurrent": recurrent, "rnn_hidden": rnn_hidden,
                "deterministic": deterministic,
            }
            if attention:
                info.update(attention=True, protocol="session",
                            window=int(act.window))
            self._reply(200, info)

        def do_POST(self):
            if self.path != "/act":
                return self._reply(404, {"error": f"unknown path {self.path}"})
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n).decode("utf-8"))
                if attention and req.get("close"):
                    sid = req.get("session")
                    with lock:
                        existed = sessions.pop(sid, None) is not None
                    return self._reply(200, {"session": sid,
                                             "closed": existed})
                obs = np.asarray(req["obs"], np.float32)
                single = obs.ndim == 1
                if single:
                    obs = obs[None]
                if obs.ndim != 2 or obs.shape[1] != spec.obs_dim:
                    raise ValueError(
                        f"obs must be [B, {spec.obs_dim}], got {obs.shape}")
                if attention:
                    return self._act_attention(req, obs, single)
                h = None
                if recurrent:
                    h = req.get("h")
                    if h is None:
                        h = np.asarray(act.initial_state(obs.shape[0]))
                    else:
                        h = np.asarray(h, np.float32)
                        if h.shape != (obs.shape[0], rnn_hidden):
                            raise ValueError(
                                f"h must be [{obs.shape[0]}, {rnn_hidden}] "
                                f"(one row per obs), got {h.shape}")
                # only the device call is serialized; JSON marshalling of
                # the replies happens outside the lock
                with lock:
                    if recurrent:
                        a, h2 = act(obs, h)
                    else:
                        a, h2 = act(obs), None
                a = np.asarray(a)
                out = {"action": a.tolist()}
                if h2 is not None:
                    out["h"] = np.asarray(h2).tolist()
                if single:
                    out["action"] = out["action"][0]
                    if "h" in out:
                        out["h"] = out["h"][0]
                self._reply(200, out)
            except (KeyError, ValueError, TypeError) as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # device/runtime failure: a 500 body,
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                # not a dropped socket (the non-Python client this server
                # exists for cannot read a Python traceback)

        def _act_attention(self, req, obs, single):
            """Session-stateful attention acting: the KV cache lives
            server-side, advanced one step per call (see make_server
            docstring for the protocol)."""
            sid = req.get("session")
            if not isinstance(sid, str) or not sid:
                raise ValueError(
                    "attention serving is stateful: pass a non-empty "
                    "'session' string; the server keeps that session's "
                    "KV cache")
            done = req.get("done")
            if done is not None:
                done = np.asarray(done, bool)
                if done.shape != (obs.shape[0],):
                    raise ValueError(
                        f"done must be [{obs.shape[0]}] bools (one per "
                        f"obs row), got {done.shape}")
            with lock:
                cache = sessions.pop(sid, None)  # pop: re-insert = LRU bump
                if cache is None:
                    while len(sessions) >= MAX_SESSIONS:
                        sessions.pop(next(iter(sessions)))
                    cache = act.initial_state(obs.shape[0])
                elif cache["start"].shape[0] != obs.shape[0]:
                    sessions[sid] = cache
                    raise ValueError(
                        f"session {sid!r} was created with batch size "
                        f"{cache['start'].shape[0]}, got {obs.shape[0]} "
                        f"obs rows; close it or use a new session")
                # the cache is popped above; if the device call fails the
                # finally re-inserts the PRE-STEP cache so a transient error
                # doesn't silently drop the session's episode context (the
                # client can retry the same step)
                try:
                    a, cache2 = act(obs, cache)
                    if done is not None:
                        cache2 = act.reset_lanes(cache2, jnp.asarray(done))
                    cache = cache2
                finally:
                    sessions[sid] = cache
            out = {"action": np.asarray(a).tolist(), "session": sid,
                   "t": int(jax.device_get(cache["t"]))}
            if single:
                out["action"] = out["action"][0]
            self._reply(200, out)

    server = http.server.ThreadingHTTPServer((host, port), Handler)
    return server


def main(argv=None) -> int:
    """``python -m ppoc_tpu.serve model.bin [--port P] [--stochastic]``."""
    import argparse
    import os

    # PPOC_PLATFORM / PPOC_CPU_DEVICES: pin the JAX platform through the
    # config API before backend init (same contract as the training CLI)
    plat = os.environ.get("PPOC_PLATFORM")
    if plat:
        jax.config.update("jax_platforms", plat)
        n_cpu = os.environ.get("PPOC_CPU_DEVICES")
        if n_cpu:
            jax.config.update("jax_num_cpu_devices", int(n_cpu))

    ap = argparse.ArgumentParser(
        prog="ppoc_tpu.serve",
        description="serve a trained policy checkpoint over HTTP")
    ap.add_argument("checkpoint")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--stochastic", action="store_true",
                    help="sample the policy instead of serving its mode")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    server = make_server(args.checkpoint, args.host, args.port,
                         deterministic=not args.stochastic, seed=args.seed)
    host, port = server.server_address[:2]
    print(f"serving {args.checkpoint} on http://{host}:{port} "
          f"(GET /spec, POST /act)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
