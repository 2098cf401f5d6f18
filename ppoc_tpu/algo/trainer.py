"""Training driver: epoch loop, evaluation, metrics, checkpointing.

Equivalent of the reference driver (src/main.c:13-64): build env + PPO state,
evaluate, run n_epochs of train_ppo_epoch with wall-clock timing, evaluate
after each epoch, save.  The per-epoch stdout line carries the same fields as
the reference (`Epoch/Entropy/Time` src/main.c:54 and `J/R/Episodes`
src/ppo.cu:581).

Multi-device: pass a ``jax.sharding.Mesh``; the epoch/eval programs are
wrapped in ``shard_map`` over the data-parallel axis with fully replicated
parameters, per-device local envs and minibatch shards, and psum/pmean
collectives inside (see ppoc_tpu.algo.ppo).
"""
from __future__ import annotations

import functools
import time
from typing import Any, Dict, List, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ppoc_tpu import config as config_mod, envs
from ppoc_tpu.algo import ppo
from ppoc_tpu.config import PPOConfig


class EvalWindowWarning(UserWarning):
    """cfg.eval_len < env horizon: evaluation counts only episodes that
    COMPLETE inside the window, so long episodes are censored.  A scoped
    category so harnesses that use deliberately tiny eval windows (the test
    suite, the driver dryrun) can filter it precisely without masking other
    warnings."""


def _shard_map(fn, mesh, in_specs, out_specs, check_vma: bool = True):
    """check_vma=False only where the flash-attention kernel runs inside
    the mesh program (dp attention trainers at flash windows on a GPU):
    a Pallas program does not trace under the varying-axes checker; every
    other mode keeps the type check."""
    try:
        return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=check_vma)
    except AttributeError:  # older jax
        from jax.experimental.shard_map import shard_map as _sm

        return _sm(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                   check_rep=check_vma)


def _map_train_state(ts: "ppo.TrainState", param_fn, moment_fn=None,
                     log_std_fn=None) -> "ppo.TrainState":
    """Apply a transform to every MLP-shaped slot of a TrainState.

    The tp/pp modes need the same mapping (pack / unpack-local /
    repack-local / unshard) over the policy net, value net and both their
    Adam moment trees; this is the single place that knows which slots
    exist, so adding a TrainState field breaks loudly here instead of
    silently dropping state in eight hand-written mappers.
    ``moment_fn`` (default: ``param_fn``) transforms Adam m/v trees;
    ``log_std_fn`` (default: identity) the log_std optimizer state.
    """
    moment_fn = param_fn if moment_fn is None else moment_fn
    pol = dict(ts.policy_params)
    pol["mlp"] = param_fn(ts.policy_params["mlp"])
    opt_log_std = ts.opt_log_std if log_std_fn is None else log_std_fn(ts.opt_log_std)
    return ppo.TrainState(
        policy_params=pol,
        v_params=param_fn(ts.v_params),
        opt_policy=ts.opt_policy._replace(
            m=moment_fn(ts.opt_policy.m), v=moment_fn(ts.opt_policy.v)),
        opt_v=ts.opt_v._replace(
            m=moment_fn(ts.opt_v.m), v=moment_fn(ts.opt_v.v)),
        opt_log_std=opt_log_std,
    )


def score(trainer, episodes: int = 100, deterministic: bool = True,
          max_rounds: int = 1000) -> Dict[str, float]:
    """Aggregate evaluation over at least ``episodes`` COMPLETED episodes.

    The canonical scoring protocol behind every "R over N episodes" number
    in docs/RESULTS.md, as one call: repeat ``trainer.evaluate`` rounds
    (fresh PRNG stream each) until enough episodes completed, weighting
    each round's mean J/R by its episode count.  Works with any trainer
    exposing ``evaluate(deterministic=)`` — the device Trainer and the
    host-bridge HostTrainer alike.  Returns {"J", "R", "episodes",
    "rounds"}.
    """
    tot_j = tot_r = tot_n = 0.0
    rounds = zero_rounds = 0
    while tot_n < episodes and rounds < max_rounds:
        m = trainer.evaluate(deterministic=deterministic)
        rounds += 1
        if m.episodes > 0:
            tot_j += m.J * m.episodes
            tot_r += m.R * m.episodes
            tot_n += m.episodes
        else:
            zero_rounds += 1
            # fail fast: eval_len < horizon yields zero completed episodes
            # DETERMINISTICALLY — don't burn max_rounds full rollouts on it
            if zero_rounds >= 3 and tot_n == 0:
                break
    if tot_n == 0:
        raise RuntimeError(
            f"no episode completed in {rounds} evaluation rounds; is "
            f"eval_len >= the env horizon?"
        )
    return {"J": tot_j / tot_n, "R": tot_r / tot_n,
            "episodes": int(tot_n), "rounds": rounds}


class Trainer:
    def __init__(self, cfg: PPOConfig, mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.env = envs.make_for(cfg)
        self.key = jax.random.PRNGKey(cfg.seed)
        # config-consistency checks: the shared bank (config.validate) —
        # sweep and the CLI run the IDENTICAL definition, so the three
        # surfaces cannot drift; only mesh-dependent checks live below
        config_mod.validate(cfg)
        self.backend = cfg.kernel_backend
        if cfg.eval_len < self.env.spec.horizon:
            import warnings

            warnings.warn(
                f"eval_len ({cfg.eval_len}) < env horizon "
                f"({self.env.spec.horizon}): evaluation counts only episodes "
                f"that COMPLETE within the window, so long episodes are "
                f"censored; set eval_len >= the horizon for unbiased R/J",
                EvalWindowWarning,
                stacklevel=2,
            )

        k_init, self.key = jax.random.split(self.key)
        full_state = ppo.init_train_state(cfg, self.env, k_init)

        # state <-> checkpoint converters; model-parallel modes override
        # these with their shard packers so save/load always sees the
        # logical layout
        self._pack_state = lambda s: s
        self._unshard_state = lambda s: s
        self._mp_ctx = None  # set by _finalize_mp in tp/pp/ep modes

        if cfg.rnn_hidden > 0:
            # GRU/LSTM trunks have no bf16 variant: the float32 XLA path
            self.backend = "jnp"
        if cfg.sp_size > 1:
            self._init_sp(full_state, mesh)
            self._solve_fn = None
            self._solve_args = None
            return
        if cfg.ep_size > 1:
            self._init_ep(full_state, mesh)
            self._solve_fn = None
            self._solve_args = None
            return
        if cfg.n_experts > 1:
            # single-device / pure-dp MoE: encode gating options into the
            # backend string (mlp.apply dispatches on the params structure)
            from ppoc_tpu.models import mlp as mlp_mod

            base = "bf16" if self.backend == "bf16" else "jnp"
            self.backend = mlp_mod.moe_backend(base, cfg.moe_topk)
        if cfg.tp_size > 1:
            self._init_tp(full_state, mesh)
            self._solve_fn = None
            self._solve_args = None
            return
        if cfg.pp_size > 1:
            self._init_pp(full_state, mesh)
            self._solve_fn = None
            self._solve_args = None
            return

        n_dev = 1 if mesh is None else mesh.size
        if cfg.fits_per_program and n_dev > 1:
            raise ValueError(
                "fits_per_program (the chunked-epoch dispatch) supports "
                "single-device runs only; drop the mesh or use the fused "
                "epoch"
            )
        if cfg.fit_dispatch == "phased" and n_dev > 1:
            raise ValueError(
                "fit_dispatch='phased' supports single-device runs only; "
                "drop the mesh or use the fused epoch"
            )
        if cfg.zero1 and n_dev < 2:
            raise ValueError(
                "zero1=True shards optimizer state over a data-parallel "
                "mesh; pass a multi-device mesh (single-device ZeRO is a "
                "no-op)"
            )
        self._dp_state_spec = P()
        if n_dev > 1:
            if mesh.axis_names != (cfg.mesh_axis,):
                raise ValueError(
                    f"data-parallel mode needs a 1-D ({cfg.mesh_axis!r},) "
                    f"mesh, got axes {mesh.axis_names}; for a (dp, tp) mesh "
                    f"set cfg.tp_size"
                )
            if cfg.n_envs % n_dev or cfg.minibatch_size % n_dev or cfg.eval_envs % n_dev:
                raise ValueError(
                    f"n_envs ({cfg.n_envs}), minibatch_size ({cfg.minibatch_size}) and "
                    f"eval_envs ({cfg.eval_envs}) must divide the mesh size {n_dev}"
                )
            if cfg.shuffle_block and (
                    (cfg.minibatch_size // n_dev) % cfg.shuffle_block
                    or (cfg.steps_per_fit // n_dev) % cfg.shuffle_block):
                raise ValueError(
                    f"shuffle_block ({cfg.shuffle_block}) must divide the "
                    f"PER-SHARD minibatch ({cfg.minibatch_size // n_dev}) "
                    f"and per-shard steps_per_fit "
                    f"({cfg.steps_per_fit // n_dev}) on a {n_dev}-device "
                    f"mesh; lower shuffle_block (or 0 for the exact row "
                    f"shuffle)"
                )
            if cfg.zero1:
                # ZeRO-1: flat-packed trunk Adam moments placed P(dp); the
                # logical (checkpoint) layout stays the parameter tree, so
                # zero1 checkpoints interchange with plain-dp runs
                from ppoc_tpu.ops import adam as adam_ops

                def pack_state(ts):
                    return ts._replace(
                        opt_policy=adam_ops.pack_zero1(ts.opt_policy, n_dev),
                        opt_v=adam_ops.pack_zero1(ts.opt_v, n_dev),
                    )

                def unshard(ts):
                    return ts._replace(
                        opt_policy=adam_ops.unpack_zero1(
                            ts.opt_policy, ts.policy_params["mlp"]),
                        opt_v=adam_ops.unpack_zero1(ts.opt_v, ts.v_params),
                    )

                shard = P(cfg.mesh_axis)
                self._dp_state_spec = ppo.TrainState(
                    policy_params=jax.tree.map(
                        lambda _: P(), full_state.policy_params),
                    v_params=jax.tree.map(lambda _: P(), full_state.v_params),
                    opt_policy=full_state.opt_policy._replace(
                        m=shard, v=shard, t=P()),
                    opt_v=full_state.opt_v._replace(m=shard, v=shard, t=P()),
                    opt_log_std=jax.tree.map(
                        lambda _: P(), full_state.opt_log_std),
                )
                self._pack_state = pack_state
                self._unshard_state = unshard
                full_state = pack_state(full_state)
            # the flash kernel (a Pallas program) does not trace under
            # the varying-axes checker: drop it exactly where the update
            # phases' attention windows run the kernel
            from ppoc_tpu.models import attn as attn_mod

            self._dp_check_vma = not (
                cfg.attn_dim > 0
                and attn_mod.uses_flash(cfg.rollout_len, self.backend))
            epoch_local = functools.partial(
                ppo.train_epoch, cfg, self.env,
                axis_name=cfg.mesh_axis,
                n_envs=cfg.n_envs // n_dev,
                mb_size=cfg.minibatch_size // n_dev,
                backend=self.backend,
            )
            def make_eval(det):
                return jax.jit(_shard_map(
                    functools.partial(
                        ppo.evaluate, cfg, self.env,
                        backend=self.backend,
                        n_envs=cfg.eval_envs // n_dev,
                        axis_name=cfg.mesh_axis,
                        deterministic=det,
                    ),
                    mesh, in_specs=(P(), P()), out_specs=P(),
                    check_vma=self._dp_check_vma))

            self._train_epoch = jax.jit(
                _shard_map(epoch_local, mesh,
                           in_specs=(self._dp_state_spec, P()),
                           out_specs=(self._dp_state_spec, P()),
                           check_vma=self._dp_check_vma)
            )
            self._evaluate = make_eval(False)
            self._evaluate_det = make_eval(True)
        else:
            self._train_epoch = jax.jit(
                functools.partial(ppo.train_epoch, cfg, self.env, backend=self.backend)
            )
            if cfg.fits_per_program:
                # chunked-epoch dispatch: compile a bounded N-fit program
                # and Python-loop it over the SAME key stream the fused
                # epoch would use (bit-identical training) — a compile-size
                # option for extreme windows
                self._train_fits = jax.jit(functools.partial(
                    ppo.train_fits, cfg, self.env, backend=self.backend))
                self._reset_carry = jax.jit(functools.partial(
                    ppo.reset_env_carry, cfg, self.env))
            self._evaluate = jax.jit(
                functools.partial(ppo.evaluate, cfg, self.env, backend=self.backend)
            )
            self._evaluate_det = jax.jit(functools.partial(
                ppo.evaluate, cfg, self.env, backend=self.backend,
                deterministic=True))
            if cfg.fit_dispatch == "phased":
                # AFTER the default eval wiring: with rollout_chunk the
                # phased build replaces _evaluate/_evaluate_det with the
                # segmented-decode evaluator
                self._build_phased()

        self.state = full_state
        self._solve_fn = None
        self._solve_args = None

    # -- model-parallel modes (2-D dp x {tp|pp|ep} meshes) -------------------
    #
    # The three modes differ only in how parameters shard along the model
    # axis (Megatron column/row slices, GPipe stage stacks, stacked expert
    # leaves); the mesh construction, shard_map wrapping of train/eval, the
    # checkpoint converters and the solve() context are shared below.

    def _build_mp_mesh(self, mesh: Optional[Mesh], axis: str, size: int) -> int:
        """Install a 2-D (dp, ``axis``) mesh (building one over all local
        devices when none is given) and return the dp size."""
        import numpy as np

        cfg = self.cfg
        if mesh is None:
            devices = jax.devices()
            if len(devices) % size:
                raise ValueError(
                    f"{len(devices)} devices not divisible by "
                    f"{axis}_size {size}"
                )
            dp_size = len(devices) // size
            mesh = Mesh(np.asarray(devices).reshape(dp_size, size),
                        (cfg.mesh_axis, axis))
        else:
            if mesh.axis_names != (cfg.mesh_axis, axis):
                raise ValueError(
                    f"{axis} mode needs a ({cfg.mesh_axis!r}, {axis!r}) "
                    f"mesh, got {mesh.axis_names}"
                )
            if mesh.shape[axis] != size:
                raise ValueError(
                    f"mesh {axis!r} axis has {mesh.shape[axis]} devices but "
                    f"cfg.{axis}_size is {size}"
                )
            dp_size = mesh.shape[cfg.mesh_axis]
        self.mesh = mesh
        return dp_size

    def _finalize_mp(self, state, dp_size: int, model_axis: str,
                     backend: str, state_spec,
                     unpack_local=None, repack_local=None,
                     unpack_policy=None, pack_state=None, unshard=None):
        """Common tail of every model-parallel mode: wrap train/eval in
        shard_map over the (dp, model) mesh, register the checkpoint
        converters, and store the context solve() compiles from.

        ``state`` is the PACKED (placed) training state; ``unpack_local`` /
        ``repack_local`` convert a TrainState between its packed and
        shard-local layouts inside shard_map (identity when the packed
        layout IS the local layout, as for expert parallelism);
        ``unpack_policy`` does the same for the policy-params dict alone
        (evaluation); ``pack_state`` / ``unshard`` convert between the
        logical (checkpoint) and packed layouts on the host.
        """
        cfg = self.cfg
        ident = lambda s: s
        unpack_local = unpack_local or ident
        repack_local = repack_local or ident
        unpack_policy = unpack_policy or ident
        self._pack_state = pack_state or ident
        self._unshard_state = unshard or ident
        self._state_spec = state_spec
        self._mp_ctx = (dp_size, model_axis, unpack_local, repack_local)

        def epoch_local(ts_packed, key):
            ts2, metrics = ppo.train_epoch(
                cfg, self.env, unpack_local(ts_packed), key,
                axis_name=cfg.mesh_axis,
                n_envs=cfg.n_envs // dp_size,
                mb_size=cfg.minibatch_size // dp_size,
                backend=backend,
            )
            metrics = jax.tree.map(
                lambda m: jax.lax.pmean(m, model_axis), metrics)
            return repack_local(ts2), metrics

        def make_eval(det):
            def eval_local(pol_packed, key):
                m = ppo.evaluate(
                    cfg, self.env, unpack_policy(pol_packed), key,
                    backend=backend,
                    n_envs=cfg.eval_envs // dp_size,
                    axis_name=cfg.mesh_axis,
                    deterministic=det,
                )
                return jax.tree.map(
                    lambda v: jax.lax.pmean(v, model_axis), m)

            return jax.jit(_shard_map(
                eval_local, self.mesh,
                in_specs=(state_spec.policy_params, P()),
                out_specs=P(),
            ))

        self._train_epoch = jax.jit(_shard_map(
            epoch_local, self.mesh,
            in_specs=(state_spec, P()),
            out_specs=(state_spec, P()),
        ))
        self._evaluate = make_eval(False)
        self._evaluate_det = make_eval(True)
        self.backend = backend
        self.state = state

    def _check_dp_divisibility(self, dp_size: int):
        cfg = self.cfg
        if cfg.n_envs % dp_size or cfg.minibatch_size % dp_size \
                or cfg.eval_envs % dp_size:
            raise ValueError(
                "n_envs, minibatch_size, eval_envs must divide dp size")

    # -- tensor parallelism (parallel/tp.py) ---------------------------------

    def _init_tp(self, full_state: ppo.TrainState, mesh: Optional[Mesh]):
        """Megatron column/row sharding of both MLPs over a 'tp' axis:
        rollouts and minibatches shard over 'dp' exactly as in pure data
        parallelism; every MLP forward/backward runs tensor-parallel
        (activations replicated within a tp group, weights not)."""
        from ppoc_tpu.parallel import tp as tp_mod

        cfg = self.cfg
        tp_size = cfg.tp_size
        dp_size = self._build_mp_mesh(mesh, "tp", tp_size)
        self._check_dp_divisibility(dp_size)

        def pack_state(ts: ppo.TrainState):
            return _map_train_state(
                ts, lambda lst: tp_mod.pack_mlp(lst, tp_size)[0])

        mlp_specs = tp_mod.pack_mlp(full_state.policy_params["mlp"], tp_size)[1]
        v_specs = tp_mod.pack_mlp(full_state.v_params, tp_size)[1]
        pol_spec = {k: P() for k in full_state.policy_params}
        pol_spec["mlp"] = mlp_specs
        state_spec = ppo.TrainState(
            policy_params=pol_spec,
            v_params=v_specs,
            opt_policy=full_state.opt_policy._replace(
                m=mlp_specs, v=mlp_specs, t=P()),
            opt_v=full_state.opt_v._replace(m=v_specs, v=v_specs, t=P()),
            opt_log_std=jax.tree.map(lambda _: P(), full_state.opt_log_std),
        )

        def unpack_policy(pol_packed):
            pol = dict(pol_packed)
            pol["mlp"] = tp_mod.unpack_mlp_local(pol_packed["mlp"])
            return pol

        self._finalize_mp(
            pack_state(full_state), dp_size, "tp", "tp:tp", state_spec,
            unpack_local=lambda ts: _map_train_state(ts, tp_mod.unpack_mlp_local),
            repack_local=lambda ts: _map_train_state(ts, tp_mod.repack_mlp_local),
            unpack_policy=unpack_policy,
            pack_state=pack_state,
            unshard=lambda packed: _map_train_state(packed, tp_mod.unshard_packed),
        )

    # -- pipeline parallelism (parallel/pp.py) -------------------------------

    def _init_pp(self, full_state: ppo.TrainState, mesh: Optional[Mesh]):
        """GPipe pipeline over a 'pp' axis: both MLPs pack into per-stage
        padded layer stacks (StageParams, placed P("pp")); activations ride
        ppermute between stages, gradients arrive per-stage, and the three
        Adam states update stage-locally (padded-lane gradients are
        identically zero).  Integration standard mirrors TP (VERDICT r1
        next #1)."""
        from ppoc_tpu.parallel import pp as pp_mod

        cfg = self.cfg
        S = cfg.pp_size
        dp_size = self._build_mp_mesh(mesh, "pp", S)
        M = cfg.pp_microbatches or S
        for nm, val in (("n_envs", cfg.n_envs),
                        ("minibatch_size", cfg.minibatch_size),
                        ("eval_envs", cfg.eval_envs)):
            if val % dp_size or (val // dp_size) % M:
                raise ValueError(
                    f"{nm} ({val}) must be divisible by the dp size "
                    f"({dp_size}), and its per-device share "
                    f"({val // dp_size if val % dp_size == 0 else '?'}) must "
                    f"be divisible by the {M} GPipe microbatches"
                )

        def pack_moment(lst):
            # Adam m/v follow the StageParams layout, but their 'act' child
            # must be ZERO (pack_pp fills it with the structural activation
            # flags): act gradients are identically zero, so zero moments
            # keep the activation mask frozen under the per-leaf update.
            sp = pp_mod.pack_pp(lst, S)[0]
            return pp_mod.StageParams(
                sp.w, sp.b, jnp.zeros_like(sp.act), sp.widths
            )

        def pack_state(ts: ppo.TrainState) -> ppo.TrainState:
            return _map_train_state(
                ts, lambda lst: pp_mod.pack_pp(lst, S)[0], pack_moment)

        mlp_spec = pp_mod.pack_pp(full_state.policy_params["mlp"], S)[1]
        v_spec = pp_mod.pack_pp(full_state.v_params, S)[1]
        pol_spec = {k: P() for k in full_state.policy_params}
        pol_spec["mlp"] = mlp_spec
        state_spec = ppo.TrainState(
            policy_params=pol_spec,
            v_params=v_spec,
            opt_policy=full_state.opt_policy._replace(
                m=mlp_spec, v=mlp_spec, t=P()),
            opt_v=full_state.opt_v._replace(m=v_spec, v=v_spec, t=P()),
            opt_log_std=jax.tree.map(lambda _: P(), full_state.opt_log_std),
        )

        def unpack_policy(pol_packed):
            pol = dict(pol_packed)
            pol["mlp"] = pp_mod.unpack_pp_local(pol_packed["mlp"])
            return pol

        self._finalize_mp(
            pack_state(full_state), dp_size, "pp", f"pp:pp:{M}", state_spec,
            unpack_local=lambda ts: _map_train_state(ts, pp_mod.unpack_pp_local),
            repack_local=lambda ts: _map_train_state(ts, pp_mod.repack_pp_local),
            unpack_policy=unpack_policy,
            pack_state=pack_state,
            unshard=lambda packed: _map_train_state(packed, pp_mod.unshard_pp),
        )

    # -- expert parallelism (parallel/ep.py) ---------------------------------

    def _init_ep(self, full_state: ppo.TrainState, mesh: Optional[Mesh]):
        """MoE trunks with the stacked expert leaves placed P("ep").

        Unlike TP/PP there is no pack/unpack: the stacked expert layout
        ([E, ...] leading dim) IS the sharded layout, so the live state
        stays logical, shard_map's in_specs slice E -> E/ep on entry, and
        checkpoints are interchangeable with single-device MoE runs as-is.
        Every trunk forward computes the rank's local experts on the
        replicated batch and psums the mixture over 'ep' (models/moe.apply);
        the replicated router's partial gradients are summed over 'ep' by
        shard_map's own pvary transpose (see parallel/ep.py)."""
        from ppoc_tpu.models import mlp as mlp_mod
        from ppoc_tpu.parallel import ep as ep_mod

        cfg = self.cfg
        dp_size = self._build_mp_mesh(mesh, "ep", cfg.ep_size)
        self._check_dp_divisibility(dp_size)

        base = "bf16" if self.backend == "bf16" else "jnp"
        ep_backend = mlp_mod.moe_backend(base, cfg.moe_topk, ep_axis="ep")

        trunk_spec_pi = ep_mod.trunk_spec(full_state.policy_params["mlp"], "ep")
        trunk_spec_v = ep_mod.trunk_spec(full_state.v_params, "ep")
        pol_spec = {k: P() for k in full_state.policy_params}
        pol_spec["mlp"] = trunk_spec_pi
        state_spec = ppo.TrainState(
            policy_params=pol_spec,
            v_params=trunk_spec_v,
            opt_policy=full_state.opt_policy._replace(
                m=trunk_spec_pi, v=trunk_spec_pi, t=P()),
            opt_v=full_state.opt_v._replace(
                m=trunk_spec_v, v=trunk_spec_v, t=P()),
            opt_log_std=jax.tree.map(lambda _: P(), full_state.opt_log_std),
        )

        self._finalize_mp(full_state, dp_size, "ep", ep_backend, state_spec)

    # -- sequence parallelism (algo/seqpar.py) -------------------------------

    def _init_sp(self, full_state: ppo.TrainState, mesh: Optional[Mesh]):
        """Attention trunks over a (dp, sp) mesh: the rollout window itself
        time-shards — ring attention (parallel/ring_attn.py) for every
        parallel pass, the cross-shard GAE affine merge (parallel/sp.py),
        one tiled all_to_all per fit resharding the env-sharded rollout
        time-major (algo/seqpar.py).  Parameters and optimizer state stay
        replicated (gradients pmean over BOTH axes), so checkpoints are
        interchangeable with every other trainer mode as-is."""
        from ppoc_tpu.algo import seqpar

        cfg = self.cfg
        dp_size = self._build_mp_mesh(mesh, "sp", cfg.sp_size)
        total = dp_size * cfg.sp_size
        if cfg.n_envs % total or cfg.eval_envs % total:
            raise ValueError(
                f"n_envs ({cfg.n_envs}) and eval_envs ({cfg.eval_envs}) "
                f"must divide the WHOLE mesh ({total} devices): sp rollouts "
                f"shard envs over the flattened (dp, sp) mesh"
            )
        if cfg.minibatch_size % dp_size:
            raise ValueError(
                f"minibatch_size ({cfg.minibatch_size}) must be divisible "
                f"by the dp size ({dp_size})"
            )
        # ring passes run XLA's float32 block attention under every backend
        self.backend = "jnp"
        self._sp_ctx = dp_size
        n_envs_dp = cfg.n_envs // dp_size
        mb_dp = cfg.minibatch_size // dp_size

        def epoch_local(ts, key):
            return seqpar.train_epoch_sp(
                cfg, self.env, ts, key, cfg.mesh_axis, "sp",
                n_envs_dp, mb_dp)

        self._train_epoch = jax.jit(_shard_map(
            epoch_local, self.mesh, in_specs=(P(), P()),
            out_specs=(P(), P())))

        def make_eval(det):
            return jax.jit(_shard_map(
                functools.partial(
                    ppo.evaluate, cfg, self.env,
                    backend="jnp",
                    n_envs=cfg.eval_envs // total,
                    axis_name=(cfg.mesh_axis, "sp"),
                    deterministic=det,
                ),
                self.mesh, in_specs=(P(), P()), out_specs=P()))

        self._evaluate = make_eval(False)
        self._evaluate_det = make_eval(True)
        self.state = full_state

    # -- public API ---------------------------------------------------------

    def evaluate(self, deterministic: bool = False) -> ppo.EvalMetrics:
        """Stochastic eval by default (reference parity, src/ppo.cu:560-583);
        ``deterministic=True`` rolls out the policy mode — the mean-policy
        protocol benchmark scores use (compiled lazily on first use)."""
        k, self.key = jax.random.split(self.key)
        fn = self._evaluate_det if deterministic else self._evaluate
        m = fn(self.state.policy_params, k)
        return jax.tree.map(float, jax.device_get(m))

    def train_epoch(self) -> ppo.FitMetrics:
        k, self.key = jax.random.split(self.key)
        if self.cfg.fit_dispatch == "phased":
            return self._train_epoch_phased(k)
        if self.cfg.fits_per_program:
            return self._train_epoch_chunked(k)
        self.state, metrics = self._train_epoch(self.state, k)
        return metrics

    def _build_phased(self) -> None:
        """Jitted phase programs for cfg.fit_dispatch='phased': the
        sequence-trunk fit's four stages as SEPARATE executables.  Each
        mirrors the corresponding slice of ppo.fit_step/update_step
        exactly (same callees, same key positions): the un-jitted
        composition is bit-equal to fit_step
        (tests/test_fit_dispatch.py); across the new jit boundaries the
        compiled programs differ only at XLA fusion-rounding (FMA) level.
        What changes is compile granularity: four smaller programs in
        place of one, for windows whose fused fit program is very large
        to compile."""
        from ppoc_tpu.algo import recurrent

        cfg, env, backend = self.cfg, self.env, self.backend

        def _rollout(policy_params, k):
            traj, _carry = ppo.rollout(
                cfg, env, policy_params, k, cfg.n_envs, cfg.rollout_len,
                backend)
            return traj

        def _values_adv(v_params, traj):
            vpair = recurrent.compute_values_rnn(cfg, v_params, traj,
                                                 backend=backend)
            adv, target = ppo.compute_advantages(
                cfg, env, v_params, traj, None, "jnp", vpair)
            return vpair, adv, target, jnp.mean(traj.reward)

        def _vphase(ts, traj, target, vpair, k):
            return recurrent.value_phase_rnn(
                cfg, ts, traj, target, k, None, cfg.minibatch_size,
                v_old=vpair[0] if cfg.clip_value > 0.0 else None,
                backend=backend)

        def _pphase(ts, traj, adv, k, target):
            return recurrent.policy_phase_rnn(
                cfg, env, ts, traj, adv, k, None, cfg.minibatch_size,
                backend=backend,
                target=target if cfg.aux_value_coeff > 0.0 else None)

        self._ph_rollout = jax.jit(_rollout)
        self._ph_values_adv = jax.jit(_values_adv)
        self._ph_vphase = jax.jit(_vphase)
        self._ph_pphase = jax.jit(_pphase)

        if cfg.rollout_chunk > 0:
            # segmented decode (cfg.rollout_chunk): ONE compiled
            # chunk-step scan reused across the window's segments, carry
            # threaded between dispatches; same per-step key stream as
            # the monolithic scan (rollout_rnn splits k_scan into
            # `length` keys — we do the identical split host-side and
            # feed slices) — a compile-size option: one segment program
            # in place of a window-long decode scan.
            from ppoc_tpu.envs.core import vector_reset

            @functools.partial(jax.jit, static_argnums=(2,))
            def _rollinit(policy_params, k, n):
                env_state, obs = vector_reset(env, k, n)
                s0 = recurrent.initial_seq_state(cfg, policy_params, n)
                return env_state, obs, s0

            @functools.partial(jax.jit, static_argnums=(2,))
            def _rollseg(policy_params, carry, det, keys_seg):
                step = recurrent.rollout_step_fn(cfg, env, policy_params,
                                                 det)
                return jax.lax.scan(step, carry, keys_seg)

            self._ph_rollinit = _rollinit
            self._ph_rollseg = _rollseg
            self._ph_force_trunc = jax.jit(recurrent.force_truncate_traj)
            reference_est = cfg.eval_estimator == "reference"

            def _eval_metrics(traj):
                if reference_est:
                    return ppo.eval_metrics_reference(traj,
                                                      env.spec.gamma)
                return ppo.eval_metrics_from_traj(traj, env.spec.gamma)

            self._ph_eval_metrics = jax.jit(_eval_metrics)

            def _eval_chunked(policy_params, k, det):
                traj = self._chunked_rollout(
                    policy_params, k, cfg.eval_envs, cfg.eval_len,
                    deterministic=det, force_truncate=False)
                return self._ph_eval_metrics(traj)

            self._evaluate = functools.partial(_eval_chunked, det=False)
            self._evaluate_det = functools.partial(_eval_chunked, det=True)

    def _chunked_rollout(self, policy_params, key, n_envs: int,
                         length: int, deterministic: bool,
                         force_truncate: bool):
        """ceil(length / cfg.rollout_chunk) dispatches of the compiled
        segment program; identical per-step keys to rollout_rnn."""
        S = self.cfg.rollout_chunk
        k_reset, k_scan = jax.random.split(key)
        carry = self._ph_rollinit(policy_params, k_reset, n_envs)
        keys = jax.random.split(k_scan, length)
        segs = []
        for i in range(0, length, S):
            carry, traj_seg = self._ph_rollseg(policy_params, carry,
                                               deterministic,
                                               keys[i:i + S])
            segs.append(traj_seg)
        traj = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *segs)
        if force_truncate:
            traj = self._ph_force_trunc(traj)
        return traj

    def _train_epoch_phased(self, key: jax.Array) -> ppo.FitMetrics:
        cfg = self.cfg
        keys = jax.random.split(key, cfg.fits_per_epoch)
        fit_metrics = []
        for key_f in keys:
            # fit_step's splits (axis_name None: _device_key is identity,
            # no k_upd_common), then update_step's
            k_roll, k_upd = jax.random.split(key_f)
            k_val, k_pol = jax.random.split(k_upd)
            if cfg.rollout_chunk > 0:
                traj = self._chunked_rollout(
                    self.state.policy_params, k_roll, cfg.n_envs,
                    cfg.rollout_len, deterministic=False,
                    force_truncate=True)
            else:
                traj = self._ph_rollout(self.state.policy_params, k_roll)
            vpair, adv, target, mean_rew = self._ph_values_adv(
                self.state.v_params, traj)
            self.state, v_loss = self._ph_vphase(
                self.state, traj, target, vpair, k_val)
            self.state, p_loss, ent = self._ph_pphase(
                self.state, traj, adv, k_pol, target)
            fit_metrics.append(ppo.FitMetrics(
                value_loss=v_loss, policy_loss=p_loss, entropy=ent,
                mean_reward=mean_rew))
        return jax.tree.map(lambda *xs: jnp.mean(jnp.stack(xs)),
                            *fit_metrics)

    def _train_epoch_chunked(self, key: jax.Array) -> ppo.FitMetrics:
        """cfg.fits_per_program-sized compiled chunks over the fused
        epoch's exact key stream (ppo.train_epoch's split order), so the
        parameter trajectory is bit-identical to the one-program scan
        (tests/test_fits_per_program.py)."""
        cfg = self.cfg
        carry = None
        if not cfg.reset_per_fit:
            k_reset, key = jax.random.split(key)
            carry = self._reset_carry(k_reset)
        keys = jax.random.split(key, cfg.fits_per_epoch)
        ts, chunk_metrics = self.state, []
        for i in range(0, cfg.fits_per_epoch, cfg.fits_per_program):
            ts, carry, m = self._train_fits(
                ts, keys[i:i + cfg.fits_per_program], env_carry=carry)
            chunk_metrics.append(m)
        self.state = ts
        # equal-size chunks: mean of chunk means == the fused global mean
        return jax.tree.map(lambda *xs: jnp.mean(jnp.stack(xs)),
                            *chunk_metrics)

    def train(
        self,
        n_epochs: Optional[int] = None,
        log: bool = True,
        stop_at_R: Optional[float] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 1,
        initial_eval: bool = True,
        eval_deterministic: bool = False,
        on_epoch_end=None,
        epoch_offset: int = 0,
    ) -> List[Dict[str, Any]]:
        """Full training run; returns per-epoch metric dicts.

        ``stop_at_R`` stops early once the mean undiscounted eval return
        reaches the threshold (used by the solve-time benchmark).
        ``eval_deterministic`` scores each epoch with the mean policy (the
        canonical benchmark protocol) instead of the reference's stochastic
        evaluator — stop_at_R then gates on the deterministic R too.
        ``checkpoint_path`` enables a mid-training checkpoint every
        ``checkpoint_every`` epochs (full optimization state incl. Adam
        m/v/t AND the trainer PRNG key; the reference only saves at the
        very end, src/main.c:58).  Checkpoints are written right after the
        per-epoch evaluation, so resuming with
        ``Trainer.from_checkpoint(path).train(..., initial_eval=False)``
        replays the remaining epochs bit-for-bit (tests/test_resume.py) —
        ``initial_eval=False`` skips the pre-training evaluation (and its
        PRNG split) that the interrupted run already consumed.  Periodic
        checkpoints record ``epochs_done`` in the file metadata so a
        crash-restarted run (utils/supervisor.py, CLI --supervise) finishes
        exactly the ORIGINAL schedule.  ``on_epoch_end(i, row)`` is called
        after each epoch's metrics/checkpoint; returning truthy stops
        training cleanly (the CLI's graceful-preemption hook).
        ``epoch_offset`` shifts the recorded epochs_done on a resumed run so
        the counter stays cumulative across restarts.
        """
        n_epochs = self.cfg.n_epochs if n_epochs is None else n_epochs
        history: List[Dict[str, Any]] = []
        best_R, since_improve, transplanted = -float("inf"), 0, False
        if initial_eval:
            m0 = self.evaluate(deterministic=eval_deterministic)
            if log:
                print(f"J: {m0.J:f} R: {m0.R:f} Episodes: {int(m0.episodes)}",
                      flush=True)
        for i in range(n_epochs):
            tic = time.perf_counter()
            fit_metrics = self.train_epoch()
            fit_metrics = jax.tree.map(float, jax.device_get(fit_metrics))
            toc = time.perf_counter()
            ev = self.evaluate(deterministic=eval_deterministic)
            row = {
                "epoch": i,
                "entropy": fit_metrics.entropy,
                "time_s": toc - tic,
                "J": ev.J,
                "R": ev.R,
                "episodes": int(ev.episodes),
                "value_loss": fit_metrics.value_loss,
                "policy_loss": fit_metrics.policy_loss,
                "mean_reward": fit_metrics.mean_reward,
            }
            history.append(row)
            if log:
                print(
                    f"Epoch: {i} Entropy: {row['entropy']:f} Time {row['time_s']:f}s "
                    f"J: {row['J']:f} R: {row['R']:f} Episodes: {row['episodes']}",
                    flush=True,
                )
            if (checkpoint_path is not None and checkpoint_every > 0
                    and (i + 1) % checkpoint_every == 0):
                self.save(checkpoint_path,
                          meta={"epochs_done": epoch_offset + i + 1})
            if stop_at_R is not None and ev.R >= stop_at_R:
                break
            if self.cfg.transplant_patience > 0 and not transplanted:
                if ev.R >= best_R + 0.05:
                    best_R, since_improve = ev.R, 0
                else:
                    since_improve += 1
                    if since_improve >= self.cfg.transplant_patience:
                        self.transplant_value_trunk()
                        transplanted = True
                        row["transplanted"] = True
                        if log:
                            print(f"Epoch: {i} plateau "
                                  f"({since_improve} epochs < +0.05 R) — "
                                  f"critic->policy encoder transplant",
                                  flush=True)
            if on_epoch_end is not None and on_epoch_end(i, row):
                break
        return history

    def transplant_value_trunk(self) -> None:
        """Replace the POLICY trunk's encoder with a copy of the CRITIC's,
        keeping the action head and log_std, and reset the policy Adam
        moments.  The measured rescue for the recall_long plateau: the critic builds the cue-retrieval
        attention circuit through supervised value regression within ~3
        epochs; a policy whose own gradient cannot bootstrap that circuit
        (zero head readout => no surrogate gradient into attention) lifts
        within ~3 epochs of receiving it — while a FRESH random encoder
        does not rescue, pinning the mechanism to the circuit itself.
        Auto-triggered on plateau by cfg.transplant_patience; callable
        directly for manual rescues.  Sequence trunks only."""
        from ppoc_tpu.models import attn as attn_mod, gru as gru_mod
        from ppoc_tpu.ops import adam as adam_ops

        ts = self.state
        old = ts.policy_params["mlp"]
        if not (attn_mod.is_attn(old) or gru_mod.is_rnn(old)):
            raise ValueError(
                "transplant_value_trunk needs a sequence trunk "
                "(attention or GRU/LSTM): dense trunks have no shared "
                "encoder to transplant"
            )
        trunk = dict(old)
        if attn_mod.is_attn(trunk):
            trunk["attn"] = jax.tree.map(jnp.copy, ts.v_params["attn"])
        else:
            trunk["cell"] = jax.tree.map(jnp.copy, ts.v_params["cell"])
        pol = dict(ts.policy_params)
        pol["mlp"] = trunk
        self.state = ts._replace(policy_params=pol,
                                 opt_policy=adam_ops.init(trunk))

    def solve(self, target_R: float, max_epochs: int = 100) -> Dict[str, Any]:
        """Train until eval R >= target_R as ONE device program (see
        ppo.train_until); returns {"epochs": n, "R": R}.  Compiles on first
        use; subsequent calls with the same config reuse the executable."""
        if (self.cfg.fit_dispatch != "fused" or self.cfg.fits_per_program
                or self.cfg.rollout_chunk):
            raise ValueError(
                "solve() compiles the whole train-until loop as ONE device "
                "program — strictly larger than the fused epoch the "
                "fit_dispatch/fits_per_program/rollout_chunk compile-size "
                "options exist to split; use train(stop_at_R=...) with "
                "these settings"
            )
        if self._solve_fn is not None and self._solve_args != (target_R, max_epochs):
            self._solve_fn = None
        self._solve_args = (target_R, max_epochs)
        if self._solve_fn is None:
            if getattr(self, "_sp_ctx", None) is not None:
                from ppoc_tpu.algo import seqpar

                cfg = self.cfg
                dp_size = self._sp_ctx
                total = self.mesh.size

                def solve_local_sp(ts, key):
                    return seqpar.train_until_sp(
                        cfg, self.env, ts, key, target_R, max_epochs,
                        cfg.mesh_axis, "sp",
                        cfg.n_envs // dp_size,
                        cfg.minibatch_size // dp_size,
                        cfg.eval_envs // total,
                    )

                self._solve_fn = jax.jit(_shard_map(
                    solve_local_sp, self.mesh,
                    in_specs=(P(), P()), out_specs=(P(), P(), P())))
            elif getattr(self, "_mp_ctx", None) is not None:
                # any model-parallel mode (tp/pp/ep): one shard_map'd
                # train_until over the stored 2-D mesh context
                dp_size, model_axis, unpack_local, repack_local = self._mp_ctx
                cfg = self.cfg

                def solve_local(ts_packed, key):
                    ts, n, R = ppo.train_until(
                        cfg, self.env, unpack_local(ts_packed), key,
                        target_R=target_R, max_epochs=max_epochs,
                        axis_name=cfg.mesh_axis,
                        n_envs=cfg.n_envs // dp_size,
                        mb_size=cfg.minibatch_size // dp_size,
                        backend=self.backend,
                        eval_envs=cfg.eval_envs // dp_size,
                    )
                    n = jax.lax.pmax(n, model_axis)
                    R = jax.lax.pmean(R, model_axis)
                    return repack_local(ts), n, R

                self._solve_fn = jax.jit(_shard_map(
                    solve_local, self.mesh,
                    in_specs=(self._state_spec, P()),
                    out_specs=(self._state_spec, P(), P()),
                ))
            elif self.mesh is not None:
                n_dev = self.mesh.size
                local = functools.partial(
                    ppo.train_until, self.cfg, self.env,
                    target_R=target_R, max_epochs=max_epochs,
                    axis_name=self.cfg.mesh_axis,
                    n_envs=self.cfg.n_envs // n_dev,
                    mb_size=self.cfg.minibatch_size // n_dev,
                    backend=self.backend,
                    eval_envs=self.cfg.eval_envs // n_dev,
                )
                spec = self._dp_state_spec
                self._solve_fn = jax.jit(_shard_map(
                    local, self.mesh, in_specs=(spec, P()),
                    out_specs=(spec, P(), P()),
                    check_vma=getattr(self, "_dp_check_vma", True),
                ))
            else:
                self._solve_fn = jax.jit(functools.partial(
                    ppo.train_until, self.cfg, self.env,
                    target_R=target_R, max_epochs=max_epochs,
                    backend=self.backend,
                ))
        k, self.key = jax.random.split(self.key)
        self.state, n, R = self._solve_fn(self.state, k)
        n, R = jax.device_get((n, R))
        return {"epochs": int(n), "R": float(R)}

    def save(self, path: str, meta: Optional[Dict[str, Any]] = None) -> None:
        from ppoc_tpu.utils import checkpoint

        # always serialize the logical (unsharded) layout, so tp/pp/plain
        # checkpoints are interchangeable across trainer modes
        state = self._unshard_state(jax.device_get(self.state))
        checkpoint.save(path, self.cfg, self.env.spec, state, key=self.key,
                        meta=meta)

    def load(self, path: str) -> None:
        from ppoc_tpu.utils import checkpoint

        # validate against the UNSHARDED view of the live state
        template = self._unshard_state(jax.device_get(self.state))
        ck = checkpoint.load(path)
        state = checkpoint.adapt_to_template(ck.state, template)
        checkpoint._check_template(state, template)
        self.state = self._pack_state(state)
        if ck.key is not None:
            self.key = ck.key

    @classmethod
    def from_checkpoint(cls, path: str, mesh: Optional[Mesh] = None,
                        **overrides) -> "Trainer":
        """Rebuild a complete Trainer — config, env, nets, all three Adam
        states, trainer PRNG position — from the checkpoint file alone.

        Parity with the reference's load_ppo, which reconstructs the whole
        PPO struct and rewires the optimizers from the file
        (src/ppo.cu:610-648).  ``overrides`` replace config fields for the
        new run (e.g. a different mesh/backend on the restore host) — fields
        that change parameter shapes (hidden, env) will fail validation.
        Requires a version-3 checkpoint (written by this version's save).
        """
        from ppoc_tpu.utils import checkpoint

        ck = checkpoint.load(path)
        if ck.cfg is None:
            raise ValueError(
                f"{path}: version-2 checkpoint has no embedded config; "
                f"construct Trainer(cfg) with the original config and call "
                f".load(path) instead"
            )
        cfg = ck.cfg.replace(**overrides) if overrides else ck.cfg
        tr = cls(cfg, mesh=mesh)
        template = tr._unshard_state(jax.device_get(tr.state))
        state = checkpoint.adapt_to_template(ck.state, template)
        checkpoint._check_template(state, template)
        tr.state = tr._pack_state(state)
        if ck.key is not None:
            tr.key = ck.key
        return tr
