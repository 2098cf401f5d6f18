"""Command-line driver.

Equivalent of the reference driver ``src/main.c:13-64``: build env + trainer,
evaluate, train n_epochs with per-epoch metrics lines, save the model.  Where
the reference hard-codes hyperparameters (src/main.c:20-44) and exposes one
positional CLI arg (hidden width, src/main.c:21-23), every PPOConfig field is
a flag here, plus preset selection and a benchmark mode.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from ppoc_tpu.config import (PPOConfig, reference_preset, throughput_preset,
                             tuned_preset)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ppoc_tpu",
        description="PPO trainer in JAX (capabilities of cube1324/ppo.c)",
    )
    p.add_argument("--preset", choices=["reference", "throughput", "tuned"],
                   default="reference",
                   help="base config: 'reference' = parity with src/main.c "
                        "hyperparameters; 'throughput' = large-batch sized")
    p.add_argument("--save", metavar="PATH", default=None,
                   help="checkpoint path written after training "
                        "(reference: ppo_model.bin, src/main.c:58)")
    p.add_argument("--load", metavar="PATH", default=None,
                   help="checkpoint to load weights/optimizers from before "
                        "training (config comes from the flags)")
    p.add_argument("--resume", metavar="PATH", default=None,
                   help="rebuild the trainer ENTIRELY from a checkpoint "
                        "(config + state + RNG position, "
                        "Trainer.from_checkpoint) and continue training "
                        "bit-exactly; other config flags are ignored")
    p.add_argument("--import-ref", metavar="PATH", default=None,
                   help="build the trainer from a REFERENCE-format "
                        "checkpoint (ppo.c's save_ppo binary, "
                        "src/ppo.cu:585-648): net shapes, weights, log_std "
                        "and all three Adam states come from the file; "
                        "rollout schedule from the flags (utils/ref_interop)")
    p.add_argument("--export-ref", metavar="PATH", default=None,
                   help="after training, also write the model in the "
                        "reference's load_ppo binary format (Gaussian "
                        "policies only)")
    p.add_argument("--eval-only", action="store_true",
                   help="evaluate (optionally after --load) and exit")
    p.add_argument("--stop-at-R", type=float, default=None,
                   help="stop once mean undiscounted eval return reaches this")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="with --save: also checkpoint every N epochs during "
                        "training (crash-resumable; reference saves only at "
                        "the end)")
    p.add_argument("--solve-R", type=float, default=None,
                   help="train-until-R as ONE device program (ppo.train_until) "
                        "instead of the host epoch loop; prints epochs used")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="data-parallel mesh over N devices (0 = single device; "
                        "with --num-processes, N counts GLOBAL devices and 0 "
                        "means all of them)")
    p.add_argument("--coordinator", metavar="HOST:PORT", default=None,
                   help="multi-host bootstrap: jax.distributed coordinator "
                        "address (process 0's host); requires "
                        "--num-processes and --process-id")
    p.add_argument("--num-processes", type=int, default=None, metavar="N",
                   help="multi-host: total process count")
    p.add_argument("--process-id", type=int, default=None, metavar="I",
                   help="multi-host: this process's rank in [0, N)")
    p.add_argument("--supervise", type=int, default=0, metavar="N",
                   help="elastic recovery: run training in a supervised "
                        "subprocess and restart it from the --save "
                        "checkpoint on crash or preemption, up to N times "
                        "(utils/supervisor.py); requires --save and "
                        "--checkpoint-every.  The child checkpoints and "
                        "exits cleanly on SIGTERM (graceful preemption); "
                        "PPOC_FAULT_EPOCH=k injects a hard crash after "
                        "epoch k for drills")
    p.add_argument("--sweep", type=int, default=0, metavar="S",
                   help="seed-parallel sweep: train S seeds (seed..seed+S-1) "
                        "as ONE vmapped device program (ppoc_tpu.sweep); "
                        "with --solve-R reports per-seed epochs/R, else "
                        "per-seed learning curves.  On-device envs, single "
                        "device")
    p.add_argument("--grid", action="append", default=None,
                   metavar="HP=V1,V2,...",
                   help="hyperparameter grid axis (repeatable): train every "
                        "combination of the given values — crossed with "
                        "--sweep S seeds if given — as ONE vmapped device "
                        "program (ppoc_tpu.sweep.solve_grid/train_grid).  "
                        "HP is one of sweep.SWEEPABLE_HPARAMS (lr-policy, "
                        "clip-eps, ent-coeff, ...)")
    p.add_argument("--score-episodes", type=int, default=0, metavar="N",
                   help="with --eval-only: aggregate evaluation over at "
                        "least N COMPLETED episodes (repeated eval rounds, "
                        "episode-weighted means) — the canonical scoring "
                        "protocol behind docs/RESULTS.md")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="capture a jax.profiler trace of the training run "
                        "into DIR (utils/profiling.trace; open with xprof/"
                        "tensorboard)")
    p.add_argument("--jsonl", action="store_true",
                   help="emit per-epoch metrics as JSON lines instead of text")
    p.add_argument("--det-eval", action="store_true",
                   help="evaluate with the MEAN policy (canonical benchmark "
                        "protocol) instead of the reference's stochastic "
                        "evaluator; applies to per-epoch metrics, "
                        "--stop-at-R and --eval-only")
    p.add_argument("--hidden", type=int, nargs="+", default=None, metavar="W",
                   help="hidden layer widths (reference CLI arg, src/main.c:21-23)")
    p.add_argument("--actor", choices=["host", "device"], default="host",
                   help="gym:* envs only — 'host': numpy policy on the host, "
                        "weights synced once per fit (no device round trip "
                        "per step); 'device': batched device sampling")
    p.add_argument("--overlap", action="store_true",
                   help="host-bridge actor/learner overlap: collect window "
                        "i+1 on the host while the device fits window i "
                        "(one-fit-stale actor weights; requires "
                        "--actor host)")
    p.add_argument("--vector-mode", choices=["sync", "async"], default="sync",
                   help="gym:* envs only — gymnasium.vector stepping mode")
    p.add_argument("--calibrate", action="store_true",
                   help="on-device envs only — measure observation "
                        "statistics with a random policy before training "
                        "and bake them into obs_loc/obs_scale "
                        "(envs.wrappers.calibrate); the config-carried "
                        "static normalization")
    p.add_argument("--obs-norm", action="store_true",
                   help="gym:* envs only — running observation normalization "
                        "(envs/wrappers.RunningObsNorm); statistics are "
                        "checkpointed as an .obsnorm.npz sidecar")
    p.add_argument("--reward-norm", action="store_true",
                   help="gym:* envs only — scale training rewards by the "
                        "running std of the discounted return "
                        "(envs/wrappers.RunningRewardNorm); eval reports "
                        "raw-reward J/R")

    # every config field becomes a flag
    for f in dataclasses.fields(PPOConfig):
        if f.name == "hidden":
            continue
        arg = "--" + f.name.replace("_", "-")
        if f.type == "bool" or isinstance(f.default, bool):
            p.add_argument(arg, type=lambda s: s.lower() in ("1", "true", "yes"),
                           default=None, metavar="BOOL")
        elif isinstance(f.default, int):
            p.add_argument(arg, type=int, default=None)
        elif isinstance(f.default, float):
            p.add_argument(arg, type=float, default=None)
        elif isinstance(f.default, tuple):
            # float-tuple fields (obs_loc/obs_scale): comma-separated
            p.add_argument(arg,
                           type=lambda s: tuple(float(x)
                                                for x in s.split(",")),
                           default=None, metavar="F[,F...]")
        else:
            p.add_argument(arg, type=str, default=None)
    return p


def config_from_args(args: argparse.Namespace) -> PPOConfig:
    cfg = {"reference": reference_preset, "throughput": throughput_preset,
           "tuned": tuned_preset}[args.preset]()
    overrides = {}
    for f in dataclasses.fields(PPOConfig):
        if f.name == "hidden":
            continue
        v = getattr(args, f.name, None)
        if v is not None:
            overrides[f.name] = v
    if args.hidden is not None:
        overrides["hidden"] = tuple(args.hidden)
    return cfg.replace(**overrides)


def _json_safe(row: dict) -> dict:
    """Replace non-finite floats (eval R/J are -inf when no episode
    completes in the window) with None — json.dumps would otherwise emit
    the non-RFC token -Infinity and break strict parsers."""
    import math

    return {k: (None if isinstance(v, float) and not math.isfinite(v) else v)
            for k, v in row.items()}


def main(argv=None) -> int:
    import os

    # PPOC_PLATFORM / PPOC_CPU_DEVICES: pin the JAX platform (and the
    # virtual CPU device count) through the config API before backend
    # init — how supervised/elastic child processes (utils/supervisor.py)
    # and tests pin themselves to the CPU.
    plat = os.environ.get("PPOC_PLATFORM")
    if plat:
        import jax

        jax.config.update("jax_platforms", plat)
        n_cpu = os.environ.get("PPOC_CPU_DEVICES")
        if n_cpu:
            jax.config.update("jax_num_cpu_devices", int(n_cpu))
    # persistent XLA compilation cache: restarted runs (supervisor children,
    # repeated CLI invocations) skip the trace+compile cost (utils/cache.py)
    from ppoc_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    parser = build_parser()
    raw_argv = list(sys.argv[1:] if argv is None else argv)
    args = parser.parse_args(argv)
    if args.checkpoint_every > 0 and not args.save:
        parser.error("--checkpoint-every requires --save PATH (the "
                     "checkpoint destination)")
    if args.score_episodes and not args.eval_only:
        parser.error("--score-episodes applies to --eval-only scoring; "
                     "pass both")
    if args.checkpoint_every > 0 and args.solve_R is not None:
        print("warning: --checkpoint-every has no effect with --solve-R "
              "(the solve loop is one device program; a checkpoint is "
              "written at the end when --save is given)", file=sys.stderr)
    cfg = config_from_args(args)
    # fail fast on inconsistent flag combinations with the SAME validation
    # bank Trainer and sweep run (config.validate — one definition), surfaced
    # as a parser error instead of a traceback mid-startup
    from ppoc_tpu import config as _config_mod

    try:
        _config_mod.validate(cfg)
    except ValueError as e:
        parser.error(str(e))

    if args.supervise:
        # elastic mode: this process becomes the supervisor; training runs
        # in child processes restarted from the checkpoint on failure.
        # The supervisor never initializes a JAX backend: a JAX process
        # reserves most of the GPU's memory on first use, and the child
        # must be the one process on the card
        if not (args.save and args.checkpoint_every > 0):
            parser.error("--supervise requires --save PATH and "
                         "--checkpoint-every N (the restart source)")
        if args.solve_R is not None or args.eval_only or args.sweep \
                or args.grid:
            parser.error("--supervise applies to epoch-loop training, not "
                         "--solve-R/--eval-only/--sweep/--grid (sweeps "
                         "write no checkpoint to restart from)")
        from ppoc_tpu.utils import supervisor

        first = [a for i, a in enumerate(raw_argv)
                 if a != "--supervise" and not a.startswith("--supervise=")
                 and not (i > 0 and raw_argv[i - 1] == "--supervise")]
        restart = supervisor.build_restart_argv(
            raw_argv, args.save, gym_env=cfg.env.startswith("gym:"))
        return supervisor.supervise(first, restart, args.save,
                                    max_restarts=args.supervise)

    distributed = (args.coordinator is not None or args.num_processes is not None
                   or args.process_id is not None)
    if distributed:
        if None in (args.coordinator, args.num_processes, args.process_id):
            parser.error("multi-host mode needs all of --coordinator, "
                         "--num-processes and --process-id")
        # MUST run before any import that touches the XLA backend (the env
        # registry builds jnp constants at import time)
        from ppoc_tpu.parallel.mesh import initialize_distributed
        initialize_distributed(args.coordinator, args.num_processes,
                               args.process_id)

    from ppoc_tpu.algo.trainer import Trainer  # deferred: imports jax

    if args.calibrate:
        if cfg.env.startswith("gym:") or args.resume or args.import_ref \
                or args.load:
            parser.error("--calibrate applies to fresh on-device-env runs "
                         "(gym:* envs use --obs-norm; --resume/--import-ref/"
                         "--load carry weights trained under their OWN "
                         "normalization — calibrating underneath them would "
                         "skew every observation the policy sees)")
        if cfg.obs_loc or cfg.obs_scale:
            parser.error("--calibrate would overwrite the explicit "
                         "--obs-loc/--obs-scale values; pass one or the "
                         "other")
        from ppoc_tpu.envs.wrappers import calibrate as _calibrate

        cfg = _calibrate(cfg)
        print(f"calibrated obs_loc={tuple(round(x, 4) for x in cfg.obs_loc)} "
              f"obs_scale={tuple(round(x, 4) for x in cfg.obs_scale)}",
              file=sys.stderr)

    if args.sweep or args.grid:
        if args.sweep and args.sweep < 1:
            parser.error(f"--sweep needs a positive seed count, got "
                         f"{args.sweep}")
        if (cfg.env.startswith("gym:") or args.mesh or distributed
                or args.load or args.resume or args.import_ref
                or args.eval_only):
            parser.error("--sweep/--grid run fresh on-device single-device "
                         "training only (no gym:/--mesh/--load/--resume/"
                         "--import-ref/--eval-only)")
        if args.save or args.export_ref or args.det_eval \
                or args.stop_at_R is not None:
            parser.error("--save/--export-ref/--det-eval/--stop-at-R do "
                         "not apply to --sweep/--grid (per-lane statistics "
                         "only; use --solve-R for the stop threshold, then "
                         "train the winning config normally to get a "
                         "checkpoint)")
        import json as _json

        from ppoc_tpu import sweep as sweep_mod

        seeds = list(range(cfg.seed, cfg.seed + max(args.sweep, 1)))
        if args.grid:
            axes = {}
            for spec in args.grid:
                name, eq, vals = spec.partition("=")
                name = name.replace("-", "_")
                if not eq or not vals:
                    parser.error(f"--grid expects HP=V1,V2,... , got {spec!r}")
                if name not in sweep_mod.SWEEPABLE_HPARAMS:
                    parser.error(
                        f"--grid {name}: not sweepable; choose from "
                        f"{', '.join(sweep_mod.SWEEPABLE_HPARAMS)}")
                try:
                    axes[name] = [float(v) for v in vals.split(",")]
                except ValueError:
                    parser.error(f"--grid {spec!r}: values must be numbers")
            if args.solve_R is not None:
                out = sweep_mod.solve_grid(cfg, axes, target_R=args.solve_R,
                                           seeds=seeds,
                                           max_epochs=cfg.n_epochs)
                for c, e, r in zip(out["combos"], out["epochs"], out["R"]):
                    hp = {k: v for k, v in c.items() if k != "seed"}
                    print(f"{hp} seed={c['seed']} "
                          f"solved={r >= args.solve_R} epochs={e} R={r:f}")
                best = out["combos"][out["best"]]
                print(f"best: {best} (epochs="
                      f"{out['epochs'][out['best']]}, "
                      f"R={out['R'][out['best']]:f})")
                return 0
            out = sweep_mod.train_grid(cfg, axes, seeds=seeds,
                                       n_epochs=args.n_epochs)
            import math as _math

            for c, curve in zip(out["combos"], out["R"]):
                row = dict(c)
                row["R"] = [round(float(x), 3) if _math.isfinite(float(x))
                            else None for x in curve]
                print(_json.dumps(row))
            return 0
        if args.solve_R is not None:
            out = sweep_mod.solve_many(cfg, seeds, target_R=args.solve_R,
                                       max_epochs=cfg.n_epochs)
            for s, e, r in zip(seeds, out["epochs"], out["R"]):
                print(f"seed={s} solved={r >= args.solve_R} epochs={e} "
                      f"R={r:f}")
            return 0
        out = sweep_mod.train_many(cfg, seeds, n_epochs=args.n_epochs)
        R = out["R"]
        for i, s in enumerate(seeds):
            curve = [round(float(x), 3) for x in R[i]]
            print(_json.dumps({"seed": s, "R": curve}))
        if R.shape[1]:  # --n-epochs 0 has no final epoch to summarize
            import numpy as _np

            print(f"final R over {len(seeds)} seeds: "
                  f"mean={float(_np.mean(R[:, -1])):.3f} "
                  f"std={float(_np.std(R[:, -1])):.3f} "
                  f"min={float(_np.min(R[:, -1])):.3f} "
                  f"max={float(_np.max(R[:, -1])):.3f}")
        return 0

    epoch_offset = 0  # cumulative epochs_done carried across restarts
    mesh = None
    if args.mesh or distributed:
        from ppoc_tpu.parallel import make_mesh
        mesh = make_mesh(args.mesh or None)  # 0/None = all (global) devices

    if cfg.env.startswith("gym:"):
        # host-bridge training on any Gymnasium env (the reference driver's
        # create_gym_env path, src/main.c:25): --env gym:BipedalWalker-v3
        if args.solve_R is not None or args.resume or args.import_ref \
                or mesh is not None:
            parser.error("gym:* envs use the host bridge; --solve-R, "
                         "--resume, --import-ref and --mesh apply to "
                         "on-device envs only")
        from ppoc_tpu.envs.gym_bridge import GymTrainer

        trainer = GymTrainer(cfg, cfg.env[4:], vector_mode=args.vector_mode,
                             actor=args.actor, obs_norm=args.obs_norm,
                             reward_norm=args.reward_norm,
                             overlap=args.overlap)
        if args.load:
            trainer.load(args.load)
    elif args.obs_norm or args.reward_norm:
        parser.error("--obs-norm/--reward-norm apply to gym:* host-bridge "
                     "envs; on-device envs use --calibrate (config-carried "
                     "static normalization)")
    elif args.overlap:
        parser.error("--overlap (host actor/learner pipelining) applies to "
                     "gym:* host-bridge envs; on-device envs run rollout + "
                     "update as one fused program — there is no host actor "
                     "to overlap")
    elif args.import_ref:
        if args.load or args.resume:
            parser.error("--import-ref replaces --load/--resume")
        from ppoc_tpu.utils import ref_interop
        # hyperparameters the reference file carries win unless the matching
        # flag was passed explicitly; the rollout schedule (which the file
        # does not carry) always comes from the flags/preset
        file_fields = ("hidden", "activation", "lam", "clip_eps", "ent_coeff",
                       "lr_policy", "lr_v", "adam_beta1", "adam_beta2")
        overrides = {}
        for f in dataclasses.fields(PPOConfig):
            if f.name == "env":
                continue
            explicit = (args.hidden is not None if f.name == "hidden"
                        else getattr(args, f.name, None) is not None)
            if f.name in file_fields and not explicit:
                continue
            overrides[f.name] = getattr(cfg, f.name)
        trainer = ref_interop.load_trainer(args.import_ref, cfg.env,
                                           mesh=mesh, **overrides)
        cfg = trainer.cfg
    elif args.resume:
        from ppoc_tpu.utils import checkpoint as _ck

        _saved = _ck.load(args.resume)
        saved_cfg = _saved.cfg
        if saved_cfg is not None and saved_cfg.env.startswith("gym:"):
            parser.error(
                f"{args.resume} was trained on the host bridge "
                f"({saved_cfg.env}); --resume is device-only — use "
                f"--env {saved_cfg.env} --load {args.resume} instead"
            )
        trainer = Trainer.from_checkpoint(args.resume, mesh=mesh)
        cfg = trainer.cfg
        epoch_offset = int(_saved.meta.get("epochs_done", 0))
        if args.n_epochs is None and epoch_offset:
            # mid-run checkpoint (elastic restart): finish the ORIGINAL
            # schedule rather than training cfg.n_epochs more
            remaining = cfg.n_epochs - epoch_offset
            if remaining <= 0:
                print(f"{args.resume}: all {cfg.n_epochs} epochs already "
                      f"done; nothing to resume", file=sys.stderr)
                return 0
            args.n_epochs = remaining
    else:
        trainer = Trainer(cfg, mesh=mesh)
        if args.load:
            trainer.load(args.load)

    is_main = True
    if distributed:
        import jax
        is_main = jax.process_index() == 0

    if args.eval_only:
        if args.score_episodes:
            from ppoc_tpu.algo.trainer import score

            s = score(trainer, episodes=args.score_episodes,
                      deterministic=args.det_eval)
            if is_main:
                print(f"J: {s['J']:f} R: {s['R']:f} "
                      f"Episodes: {s['episodes']} (over {s['rounds']} "
                      f"eval rounds)")
            return 0
        m = trainer.evaluate(deterministic=args.det_eval)
        if is_main:
            print(f"J: {m.J:f} R: {m.R:f} Episodes: {int(m.episodes)}")
        return 0

    if args.solve_R is not None:
        if args.det_eval:
            print("warning: --det-eval has no effect with --solve-R (the "
                  "solve loop evaluates stochastically inside one device "
                  "program)", file=sys.stderr)
        res = trainer.solve(target_R=args.solve_R, max_epochs=cfg.n_epochs)
        if is_main:
            print(f"solved={res['R'] >= args.solve_R} epochs={res['epochs']} "
                  f"R={res['R']:f}")
        if args.save and is_main:
            trainer.save(args.save)
        if args.export_ref and is_main:
            from ppoc_tpu.utils import ref_interop
            ref_interop.export_trainer(trainer, args.export_ref)
        return 0

    ckpt_kw = {}
    if args.save and args.checkpoint_every > 0:
        ckpt_kw = dict(checkpoint_path=args.save,
                       checkpoint_every=args.checkpoint_every,
                       epoch_offset=epoch_offset)
    if args.resume and args.n_epochs is not None:
        # config flags are otherwise ignored on --resume, but an explicit
        # --n-epochs means "train this many MORE epochs"
        ckpt_kw["n_epochs"] = args.n_epochs
    # graceful preemption: finish the epoch, checkpoint, exit restartable
    # (utils/supervisor.py relaunches on PREEMPTED_EXIT); PPOC_FAULT_EPOCH=k
    # hard-kills right after epoch k's checkpoint (elastic-recovery drills)
    import os as _os
    import signal as _signal

    preempted = {"flag": False}
    fault_epoch = int(_os.environ.get("PPOC_FAULT_EPOCH", "0"))

    def _on_sigterm(signum, frame):
        preempted["flag"] = True

    prev_handler = None
    if args.save:
        # only trap SIGTERM when there is something to checkpoint: a run
        # without --save must keep dying immediately on kill (default
        # disposition), not linger to the epoch boundary and exit 75
        try:
            prev_handler = _signal.signal(_signal.SIGTERM, _on_sigterm)
        except ValueError:  # non-main thread (embedding); skip the handler
            pass

    def on_epoch_end(i, row):
        # fault injection counts GLOBAL epochs (epoch_offset + local), so
        # the drill crash fires exactly once across supervised restarts
        if fault_epoch and epoch_offset + i + 1 == fault_epoch:
            _os._exit(98)  # simulated hard crash (no cleanup, no save)
        return preempted["flag"]

    # gym envs skip the pre-training eval: it costs a full host rollout
    # (HostTrainer.train defaults it off for the same reason)
    init_eval = not args.resume and not cfg.env.startswith("gym:")
    import contextlib

    prof_ctx = contextlib.nullcontext()
    if args.profile:
        from ppoc_tpu.utils import profiling

        prof_ctx = profiling.trace(args.profile)
    with prof_ctx:
        history = trainer.train(log=not args.jsonl and is_main,
                                stop_at_R=args.stop_at_R,
                                initial_eval=init_eval,
                                eval_deterministic=args.det_eval,
                                on_epoch_end=on_epoch_end, **ckpt_kw)
    if args.profile and is_main:
        print(f"profiler trace written to {args.profile} "
              f"(open with xprof / tensorboard)", file=sys.stderr)
    if prev_handler is not None:
        _signal.signal(_signal.SIGTERM, prev_handler)
    if preempted["flag"]:
        from ppoc_tpu.utils.supervisor import PREEMPTED_EXIT

        if args.save and is_main:
            n_done = epoch_offset + len(history)
            trainer.save(args.save, meta={"epochs_done": n_done})
            print(f"preempted: checkpointed {n_done} epoch(s) to "
                  f"{args.save}", file=sys.stderr)
        return PREEMPTED_EXIT
    if args.jsonl and is_main:
        for row in history:
            print(json.dumps(_json_safe(row)), flush=True)
    if args.save and is_main:
        # record cumulative epochs_done so a --resume of a finished run (or
        # an elastic restart after the final epoch) knows there is nothing
        # left of the original schedule
        trainer.save(args.save,
                     meta={"epochs_done": epoch_offset + len(history)})
        print(f"saved checkpoint to {args.save}", file=sys.stderr)
    if args.export_ref and is_main:
        from ppoc_tpu.utils import ref_interop
        ref_interop.export_trainer(trainer, args.export_ref)
        print(f"exported reference-format model to {args.export_ref}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
