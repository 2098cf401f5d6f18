"""CLI argument handling (ppoc_tpu/cli.py) — parsing only, no training."""
from ppoc_tpu.cli import build_parser, config_from_args


def test_defaults_are_reference_preset():
    args = build_parser().parse_args([])
    cfg = config_from_args(args)
    assert cfg.n_envs == 15 and cfg.rollout_len == 200
    assert cfg.minibatch_size == 64 and cfg.lr_policy == 3e-4


def test_throughput_preset_and_overrides():
    args = build_parser().parse_args(
        ["--preset", "throughput", "--n-envs", "512", "--lr-policy", "1e-3",
         "--hidden", "256", "256", "--env", "cartpole", "--tp-size", "2"]
    )
    cfg = config_from_args(args)
    assert cfg.n_envs == 512                  # override wins
    assert cfg.minibatch_size == 8192         # preset value kept
    assert cfg.lr_policy == 1e-3
    assert cfg.hidden == (256, 256)
    assert cfg.env == "cartpole"
    assert cfg.tp_size == 2


def test_bool_flag_parsing():
    args = build_parser().parse_args(["--reset-per-fit", "false"])
    assert config_from_args(args).reset_per_fit is False
    args = build_parser().parse_args(["--norm-adv-global", "true"])
    assert config_from_args(args).norm_adv_global is True


def test_every_config_field_has_a_flag():
    import dataclasses

    from ppoc_tpu.config import PPOConfig

    parser = build_parser()
    opts = {a.dest for a in parser._actions}
    for f in dataclasses.fields(PPOConfig):
        assert f.name in opts, f"config field {f.name} missing from CLI"


def test_cli_gym_env_routing(capsys):
    """--env gym:<id> routes to the host-bridge GymTrainer (the reference
    driver's create_gym_env path, src/main.c:25)."""
    import pytest
    gymnasium = pytest.importorskip("gymnasium")

    from ppoc_tpu import cli

    rc = cli.main([
        "--env", "gym:Pendulum-v1", "--n-envs", "2", "--rollout-len", "32",
        "--minibatch-size", "16", "--fits-per-epoch", "1", "--n-epochs", "1",
        "--eval-envs", "2", "--eval-len", "200", "--hidden", "16", "16",
        "--kernel-backend", "jnp", "--actor", "host", "--jsonl",
    ])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1  # one JSONL epoch row
    import json
    row = json.loads(out[0])
    assert "R" in row and "entropy" in row


def test_cli_gym_env_rejects_device_only_flags():
    import pytest
    pytest.importorskip("gymnasium")

    from ppoc_tpu import cli

    with pytest.raises(SystemExit):
        cli.main(["--env", "gym:Pendulum-v1", "--solve-R", "-200"])


def test_cli_obs_norm_routing(capsys, tmp_path):
    """--obs-norm trains through RunningObsNorm and writes the sidecar on
    --save; it is rejected for on-device envs."""
    import pytest
    pytest.importorskip("gymnasium")

    from ppoc_tpu import cli

    ckpt = str(tmp_path / "m.bin")
    rc = cli.main([
        "--env", "gym:Pendulum-v1", "--n-envs", "2", "--rollout-len", "32",
        "--minibatch-size", "16", "--fits-per-epoch", "1", "--n-epochs", "1",
        "--eval-envs", "2", "--eval-len", "200", "--hidden", "16", "16",
        "--actor", "host", "--jsonl", "--obs-norm", "--save", ckpt,
    ])
    assert rc == 0
    import os
    assert os.path.exists(ckpt + ".obsnorm.npz")

    with pytest.raises(SystemExit):
        cli.main(["--env", "pendulum", "--obs-norm"])


def test_det_eval_flag(capsys):
    """--det-eval routes the mean-policy evaluator through train and
    eval-only (Trainer.train(eval_deterministic=), HostTrainer ditto)."""
    from ppoc_tpu import cli

    base = ["--env", "simple", "--hidden", "8", "8", "--n-envs", "16",
            "--rollout-len", "15", "--minibatch-size", "32",
            "--fits-per-epoch", "2", "--eval-envs", "16", "--eval-len", "15",
            "--kernel-backend", "jnp", "--det-eval"]
    assert cli.main(base + ["--n-epochs", "1"]) == 0
    out = capsys.readouterr().out
    assert "Epoch: 0" in out and "R:" in out
    assert cli.main(base + ["--eval-only"]) == 0
    assert "R:" in capsys.readouterr().out


def test_cli_sweep(capsys):
    """--sweep S trains S seeds as one vmapped program (ppoc_tpu.sweep)."""
    import pytest

    from ppoc_tpu import cli

    rc = cli.main(["--env", "simple", "--n-envs", "16", "--rollout-len", "15",
                   "--minibatch-size", "48", "--fits-per-epoch", "2",
                   "--eval-envs", "32", "--eval-len", "15", "--hidden", "16",
                   "--kernel-backend", "jnp", "--sweep", "2",
                   "--n-epochs", "2"])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("final R over 2 seeds")
    # incompatible with host-bridge / mesh / load modes
    with pytest.raises(SystemExit):
        cli.main(["--env", "simple", "--sweep", "2", "--mesh", "4"])


def test_score_episodes(capsys):
    """--eval-only --score-episodes aggregates eval rounds to an episode
    quota (trainer.score, the canonical RESULTS scoring protocol)."""
    from ppoc_tpu import cli
    from ppoc_tpu.algo.trainer import Trainer, score
    from ppoc_tpu.config import PPOConfig

    rc = cli.main(["--env", "simple", "--n-envs", "8", "--rollout-len", "15",
                   "--minibatch-size", "24", "--fits-per-epoch", "1",
                   "--eval-envs", "8", "--eval-len", "15", "--hidden", "8",
                   "--kernel-backend", "jnp", "--eval-only",
                   "--score-episodes", "20"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "eval rounds" in out

    # API form: episode quota met, weighted aggregation finite
    tr = Trainer(PPOConfig(env="simple", n_envs=8, rollout_len=15,
                           minibatch_size=24, fits_per_epoch=1, eval_envs=8,
                           eval_len=15, hidden=(8,), kernel_backend="jnp"))
    s = score(tr, episodes=20)
    assert s["episodes"] >= 20 and s["rounds"] >= 2
    import math
    assert math.isfinite(s["R"]) and math.isfinite(s["J"])


def test_tuned_preset_wiring():
    """--preset tuned resolves to config.tuned_preset (the grid-sweep
    winner) and stays in sync with bench.tuned_config."""
    import sys

    sys.path.insert(0, ".")
    from bench import tuned_config
    from ppoc_tpu import cli
    from ppoc_tpu.config import tuned_preset

    args = cli.build_parser().parse_args(["--preset", "tuned"])
    cfg = cli.config_from_args(args)
    assert cfg == tuned_preset()
    assert tuned_config(0) == tuned_preset("pendulum", 0)
    assert cfg.lr_policy == 1e-3 and cfg.clip_eps == 0.3
    assert (cfg.n_epochs_value, cfg.n_epochs_policy) == (5, 2)
