"""Where the program runs: the compile-cache path rule, the device record
every measurement prints, the peak table, the kernel-backend values, and
chip_smoke.py's refusal to report a result without a GPU."""
import os
import shutil
import subprocess
import sys

import jax
import pytest

from ppoc_tpu.utils import cache, device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def config_calls(monkeypatch):
    """Record jax.config.update calls made by enable_compilation_cache
    as if this were a GPU process (the CPU suite must not change its own
    cache settings)."""
    calls = {}
    monkeypatch.setattr(cache, "_cpu_only", lambda: False)
    monkeypatch.setattr(jax.config, "update",
                        lambda name, val: calls.__setitem__(name, val))
    return calls


def test_cache_uses_env_var_as_is(monkeypatch, config_calls, tmp_path):
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)
    assert cache.enable_compilation_cache() == str(tmp_path)
    # JAX reads the variable itself: nothing names a directory in code
    assert "jax_compilation_cache_dir" not in config_calls
    assert config_calls["jax_persistent_cache_min_entry_size_bytes"] == 0


def test_cache_defaults_to_checkout(monkeypatch, config_calls):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert cache.DEFAULT_DIR == want
    assert cache.cache_dir() == want
    assert cache.enable_compilation_cache() == want
    assert config_calls["jax_compilation_cache_dir"] == want


def test_cache_default_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cache_off_for_cpu_processes(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert cache._cpu_only()          # the suite runs on the CPU
    assert cache.enable_compilation_cache() is None
    assert calls == []


def test_device_record_names_the_device():
    rec = device.record()
    assert rec["platform"] == "cpu"
    assert rec["device_kind"] == jax.devices()[0].device_kind
    assert rec["device_count"] == len(jax.devices())
    assert "card" in rec


def test_measurements_refuse_the_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        device.require_gpu()


def test_peak_table_keyed_by_device_kind():
    sys.path.insert(0, REPO)
    import bench_phases

    assert bench_phases.peak_bf16("NVIDIA H100 80GB HBM3") == 989e12
    with pytest.raises(KeyError, match="no published peaks"):
        bench_phases.peak_bf16("cpu")


@pytest.mark.parametrize("backend", ["pallas", "auto", "tpu", ""])
def test_unknown_kernel_backend_raises(backend):
    from ppoc_tpu.config import KERNEL_BACKENDS, PPOConfig, validate

    with pytest.raises(ValueError, match="kernel_backend must be one of"):
        validate(PPOConfig(kernel_backend=backend))
    for ok in KERNEL_BACKENDS:
        validate(PPOConfig(kernel_backend=ok))


def test_checkpoint_with_removed_backend_loads_as_default():
    """Files written while other backend values existed (the committed
    recall curriculum checkpoints say "auto") load with the default."""
    from ppoc_tpu.utils import checkpoint

    ck = checkpoint.load(os.path.join(REPO, "recall_curriculum_512_s0.bin"))
    assert ck.cfg.kernel_backend == "jnp"


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory with nothing else of the repo, the script
    cannot import the program and reports no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
