"""The GPU entry points on a machine without a GPU, and the compile cache.

``chip_smoke.py`` and ``bench.py`` must refuse to run (non-zero exit, no
result line) when JAX finds no GPU: nothing may fall back to the CPU. The
persistent compile cache must honour ``JAX_COMPILATION_CACHE_DIR`` and
otherwise live at ``<checkout>/.jax_cache``. Each check runs in a child
process so the test worker's own JAX configuration is left untouched.
"""

import os
import shutil
import subprocess
import sys

from goma_tpu.utils.compile_cache import default_cache_dir
from goma_tpu.utils.device import card_line

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, env_extra=None, drop=(), cwd=ROOT, timeout=300):
    env = dict(os.environ)
    for k in drop:
        env.pop(k, None)
    env.update(env_extra or {})
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


_CACHE_PROBE = (
    "import jax; from goma_tpu.utils.compile_cache import "
    "enable_compile_cache; d = enable_compile_cache(); "
    "print(d); print(jax.config.jax_compilation_cache_dir)")


def test_compile_cache_honours_env_var(tmp_path):
    d = str(tmp_path / "cc")
    cp = _run(["-c", _CACHE_PROBE],
              env_extra={"JAX_COMPILATION_CACHE_DIR": d})
    assert cp.returncode == 0, cp.stderr
    used, configured = cp.stdout.split()
    assert used == d and configured == d
    assert os.path.isdir(d)


def test_compile_cache_default_is_checkout_jax_cache():
    assert default_cache_dir() == os.path.join(ROOT, ".jax_cache")
    cp = _run(["-c", _CACHE_PROBE], drop=("JAX_COMPILATION_CACHE_DIR",))
    assert cp.returncode == 0, cp.stderr
    used, configured = cp.stdout.split()
    assert used == configured == os.path.join(ROOT, ".jax_cache")


def test_chip_smoke_fails_without_gpu():
    cp = _run(["chip_smoke.py"])
    assert cp.returncode != 0
    assert '"ok"' not in cp.stdout
    assert "no GPU" in cp.stderr


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    cp = _run(["chip_smoke.py"], cwd=str(tmp_path))
    assert cp.returncode != 0
    assert '"ok"' not in cp.stdout


def test_bench_fails_without_gpu():
    cp = _run(["bench.py"], env_extra={"GOMA_BENCH_BUDGET_S": "60"})
    assert cp.returncode != 0
    assert cp.stdout.strip() == ""
    assert "no GPU" in cp.stderr


def test_card_line_without_nvidia_smi(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    assert card_line().startswith("nvidia-smi unavailable")
