"""Shared test harness helpers.

``run_under_devices`` is the multi-device pattern: device count must be set
via XLA_FLAGS *before* jax initializes, and the main pytest process must
keep its single device — so multi-device tests run their payload in a
subprocess. Used by tests/test_dist.py and tests/test_engine_shard.py.
"""
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_under_devices(code: str, n: int = 8) -> str:
    env = {**os.environ,
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={n}",
           "PYTHONPATH": os.path.join(ROOT, "src")}
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=600)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    return r.stdout


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card and nvcc (the hand-written "
        "kernels); skips with a reason on a host without them")
