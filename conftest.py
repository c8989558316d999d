"""Limits of the test suite: threads, time, and the tests marked slow here.

pytest loads this file before tests/conftest.py, so the thread limit is in
the environment before JAX or torch is imported.

- Threads: each of n xdist workers gets cpu_count // n torch threads, set
  before torch is imported here or in a test's subprocess. torch's OpenMP
  pool is sized to the whole machine, and its spinning threads stall every
  worker once the workers outnumber the cores. XLA's CPU pool keeps one
  thread per virtual device; XLA_FLAGS has no switch that shrinks it. A run
  without xdist keeps the whole machine.
- Time: the setup, the call and the teardown of a test not marked slow each
  fail after TIME_LIMIT seconds. A test stuck in native code, where the
  alarm cannot interrupt it, ends its process TIME_LIMIT + 60 s in, with
  every thread's stack on stderr. Slow tests have no limit.
- SLOW: tests that take over 60 s alone on one core (one thread, as an xdist
  worker of six runs them), marked slow here so that tier-1
  (`-m 'not slow'`) leaves them out.
"""

import faulthandler
import os
import signal

import pytest

_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _workers:
    os.environ["OMP_NUM_THREADS"] = str(max(1, os.cpu_count() // _workers))

TIME_LIMIT = 180

SLOW = {
    "tests/test_bvh.py::test_bvh_streaming_count_iters",
    "tests/test_denoise.py::test_denoise_reduces_mse_preserves_edges",
    "tests/test_denoise.py::test_denoiser_upscale_2x_guided_layers",
    "tests/test_denoise.py::test_denoiser_class_modes_and_tiling",
    "tests/test_denoise.py::test_denoiser_class_apply_to_aov",
    "tests/test_denoise.py::test_pallas_atrous_matches_jnp",
    "tests/test_mesh_env.py::test_mesh_env_render_and_denoise",
    "tests/test_sharding.py::test_balanced_render_matches_unbalanced",
}

_stderr_fd = None


def pytest_configure(config):
    global _stderr_fd
    # Capture is suspended here, so fd 2 is the terminal or the log.
    _stderr_fd = os.dup(2)


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)


def _on_alarm(signum, frame):
    pytest.fail(f"test exceeded the {TIME_LIMIT} s time limit")


def _limited(item):
    if item.get_closest_marker("slow"):
        return (yield)
    previous = signal.signal(signal.SIGALRM, _on_alarm)
    signal.setitimer(signal.ITIMER_REAL, TIME_LIMIT)
    faulthandler.dump_traceback_later(
        TIME_LIMIT + 60, exit=True, file=_stderr_fd
    )
    try:
        return (yield)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
        faulthandler.cancel_dump_traceback_later()


pytest_runtest_setup = pytest_runtest_call = pytest_runtest_teardown = (
    pytest.hookimpl(wrapper=True)(_limited)
)
