"""The port's tests' own settings in tests/torch_session.py: the time
limit on each test, and the one torch thread in every test worker and in
the processes it starts."""

import contextlib
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

import torch_session
from torch_session import torch_test_limit  # noqa: F401


@contextlib.contextmanager
def _own_limit_aside():
    """Disarm the limit on this test while the helper is tried alone, and
    arm it again with what was left."""
    left, _ = signal.setitimer(signal.ITIMER_REAL, 0)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, left)


@pytest.mark.parametrize("phase", ["setup", "call", "teardown"])
def test_a_body_past_its_limit_fails_and_names_the_phase(phase):
    here = os.environ["PYTEST_CURRENT_TEST"]
    os.environ["PYTEST_CURRENT_TEST"] = f"tests/x.py::t ({phase})"
    try:
        with _own_limit_aside():
            start = time.monotonic()
            with pytest.raises(pytest.fail.Exception,
                               match=rf"^tests/x\.py::t \({phase}\) ran "
                                     r"past its limit of 1 s$"):
                with torch_session.time_limit(1):
                    time.sleep(30)
            assert time.monotonic() - start < 3
            assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)
    finally:
        os.environ["PYTEST_CURRENT_TEST"] = here


def test_a_body_inside_its_limit_is_untouched():
    with _own_limit_aside():
        handler = signal.getsignal(signal.SIGALRM)
        with torch_session.time_limit(5):
            left, _ = signal.getitimer(signal.ITIMER_REAL)
            assert 4 < left <= 5
            total = sum(range(1000))
        assert total == 499500
        assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)
        assert signal.getsignal(signal.SIGALRM) is handler


def _limit_left() -> float:
    left, _ = signal.getitimer(signal.ITIMER_REAL)
    assert 0 < left <= torch_session.TEST_LIMIT_S
    return left


@pytest.fixture
def left_at_setup():
    return _limit_left()


@pytest.fixture
def limit_at_teardown():
    yield
    _limit_left()


def test_setup_runs_under_the_limit(left_at_setup):
    assert left_at_setup > torch_session.TEST_LIMIT_S - 60


def test_call_runs_under_the_limit():
    assert _limit_left() > torch_session.TEST_LIMIT_S - 60


def test_teardown_runs_under_the_limit(limit_at_teardown):
    """limit_at_teardown fails this test's teardown if no limit is armed
    there."""


def test_torch_runs_one_thread():
    assert torch.get_num_threads() == 1


def test_one_thread_reaches_a_child_process():
    out = subprocess.run(
        [sys.executable, "-c",
         "import os, torch; print(os.environ['OMP_NUM_THREADS'], "
         "os.environ['MKL_NUM_THREADS'], torch.get_num_threads())"],
        capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.split() == ["1", "1", "1"]
