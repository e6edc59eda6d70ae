"""The port's tests' settings: one torch thread, and a time limit on each
test. Every ``tests/test_torch_*.py`` takes both with one line::

    from torch_session import torch_test_limit  # noqa: F401

gstpu's own tests do not import this module, so they keep their settings.
"""

import contextlib
import faulthandler
import os
import signal
import sys

# One torch thread in the test worker and in every process a test starts
# (the launch tool, the docs cache, the import checks, the gloo ranks):
# these tensors are small, and a pool of threads stalls for long when the
# test workers share the cores (a flagship block took 50x longer with 8
# threads than with 1 beside a busy CPU).
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"

import pytest  # noqa: E402
import torch  # noqa: E402

# a test file may import torch before this module, and then the variables
# above came too late for this process's pool
torch.set_num_threads(1)

# A torch test fails past this many seconds, so that a hang names itself
# long before the suite's clock. The slowest setup or call took 37 s with
# 6 workers on 8 cores, and 80 s (the 8-rank world's setup) beside a
# second copy of the suite on those cores.
TEST_LIMIT_S = 300


@contextlib.contextmanager
def time_limit(seconds: float):
    """Fail with pytest.fail, after writing every thread's stack to
    stderr, if the body runs past `seconds`. The message names the test
    and the phase it was in (setup, call or teardown), as pytest keeps
    them in PYTEST_CURRENT_TEST. SIGALRM is handled on the main thread
    only, and xdist runs tests there."""
    def expire(signum, frame):
        faulthandler.dump_traceback(sys.__stderr__, all_threads=True)
        where = os.environ.get("PYTEST_CURRENT_TEST", "the test")
        pytest.fail(f"{where} ran past its limit of {seconds} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.fixture(autouse=True)
def torch_test_limit():
    """Run the test under TEST_LIMIT_S, from its function fixtures'
    setup to their teardown. Module-scoped fixtures are set up before
    this one, and bound their own waits (the streams world's deadline)."""
    with time_limit(TEST_LIMIT_S):
        yield
