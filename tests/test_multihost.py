"""Multi-host runtime smoke test: 2 OS processes, TCP coordinator,
one sharded Chebyshev step across the process boundary.

The reference is strictly single-process (SURVEY §2.8: no MPI/
Distributed anywhere; `Project.toml` has no comm deps).  This framework
replaces that with ``jax.distributed`` + GSPMD — this test proves the
:func:`~quantumpropagators.parallel.distributed.initialize_multihost`
path end-to-end on CPU (gloo collectives), no cluster required:
2 processes × 2 virtual devices = a 4-device global mesh, state
row-sharded across it, ppermute/psum crossing the process boundary.
"""

import os
import signal
import socket
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

import pytest

_WORKER = Path(__file__).with_name("multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextmanager
def _deadline(seconds: int):
    """Hard SIGALRM guard: ``pytest-timeout`` is not installed in this
    image, so a plain ``pytest.mark.timeout`` would be inert — this
    raises in the test process itself no matter where it is stuck."""

    def _raise(signum, frame):
        raise TimeoutError(f"test exceeded {seconds}s deadline")

    old = signal.signal(signal.SIGALRM, _raise)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def test_two_process_sharded_cheby_step():
    port = _free_port()
    # the workers must form their own fresh 2-process CPU world
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH")
    }
    repo = str(_WORKER.parent.parent)
    env["PYTHONPATH"] = repo
    procs = []
    try:
        with _deadline(290):
            procs = [
                subprocess.Popen(
                    [sys.executable, str(_WORKER), str(port), str(pid)],
                    env=env,
                    cwd=repo,
                    stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE,
                    text=True,
                )
                for pid in (0, 1)
            ]
            outs = []
            for p in procs:
                out, err = p.communicate(timeout=240)
                outs.append((p.returncode, out, err))
    except (subprocess.TimeoutExpired, TimeoutError) as exc:
        for p in procs:
            p.kill()
        pytest.fail(f"multihost workers timed out ({exc})")
    for rc, out, err in outs:
        assert rc == 0, f"worker failed (rc={rc}):\n{out}\n{err[-3000:]}"
        assert "OK process=" in out, out
