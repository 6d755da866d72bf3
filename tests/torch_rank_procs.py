"""The rank processes of the port's multi-process CPU tests
(tests/test_torch_parallel*.py): their outputs collected under one time
limit, and every rank killed and reaped where the limit passes or the test
process meets an error first, so that no rank outlives its fixture."""
from __future__ import annotations

import subprocess
import time


def kill_ranks(procs: dict) -> None:
    """Kill every rank of ``procs`` (world -> (dir, [Popen])) still running,
    then reap them all."""
    every = [p for _, ps in procs.values() for p in ps]
    for p in every:
        if p.poll() is None:
            p.kill()
    for p in every:
        p.communicate()


def rank_logs(procs: dict, timeout: float) -> dict:
    """world -> each rank's output, waiting at most ``timeout`` seconds for
    all of them together; on a timeout (subprocess.TimeoutExpired) or any
    other error every rank is killed and reaped before it propagates."""
    deadline = time.monotonic() + timeout
    try:
        return {world: [p.communicate(timeout=max(deadline - time.monotonic(), 0.1))[0]
                        for p in ps] for world, (_, ps) in procs.items()}
    except BaseException:
        kill_ranks(procs)
        raise
