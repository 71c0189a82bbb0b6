"""Worlds of ``torch.distributed`` processes for the multi-process tools
(:mod:`.scaling_report`, :mod:`.dryrun_multichip`): N copies of a command,
each with the torchrun environment set by hand (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) and meeting through a file
(``DUODIFF_INIT_METHOD=file://...``), so no port is taken. A world that
outlives its time limit is killed and fails the tool."""

from __future__ import annotations

import os
import subprocess
import sys
import time
import uuid
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def run_world(n: int, argv: list, work, timeout: float, nodes: int = 1,
              env: dict | None = None) -> list:
    """``python *argv`` as the ``n`` ranks of one world of ``nodes`` nodes
    (``n / nodes`` local ranks each); returns each rank's output. Raises
    SystemExit naming the first rank that failed, with its output's end."""
    if n % nodes:
        raise SystemExit(f"{n} ranks do not split over {nodes} nodes")
    local = n // nodes
    init = Path(work) / f"init_{uuid.uuid4().hex}"
    base = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT")}
    procs = []
    for rank in range(n):
        rank_env = dict(base, RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank % local),
                        LOCAL_WORLD_SIZE=str(local), DUODIFF_INIT_METHOD=f"file://{init}",
                        OMP_NUM_THREADS="1", PYTHONPATH=str(REPO), **(env or {}))
        log = Path(work) / f"rank{rank}_{init.name}.log"
        with open(log, "w") as f:
            procs.append((subprocess.Popen([sys.executable, *argv], env=rank_env, cwd=REPO,
                                           stdout=f, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + timeout
    try:
        for proc, _ in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for proc, _ in procs:
            proc.kill()
            proc.wait()
        raise SystemExit(f"a world of {n} ranks ({argv}) did not end within {timeout} s")
    outs = [log.read_text() for _, log in procs]
    for rank, ((proc, _), out) in enumerate(zip(procs, outs)):
        if proc.returncode != 0:
            raise SystemExit(f"rank {rank} of a world of {n} ({argv}) exited with "
                             f"{proc.returncode}:\n{out[-4000:]}")
    return outs
