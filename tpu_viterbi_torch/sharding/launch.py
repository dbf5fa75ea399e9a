"""Start the ranks of the split as processes on this host, as ``torchrun``
would (the counterpart of ``launch`` in ``scripts/ber_sharded_mp.py`` and
``reexec_virtual`` in ``scripts/pod_runbook.py``).

``spawn_ranks`` picks a free port, gives each process torchrun's variables
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), so that
``mesh.initialize_distributed`` with no arguments joins the group, and
starts each with ``subprocess`` (a fresh interpreter: never a fork of a
process that may hold a CUDA context).  It waits on all of them under one
time limit and kills the others as soon as one fails.  The backend is the
ranks' own choice (``mesh.backend_for``): gloo on the CPU or when the ranks
outnumber the cards, nccl when each rank has a card.
"""

from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Sequence

from ..hardware import resolve_device

# the directory that holds the package: the ranks run from there, so that
# ``python -m tpu_viterbi_torch...`` finds it
ROOT = Path(__file__).resolve().parents[2]
POLL_S = 0.05


def free_port() -> int:
    """A TCP port on localhost that no socket holds now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank: int, n: int, port: int) -> dict:
    """torchrun's variables for rank ``rank`` of ``n`` on this host."""
    return {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
            "WORLD_SIZE": str(n), "RANK": str(rank),
            "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(n)}


@dataclass
class RankResult:
    """One rank process' exit code (negative: killed by that signal, as the
    others are when one fails or the time runs out) and its standard output
    and error."""

    rank: int
    rc: int
    out: str
    err: str


def spawn_ranks(argv_for_rank: Callable[[int], Sequence[str]], n: int,
                device="cuda", timeout: float = 600) -> List[RankResult]:
    """Run ``argv_for_rank(r)`` for r in 0 .. n - 1 as n processes with
    torchrun's variables, and wait for all of them, at most ``timeout``
    seconds in all.  When one exits with another code than 0, or the time
    runs out, the others are killed.  ``device`` is where the ranks will
    decode: it is resolved first, so 'cuda' without a card raises before
    any process starts.  Returns each rank's result in rank order;
    ``failed`` names the ranks that did not exit 0."""
    resolve_device(device)
    if n < 1:
        raise ValueError(f"spawn_ranks needs at least one rank, got {n}")
    port = free_port()
    procs = []
    files = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
             for _ in range(n)]
    try:
        for r, (out, err) in enumerate(files):
            procs.append(subprocess.Popen(
                list(argv_for_rank(r)), cwd=ROOT, stdout=out, stderr=err,
                stdin=subprocess.DEVNULL, text=True,
                env={**os.environ, **rank_env(r, n, port)}))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(POLL_S)
        results = []
        for r, (p, (out, err)) in enumerate(zip(procs, files)):
            p.poll()
            if p.returncode is None:
                p.kill()
                p.wait()
            out.seek(0)
            err.seek(0)
            results.append(RankResult(r, p.returncode, out.read(),
                                      err.read()))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in files:
            out.close()
            err.close()


def failed(results: List[RankResult]) -> List[int]:
    """The ranks whose process did not exit 0."""
    return [r.rank for r in results if r.rc != 0]


def report(results: List[RankResult], echo: Callable[[str], None] = print
           ) -> int:
    """Echo rank 0's standard output, and each failed rank's output and
    error; -> 0 when every rank exited 0, else 1."""
    bad = failed(results)
    if results:
        echo(results[0].out.rstrip("\n"))
    for r in results:
        if r.rank in bad:
            echo(f"rank {r.rank} failed (rc {r.rc}):\n{r.out[-3000:]}"
                 f"{r.err[-3000:]}")
    return 1 if bad else 0
