"""Start local ranks, run one job in each, collect the results.

``run(job, n, backend=..., args=...)`` spawns n processes (start method
``spawn``, which CUDA needs).  Each sets ZKF_COORDINATOR (a ``file://``
store in a fresh temporary directory), ZKF_NUM_PROCESSES,
ZKF_PROCESS_ID and LOCAL_RANK, runs one intra-op CPU thread (ranks
share the host's cores), joins the process
group through ``runtime.init_distributed`` and returns ``job(*args)``.
`job` must be a module-level function of an importable module (the
children import it), and its arguments and result must pickle.

The parent waits at most `timeout_s` for all results.  A rank that raises
sends its traceback; a rank that dies or a run past the limit ends every
rank, and ``run`` raises with what each rank reported.  Nothing is retried
and no failure is ignored.
"""
from __future__ import annotations

import os
import queue
import shutil
import tempfile
import time
import traceback

import torch.multiprocessing as tmp

from . import runtime


class RankFailure(RuntimeError):
    pass


def _rank_main(job, args, rank: int, n: int, url: str, backend: str,
               results) -> None:
    os.environ.update(ZKF_COORDINATOR=url, ZKF_NUM_PROCESSES=str(n),
                      ZKF_PROCESS_ID=str(rank), LOCAL_RANK=str(rank))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        runtime.init_distributed(backend=backend)
        out = job(*args)
        dist.barrier()
        dist.destroy_process_group()
    except Exception:           # the rank's boundary: report, then fail
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, True, out))


def run(job, n: int, *, backend: str, args: tuple = (),
        timeout_s: float = 600.0) -> list:
    """-> [job's result on rank 0, ..., on rank n-1]; raises RankFailure
    if a rank raises, dies or does not finish within timeout_s."""
    ctx = tmp.get_context("spawn")
    results = ctx.Queue()
    store = tempfile.mkdtemp(prefix="zkf_rendezvous_")
    url = "file://" + os.path.join(store, "store")
    procs = [ctx.Process(target=_rank_main, args=(
        job, args, r, n, url, backend, results))
        for r in range(n)]
    got: dict = {}
    failed: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(got) < n and not failed:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RankFailure(
                    f"{n} ranks: no result from ranks "
                    f"{sorted(set(range(n)) - set(got))} after {timeout_s} s")
            try:
                rank, ok, val = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = {r: p.exitcode for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)}
                if dead:
                    time.sleep(0.5)         # a traceback may be in flight
                    while not results.empty():
                        rank, ok, val = results.get()
                        (got if ok else failed)[rank] = val
                    if not failed:
                        raise RankFailure(f"ranks exited without a result: "
                                          f"exit codes {dead}")
                continue
            (got if ok else failed)[rank] = val
        if failed:
            raise RankFailure("\n".join(
                f"rank {r} failed:\n{tb}" for r, tb in sorted(failed.items())))
        for r, p in enumerate(procs):
            p.join(timeout=max(deadline - time.monotonic(), 10.0))
            if p.exitcode != 0:
                raise RankFailure(f"rank {r} did not exit cleanly "
                                  f"(exit code {p.exitcode})")
        return [got[r] for r in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(store, ignore_errors=True)
