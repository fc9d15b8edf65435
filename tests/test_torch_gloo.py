"""Groups of gloo processes on the CPU for the port's parallel tests
(tests/test_torch_parallel_*.py), and the tests of the helper itself.

A test file starts its ranks with ``spawn_group``: each runs the file as a
script, ``python <file> <rank> <world> <tmp> [args]``, whose ``__main__``
hands its work to ``run_rank``, which joins the group with ``init_rank``.
No group can hang the suite:

  * the ranks talk over loopback (``GLOO_SOCKET_IFNAME=lo``,
    ``MASTER_ADDR=127.0.0.1``), not over whatever interface the host name
    resolves to, and every collective times out after ``COLLECTIVE_TIMEOUT``;
  * a rank that raises prints its traceback and exits with 1;
  * the parent waits at most ``GROUP_TIMEOUT`` seconds for the whole group,
    fails as soon as one rank exits non-zero, kills every rank on the way
    out, and puts the failing ranks' output in its assertion message.
"""
import os
import subprocess
import sys
import time
import traceback
from datetime import timedelta
from pathlib import Path

import pytest

GROUP_TIMEOUT = 300  # seconds for a whole group, the parent's own work included
COLLECTIVE_TIMEOUT = timedelta(seconds=120)
LOOPBACK = {"GLOO_SOCKET_IFNAME": "lo", "MASTER_ADDR": "127.0.0.1"}


def init_rank(rank, world, tmp):
    """Join the gloo group of ``world`` ranks over a file store under ``tmp``."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world, timeout=COLLECTIVE_TIMEOUT)


def run_rank(work, argv):
    """A rank's ``__main__``: ``work(rank, world, tmp, *rest)`` from
    ``argv`` (``sys.argv[1:]``); on any exception print its traceback and
    exit with 1 at once, whatever the other ranks wait for."""
    try:
        rank, world, tmp, *rest = argv
        work(int(rank), int(world), tmp, *rest)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def _tail(path, n=4000):
    text = Path(path).read_text(errors="replace")
    return text[-n:]


def spawn_group(script, world, tmp, *args, work=None, timeout=GROUP_TIMEOUT):
    """Run ``world`` ranks of ``script`` while ``work()`` (if any) runs
    here; return ``work``'s result once every rank has exited with 0.
    Raise AssertionError, with the failing (or, on a timeout, every)
    rank's output, when a rank exits non-zero or ``timeout`` seconds pass."""
    tmp = Path(tmp)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path), **LOOPBACK)
    logs = [tmp / f"rank{rank}.log" for rank in range(world)]
    procs = []
    deadline = time.monotonic() + timeout
    try:
        for rank, log in enumerate(logs):
            with open(log, "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, str(script), str(rank), str(world), str(tmp), *map(str, args)],
                    env=env, stdout=out, stderr=subprocess.STDOUT))
        mine = work() if work is not None else None
        while True:
            codes = [p.poll() for p in procs]
            if codes == [0] * world:
                return mine
            if any(c not in (None, 0) for c in codes) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        failed = [r for r, c in enumerate(codes) if c not in (None, 0)] or list(range(world))
        why = "exit codes" if any(c not in (None, 0) for c in codes) else "timed out, codes"
        raise AssertionError(
            f"gloo group of {world} ({Path(script).name}): {why} {codes}\n"
            + "\n".join(f"--- rank {r} ---\n{_tail(logs[r])}" for r in failed))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _helper_rank(rank, world, tmp, mode):
    """The helper's own tests: rank 1 raises while rank 0 waits in a
    collective (``fail``), or both all-reduce their rank + 1 (``sum``)."""
    import torch
    import torch.distributed as dist

    init_rank(rank, world, tmp)
    if mode == "fail" and rank == 1:
        raise RuntimeError("rank 1 gives up before the all-reduce")
    x = torch.tensor([rank + 1.0])
    dist.all_reduce(x)
    if rank == 0:
        Path(tmp, "sum.txt").write_text(str(x.item()))
    dist.destroy_process_group()


def test_a_failing_rank_fails_the_group_with_its_message(tmp_path):
    start = time.monotonic()
    with pytest.raises(AssertionError, match="rank 1 gives up before the all-reduce"):
        spawn_group(__file__, 2, tmp_path, "fail")
    # rank 0 would wait COLLECTIVE_TIMEOUT in its all-reduce: the group fails first
    assert time.monotonic() - start < COLLECTIVE_TIMEOUT.total_seconds()


def test_a_two_rank_all_reduce_passes(tmp_path):
    spawn_group(__file__, 2, tmp_path, "sum")
    assert float((tmp_path / "sum.txt").read_text()) == 3.0


if __name__ == "__main__":
    run_rank(_helper_rank, sys.argv[1:])
