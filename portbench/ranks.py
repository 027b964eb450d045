"""A cell over several cards: one process a card, in one
``torch.distributed`` group on 127.0.0.1.

The process the benchmark is started as is rank 0.  It starts the other
ranks (:func:`lead`) as processes of the same command with ``--rank r
--port p``, watches them, and ends every one of them, and itself without a
result, as soon as one fails: a run never waits on a rank that has gone.
A rank whose leader has gone ends itself (:func:`follow`).  Rank ``r``
runs on ``cuda:r`` in an NCCL group (gloo on the CPU, for the tests), and
the harness's own exchanges (barriers, the stop decision, the gathered
readings) go over a gloo group of host tensors, so that none of them waits
on a card.  Every collective gives up after :data:`TIMEOUT_S`."""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import subprocess
import sys
import threading
import time
import traceback

import torch
import torch.distributed as dist

# the longest any rank waits for the others in one collective: the ranks
# build their kernels on a checkout's first run side by side, so this is
# far above their skew
TIMEOUT_S = 300
# how long the leader waits for the other ranks to end once its own run
# has ended
JOIN_S = 120
# the exit code of a run ended because a rank failed or its leader went
RANK_FAILED = 6


@dataclasses.dataclass
class Group:
    """This process's rank in a group of ``world`` ranks, and the host
    group the harness's own exchanges use."""
    rank: int
    world: int
    host: object

    def barrier(self) -> None:
        dist.barrier(group=self.host)

    def decide(self, flag: bool) -> bool:
        """Rank 0's ``flag``, on every rank."""
        t = torch.tensor([int(flag)])
        dist.broadcast(t, src=0, group=self.host)
        return bool(t.item())

    def gather(self, obj) -> list:
        """Every rank's ``obj``, in rank order, on every rank."""
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.host)
        return out


def join(rank: int, world: int, port: int, device) -> Group:
    """Join the group of ``world`` ranks whose store rank 0 serves on
    ``port``: NCCL on a card, gloo on the CPU; this process keeps a
    ``world``-th of its threads."""
    # each rank takes its share of the host's threads, as a card of its
    # own with its own host would give it: four ranks of the host's whole
    # pool each oversubscribe its cores fourfold
    torch.set_num_threads(max(1, torch.get_num_threads() // world))
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    cuda = torch.device(device).type == "cuda"
    dist.init_process_group(
        "nccl" if cuda else "gloo", init_method=f"tcp://127.0.0.1:{port}",
        world_size=world, rank=rank, timeout=timeout,
        **(dict(device_id=torch.device(device)) if cuda else {}))
    host = (dist.new_group(backend="gloo", timeout=timeout) if cuda
            else dist.group.WORLD)
    return Group(rank, world, host)


def leave() -> None:
    dist.destroy_process_group()


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _end(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def lead(cmds: list, run0, emit) -> int:
    """Start a process of each of ``cmds`` (ranks 1, 2, ...; their standard
    output goes to standard error), run ``run0() -> (code, result)`` here
    as rank 0, wait for the others, and ``emit(result)`` only where every
    rank ended with 0.  A rank that ends with another code, or rank 0
    raising, ends every rank at once; returns the exit code."""
    procs = [subprocess.Popen(cmd, stdin=subprocess.DEVNULL,
                              stdout=sys.stderr) for cmd in cmds]
    stop, lock = threading.Event(), threading.Lock()

    def watch():
        while not stop.wait(0.2):
            failed = [(r, p.returncode) for r, p in enumerate(procs, 1)
                      if p.poll() not in (None, 0)]
            if failed:
                with lock:
                    if stop.is_set():
                        return
                    print(f"portbench: rank {failed[0][0]} ended with "
                          f"{failed[0][1]}; ending every rank", file=sys.stderr,
                          flush=True)
                    _end(procs)
                    sys.stdout.flush()
                    os._exit(RANK_FAILED)

    threading.Thread(target=watch, daemon=True).start()
    code, result = 1, None
    try:
        code, result = run0()
    except BaseException:
        traceback.print_exc()
    finally:
        with lock:
            stop.set()
        if code == 0:
            deadline = time.monotonic() + JOIN_S
            for r, p in enumerate(procs, 1):
                try:
                    rc = p.wait(max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    rc = None
                if rc != 0:
                    print(f"portbench: rank {r} ended with {rc}",
                          file=sys.stderr)
                    code = RANK_FAILED
                    break
        _end(procs)
    if code == 0:
        emit(result)
    return code


def follow() -> None:
    """End this process once its leader has gone (the leader, not the
    group, started it)."""
    parent = os.getppid()

    def watch():
        while True:
            time.sleep(1.0)
            if os.getppid() != parent:
                os._exit(RANK_FAILED)
    threading.Thread(target=watch, daemon=True).start()


def exit_now(code: int) -> None:
    """End this process with ``code`` without waiting on its group's
    collectives (a rank that failed, whose peers may be waiting in one)."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
