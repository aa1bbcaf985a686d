"""The communicator of the sharded solvers: a one-axis mesh of processes.

Counterpart of `ba_tpu/parallel/shard.py`'s `make_mesh` and `AXIS`.  JAX's
`shard_map` is one program over a mesh of devices; here every rank is a
process that holds only its own shard of the problem, and the collectives
of `torch.distributed` take the place of XLA's:

  * `jax.lax.psum`       -> `Mesh.all_reduce_sum` (in place);
  * `jax.lax.all_gather` -> `Mesh.gather_rows`, an all-reduce of a
    zero-filled full buffer into which each rank writes its block: gloo
    has only `all_reduce` and `broadcast` for CUDA tensors;
  * `Mesh.broadcast`.

The backend is decided up front, never after a failure (`backend_for`):
NCCL when each rank has a card of its own (a host's cards cover the ranks
on that host), gloo on the CPU or when ranks share one card.  Nothing
swaps backends or moves to the CPU on an error.  `init_process_group`
gets a timeout of `TIMEOUT_S` (120 s) for the join and for every
collective, so a rank that desynchronizes fails instead of hanging its
peers.  `spawn` starts a world of processes on this host and waits for it
at most `SPAWN_TIMEOUT_S` (600 s, the whole run of the ranks).

`Mesh.single(device)` is a world of one rank that communicates nothing:
the sharded routes on it are the single-card routes with their sums split
the sharded way.

Each mesh counts its collectives (`stats`: calls, bytes and, with
`timed`, host seconds between a synchronize before and after each call).
"""

from __future__ import annotations

import datetime
import socket
import time
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist

from .. import resolve_device

TIMEOUT_S = 120
# seconds `spawn` waits for its ranks to finish
SPAWN_TIMEOUT_S = 600


def backend_for(device, local_size: int) -> str:
    """The backend of a world whose hosts each run `local_size` ranks on
    `device`'s type: "nccl" when the device is CUDA and each host has a
    card for every one of its ranks, else "gloo" (the CPU, or ranks
    sharing one card: NCCL refuses two ranks on one GPU).  On one host
    `local_size` is the world size."""
    dev = torch.device(device)
    if dev.type == "cuda" and local_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device, local_rank: int) -> torch.device:
    """The device of the rank `local_rank` of its host: its own card
    (`cuda:local_rank`) when the host has one per rank, else card
    `local_rank % count` (shared); the CPU stays the CPU.  Raises when
    CUDA is asked for and absent."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def free_port() -> int:
    """A free TCP port on 127.0.0.1, for the coordinator of a world on
    this host."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(fn, size: int, args=()):
    """Run fn(rank, size, init_method, *args) in `size` processes on this
    host (`torch.multiprocessing`, "spawn"), `init_method` a free
    `tcp://127.0.0.1` port; return once every rank has finished.  A rank's
    failure or SPAWN_TIMEOUT_S kills every rank and raises RuntimeError."""
    import torch.multiprocessing as mp

    init_method = f"tcp://127.0.0.1:{free_port()}"
    ctx = mp.start_processes(fn, args=(size, init_method) + tuple(args),
                             nprocs=size, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise RuntimeError(f"a world of {size} ranks did not "
                                   f"finish in {SPAWN_TIMEOUT_S} s")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        raise RuntimeError(f"a world of {size} ranks failed: {e}") from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


@dataclass
class Mesh:
    """One rank's view of a one-axis mesh: its rank, the world size, its
    device and process group (None for `single`)."""

    rank: int
    size: int
    device: torch.device
    group: Optional[object] = None
    backend: str = "none"
    timed: bool = False          # synchronize around each collective
    stats: dict = field(default_factory=lambda: dict(calls=0, bytes=0,
                                                     seconds=0.0))

    @staticmethod
    def single(device="cuda") -> "Mesh":
        """A world of one rank with no communication."""
        return Mesh(rank=0, size=1, device=resolve_device(device))

    @staticmethod
    def init(rank: int, size: int, device, init_method: str,
             local_size: Optional[int] = None) -> "Mesh":
        """Join the process group of `size` ranks at `init_method`
        (`tcp://host:port`) as `rank`, with a timeout of TIMEOUT_S, on the
        backend `backend_for` picks for `device` and `local_size` ranks a
        host (the world size by default: one host); `device` is the rank's
        own device (`rank_device`).  Raises when CUDA is asked for and
        absent."""
        dev = resolve_device(device)
        backend = backend_for(dev, size if local_size is None
                              else local_size)
        if backend == "nccl":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init_method, world_size=size, rank=rank,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        return Mesh(rank=rank, size=size, device=dev,
                    group=dist.group.WORLD, backend=backend)

    def reset_stats(self) -> None:
        self.stats = dict(calls=0, bytes=0, seconds=0.0)

    def _run(self, op, t):
        self.stats["calls"] += 1
        self.stats["bytes"] += t.numel() * t.element_size()
        if not self.timed:
            op()
            return
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        op()
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        self.stats["seconds"] += time.perf_counter() - t0

    def all_reduce_sum(self, t):
        """t <- sum of t over the ranks, in place (t must be contiguous);
        returns t.  Every rank ends with the same bits."""
        if self.group is not None:
            self._run(lambda: dist.all_reduce(t, group=self.group), t)
        return t

    def broadcast(self, t, src: int = 0):
        """t <- rank `src`'s t, in place; returns t."""
        if self.group is not None:
            self._run(lambda: dist.broadcast(t, src, group=self.group), t)
        return t

    def barrier(self) -> None:
        """Return once every rank has reached this call: an all-reduce of
        one zero, waited for on the device (NCCL's runs asynchronously)."""
        if self.group is None:
            return
        t = self.all_reduce_sum(torch.zeros(1, device=self.device))
        if t.is_cuda:
            torch.cuda.synchronize(t.device)

    def gather_rows(self, local, n_total: Optional[int] = None):
        """The all-gather along axis 0: every rank's (n, ...) block at rows
        [rank n, (rank + 1) n) of an (n_total, ...) buffer, n_total = size n
        by default.  Each slot holds one rank's values plus zeros, so the
        result is exact."""
        n = local.shape[0]
        if n_total is None:
            n_total = n * self.size
        if self.group is None:
            return local
        buf = local.new_zeros((n_total,) + tuple(local.shape[1:]))
        buf[self.rank * n: (self.rank + 1) * n] = local
        return self.all_reduce_sum(buf)

    def close(self) -> None:
        """Leave the process group (a `single` mesh has none)."""
        if self.group is not None:
            dist.destroy_process_group()
            self.group = None
