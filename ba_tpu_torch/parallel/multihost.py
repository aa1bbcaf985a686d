"""Multi-process glue: join the world, build its mesh, check each rank's
rows.

Port of `ba_tpu/parallel/multihost.py`.  The sharded solvers
(`shard.sharded_gn_iteration_lm`, `sharded_dogleg_iteration_lm`,
`sharded_solve_fixed`) take any `Mesh`; what is particular to many
processes is joining the world and the data each process holds.  JAX
assembles a global array from every process's rows
(`make_array_from_process_local_data`); the port has no global array, so
`global_problem_from_local` checks that the rank's problem has the layout
that `partition.partition_by_landmark` + `shard.shard_problem` give it,
and hands it back.

    multihost.initialize("127.0.0.1:29500", 2, rank, device="cpu")
    mesh = multihost.make_global_mesh("cpu")

The coordinator address is `host:port` (a `tcp://` init method).  Ranks
are numbered host by host, `local_size` of them on each host (torchrun's
`LOCAL_WORLD_SIZE`; by default every process on one host): a rank's card
is its local rank's (`mesh.rank_device`), and the backend follows
`mesh.backend_for` on the ranks of a host (NCCL when each has its own
card, across hosts too), printed by the callers.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .. import resolve_device
from ..core.problem import Problem
from .mesh import Mesh, rank_device


def _local_size(num_processes: int, local_size: int | None) -> int:
    """The ranks on each host: `local_size`, else LOCAL_WORLD_SIZE, else
    every process (one host)."""
    if local_size is None:
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    return local_size


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device="cuda",
               local_size: int | None = None) -> None:
    """Join the world of `num_processes` processes as `process_id`, with
    the coordinator at `coordinator_address` (`host:port`) and a timeout
    of `mesh.TIMEOUT_S`, `local_size` processes a host (see the module
    docstring); the backend follows `mesh.backend_for`.  A no-op for a
    single process (address None and one process or None).  Raises when
    CUDA is asked for (the default) and absent."""
    dev = resolve_device(device)
    if coordinator_address is None and num_processes in (None, 1):
        return
    local_size = _local_size(num_processes, local_size)
    Mesh.init(process_id, num_processes,
              rank_device(dev, process_id % local_size),
              f"tcp://{coordinator_address}", local_size=local_size)


def make_global_mesh(device="cuda", local_size: int | None = None) -> Mesh:
    """The one-axis mesh of every process of the world (`initialize`, with
    the same `local_size`), on this rank's device (`mesh.rank_device` of
    its local rank); `Mesh.single` when no world was joined."""
    if not dist.is_initialized():
        return Mesh.single(device)
    rank, size = dist.get_rank(), dist.get_world_size()
    local_rank = rank % _local_size(size, local_size)
    return Mesh(rank=rank, size=size, device=rank_device(device, local_rank),
                group=dist.group.WORLD, backend=dist.get_backend())


def _sizes(problem: Problem, landmark_sharded: bool):
    tables = [problem.proj.z, problem.unary.pose, problem.binary.pose1,
              problem.imu.pose1] + ([problem.lms.x] if landmark_sharded
                                    else [])
    return [t.shape[0] for t in tables]


def _fingerprint(problem: Problem, landmark_sharded: bool):
    """Sums and absolute sums of every replicated leaf, in f64 (a rank's
    copy of the replicated state, as a vector)."""
    sharded = {"proj", "unary", "binary", "imu"} | (
        {"lms"} if landmark_sharded else set())
    out = []
    for name in ("poses", "lms", "rig", "g_vec", "marg", "pidx"):
        if name in sharded:
            continue
        node = getattr(problem, name)
        leaves = ([node] if isinstance(node, torch.Tensor)
                  else [getattr(node, f) for f in node.__dataclass_fields__])
        for a in leaves:
            a = a.double()
            out += [a.sum(), a.abs().sum()]
    return torch.stack(out)


def global_problem_from_local(local_problem: Problem, mesh: Mesh,
                              landmark_sharded: bool = True) -> Problem:
    """The rank's problem, checked against the sharded layout: every rank
    holds the same number of rows of each residual table (and of
    landmarks), with `landmark_sharded` every projection row (padding too)
    points inside the rank's landmark chunk, and the replicated leaves are
    the same on every rank.  Raises ValueError on every rank when any rank
    fails (one all-reduce of the failures, so none is left waiting)."""
    dev = local_problem.poses.t.device
    sizes = torch.tensor(_sizes(local_problem, landmark_sharded),
                         dtype=torch.float64, device=dev)
    fp = _fingerprint(local_problem, landmark_sharded).to(dev)
    ref = mesh.broadcast(torch.cat([sizes, fp]).contiguous())
    bad = [int(not torch.equal(ref[: len(sizes)], sizes)),
           int(not torch.equal(ref[len(sizes):], fp)), 0]
    if landmark_sharded:
        Lk = local_problem.lms.x.shape[0]
        lm = local_problem.proj.lm.long()
        bad[2] = int(bool(((lm < mesh.rank * Lk)
                           | (lm >= (mesh.rank + 1) * Lk)).any()))
    flags = mesh.all_reduce_sum(torch.tensor(bad, dtype=torch.float64,
                                             device=dev))
    what = [w for w, f in zip(("row counts differ between ranks",
                               "replicated leaves differ between ranks",
                               "projection rows outside the rank's "
                               "landmark chunk"), flags.tolist()) if f]
    if what:
        raise ValueError("global_problem_from_local: " + "; ".join(what))
    return local_problem
