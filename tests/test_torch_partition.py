"""The host-side layout of the port's distribution against ba_tpu's:
`partition_by_landmark` and `stack_problems` equal ba_tpu's exactly, every
table, integers and floats alike; `shard_problem`'s rank blocks put back
together are the (padded) global problem, with the scalars on every rank;
the backend rule of `parallel/mesh.py`."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import ba_tpu.core.problem as jprob
from ba_tpu.io import simulate_vins as jsv
from ba_tpu.parallel.partition import partition_by_landmark as jpartition
from ba_tpu_torch.core.problem import stack_problems
from ba_tpu_torch.parallel import shard
from ba_tpu_torch.parallel.mesh import Mesh
from ba_tpu_torch.parallel.partition import partition_by_landmark

from test_torch_common import (assert_tree_rel, jax_problem, to_torch,
                               torch_config)


def _same_dtypes(got, want, what="problem"):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(w):
            _same_dtypes(g, w, f"{what}.{f.name}")
        else:
            assert g.dtype == torch.as_tensor(np.asarray(w)).dtype, \
                f"{what}.{f.name}"


@pytest.mark.parametrize("n_shards", [2, 4])
def test_partition_by_landmark_equals_ba_tpu(n_shards):
    """23 landmarks, padded to 24; the padded projection rows point at
    their shard's first landmark."""
    jp, jcfg, _ = jax_problem(n_poses=8, n_lms=30)
    want = jpartition(jp, jcfg, n_shards)
    got = partition_by_landmark(to_torch(jp), torch_config(jcfg), n_shards)
    assert_tree_rel(got, want, 0.0)
    _same_dtypes(got, want)
    L0 = jp.lms.x.shape[0]
    assert L0 % n_shards
    assert got.lms.x.shape[0] == -(-L0 // n_shards) * n_shards


def test_stack_problems_equals_ba_tpu():
    cfg = jprob.BAConfig(pose_dim=9, lm_size=1, use_dogleg=False)
    sim = jsv.simulate(n_poses=6, n_lms=20, seed=0)
    windows = [jsv.build_problem(sim, cfg, perturb=0.01, seed=100 + v)[0]
               for v in range(3)]
    want = jprob.stack_problems(windows)
    got = stack_problems([to_torch(w) for w in windows])
    assert_tree_rel(got, want, 0.0)
    _same_dtypes(got, want)
    assert got.poses.q.shape[0] == 3


@pytest.mark.parametrize("landmark_sharded", [False, True],
                         ids=["rows", "landmarks"])
def test_shard_blocks_rebuild_the_problem(landmark_sharded):
    jp, jcfg, _ = jax_problem(n_poses=8, n_lms=30)
    p = partition_by_landmark(to_torch(jp), torch_config(jcfg), 2)
    n = 2 if landmark_sharded else 3
    blocks = [shard.shard_problem(
        p, dataclasses.replace(Mesh.single("cpu"), rank=k, size=n),
        landmark_sharded) for k in range(n)]
    tables = ("proj", "unary", "binary", "imu") + (
        ("lms",) if landmark_sharded else ())
    for t in tables:
        for f in dataclasses.fields(getattr(p, t)):
            full = getattr(getattr(p, t), f.name)
            parts = [getattr(getattr(b, t), f.name) for b in blocks]
            if not full.dim():
                assert all(torch.equal(x, full) for x in parts), f.name
                continue
            joined = torch.cat(parts)
            n_rows = full.shape[0]
            assert joined.shape[0] % len(blocks) == 0
            assert torch.equal(joined[:n_rows], full), f"{t}.{f.name}"
            assert not torch.any(joined[n_rows:].bool()), \
                f"{t}.{f.name}: padding rows"
    for b in blocks:                       # replicated leaves: whole copies
        assert b.poses is p.poses and b.pidx is p.pidx and b.marg is p.marg
        if not landmark_sharded:
            assert b.lms is p.lms


def test_single_rank_mesh_communicates_nothing():
    mesh = Mesh.single("cpu")
    x = torch.arange(6.0).reshape(3, 2)
    assert mesh.all_reduce_sum(x) is x and mesh.broadcast(x) is x
    assert torch.equal(mesh.gather_rows(x), x)
    assert mesh.stats["calls"] == 0 and mesh.backend == "none"


def test_backend_rule_counts_the_ranks_of_a_host(monkeypatch):
    """NCCL when each rank of a host has a card of its own, across hosts
    too (two hosts of four cards: a world of eight, four ranks a host);
    gloo when ranks share a card, and on the CPU."""
    from ba_tpu_torch.parallel import multihost
    from ba_tpu_torch.parallel.mesh import backend_for

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert backend_for("cuda", 4) == "nccl"
    assert backend_for("cuda", 8) == "gloo"
    assert backend_for("cpu", 1) == "gloo"
    assert multihost._local_size(8, None) == 8
    assert multihost._local_size(8, 4) == 4
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert backend_for("cuda", multihost._local_size(8, None)) == "nccl"
