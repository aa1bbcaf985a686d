"""Host-side landmark partitioning for the distributed Schur solve.

Port of `ba_tpu/parallel/partition.py`.  Landmarks are ordered by their
reference pose (so a contiguous chunk is a keyframe segment of the
trajectory) and split into `n_shards` equal chunks; every projection row
is owned by its landmark's shard (a projection touches one landmark, so
there is no halo).  With this layout each rank's landmark system (V,
rhs_l, its W blocks and the back-substitution) is its own; only the
pose-space partial sums cross ranks (`parallel/shard.py`).

numpy on the host, once per problem, like `ProblemBuilder.build`; the
result lives on the input's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.problem import BAConfig, Problem, build_structure_index


def _np(t):
    return t.detach().cpu().numpy()


def partition_by_landmark(problem: Problem, config: BAConfig,
                          n_shards: int) -> Problem:
    """Reorder landmarks by keyframe segment and group projection rows by
    owning shard (equal-size, padded).  Returns a new Problem whose lms /
    proj tables are laid out so that cutting them into `n_shards` equal
    row blocks gives each rank exactly its own landmarks and their
    residuals (`shard.shard_problem`).  Padded landmarks and rows are
    invalid; a padded row points at its shard's first landmark, inside the
    shard's own chunk.

    Call before or after `prepare_landmarks` (all (L, ...) state arrays
    are permuted together)."""
    lms = problem.lms
    pr = problem.proj
    dev = problem.poses.t.device
    L = int(lms.x.shape[0])
    ref_pose = _np(lms.ref_pose)
    # order landmarks by reference pose (stable keeps build order within a
    # pose); padding slots sort with their ref_pose 0 but are inert
    order = np.argsort(ref_pose, kind="stable")
    L_new = -(-L // n_shards) * n_shards
    Lk = L_new // n_shards

    inv = np.zeros(L, np.int64)
    inv[order] = np.arange(L)

    def permute_lms(a):
        a = _np(a)
        out = a[order]
        if L_new > L:
            pad = np.zeros((L_new - L,) + a.shape[1:], a.dtype)
            out = np.concatenate([out, pad], 0)
        return torch.as_tensor(out, device=dev)

    lms_new = dataclasses.replace(lms, **{
        f.name: permute_lms(getattr(lms, f.name))
        for f in dataclasses.fields(lms)})

    # regroup projection rows by owning shard
    lm_new_ids = inv[_np(pr.lm)]
    valid = _np(pr.valid)
    owner = lm_new_ids // Lk
    buckets = [np.flatnonzero(valid & (owner == k)) for k in range(n_shards)]
    per = max(max((len(b) for b in buckets), default=1), 1)

    def regroup(a):
        a = _np(a)
        out = np.zeros((n_shards * per,) + a.shape[1:], a.dtype)
        for k, b in enumerate(buckets):
            out[k * per: k * per + len(b)] = a[b]
        return out

    pose_new = regroup(pr.pose)
    valid_new = np.zeros(n_shards * per, bool)
    lm_col = np.zeros(n_shards * per, np.int32)
    for k, b in enumerate(buckets):
        valid_new[k * per: k * per + len(b)] = True
        lm_col[k * per: k * per + len(b)] = lm_new_ids[b]
        # padding rows index inside the shard's own chunk, so that the
        # shard-local ids stay in range
        lm_col[k * per + len(b): (k + 1) * per] = k * Lk

    # refresh the sparsity tables for the new row/landmark numbering
    ref_new = _np(lms_new.ref_pose)[lm_col]
    bn, im = problem.binary, problem.imu
    per_row, pidx = build_structure_index(
        pose_new, ref_new, lm_col, valid_new, _np(bn.pose1), _np(bn.pose2),
        _np(bn.valid), _np(im.pose1), _np(im.pose2), _np(im.valid),
        int(problem.poses.q.shape[0]), L_new, pad_multiple=1, device=dev)

    def T(a):
        return torch.as_tensor(a, device=dev)

    proj_new = dataclasses.replace(
        pr, z=T(regroup(pr.z)), pose=T(pose_new), lm=T(lm_col),
        cam=T(regroup(pr.cam)), weight=T(regroup(pr.weight)),
        valid=T(valid_new), cond=T(regroup(pr.cond)),
        pair=T(per_row["pair"]), pair_swap=T(per_row["pair_swap"]),
        wb_meas=T(per_row["wb_meas"]), wb_ref=T(per_row["wb_ref"]))
    binary_new = dataclasses.replace(bn, pair=T(per_row["bpair"]),
                                     pair_swap=T(per_row["bswap"]))
    imu_new = dataclasses.replace(im, pair=T(per_row["ipair"]),
                                  pair_swap=T(per_row["iswap"]))
    return dataclasses.replace(problem, lms=lms_new, proj=proj_new,
                               binary=binary_new, imu=imu_new, pidx=pidx)
