"""The port's multi-stream server (`apps/vins_stream.py:stream_many`)
against ba_tpu's and against each stream pushed alone.

Two independent streams of one 7-keyframe sequence (build seeds 3 and 4,
as `--streams` takes seeds 8 + m), W = 4, 2 GN iterations per slide, f64
on the CPU, pushed round-robin keyframe by keyframe, one ring each.  Every
retired keyframe's cost and state equal ba_tpu's `stream_many` to 1e-8
relative (roundoff of two solves and a marginalization per slide), and
equal the same stream pushed alone through `stream_sequence` exactly: the
rings share no state, so interleaving changes nothing.  Both count the
same steady keyframes.
"""

import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np

import ba_tpu.core.problem as jprob
from ba_tpu.io import simulate_vins as jsv
from ba_tpu.solver import streaming as jst
from ba_tpu_torch.apps import vins_stream as tvs
from ba_tpu_torch.solver import fixedlag as tfl
from ba_tpu_torch.solver import streaming as tst

from test_torch_common import assert_rel, to_torch, torch_config

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from apps import vins_stream as jvs  # noqa: E402

W, ITERS, N_POSES, SEEDS = 4, 2, 7, (3, 4)
KEYS = ("cost", "q", "t", "v", "b")


@functools.lru_cache(maxsize=None)
def case():
    """(JAX problems, JAX config, port problems, port config, caps)."""
    cfg = jprob.BAConfig(pose_dim=9, lm_size=1, use_dogleg=False)
    sim = jsv.simulate(n_poses=N_POSES, n_lms=40, seed=2)
    jps = []
    for seed in SEEDS:
        jp, _, _ = jsv.build_problem(sim, cfg, perturb=0.01, seed=seed,
                                     with_marg_prior=False)
        jps.append(jprob.prepare_landmarks(jp, cfg))
    tps = [to_torch(jp) for jp in jps]
    tcfg = torch_config(cfg)
    sched = tfl.build_ring_schedule(tps[0], tcfg, W, N_POSES - W + 1)
    return jps, cfg, tps, tcfg, tst.RingCapacities.from_schedule(sched)


def test_stream_many_matches_ba_tpu_and_each_stream_alone():
    jps, jcfg, tps, tcfg, caps = case()
    outs, _, n_steady = tvs.stream_many(tps, tcfg, W, ITERS, caps)
    jcaps = jst.RingCapacities(**dataclasses.asdict(caps))
    jouts, _, jn_steady = jvs.stream_many(jps, jcfg, W, ITERS, jcaps)
    n_slides = N_POSES - W + 1
    assert n_steady == jn_steady == len(SEEDS) * (n_slides - 1)
    assert [len(o) for o in outs] == [len(o) for o in jouts] \
        == [n_slides] * len(SEEDS)
    for m, tp in enumerate(tps):
        alone, _, _ = tvs.stream_sequence(tp, tcfg, W, ITERS, caps)
        assert len(alone) == n_slides
        for k in range(n_slides):
            assert outs[m][k]["pose"] == k
            for key in KEYS:
                assert_rel(outs[m][k][key], np.asarray(jouts[m][k][key]),
                           1e-8, f"stream {m} slide {k} {key} vs ba_tpu")
                np.testing.assert_array_equal(
                    outs[m][k][key], alone[k][key],
                    err_msg=f"stream {m} slide {k} {key} vs alone")
    # the streams differ (other perturbations) and both converge
    assert not np.array_equal(outs[0][-1]["t"], outs[1][-1]["t"])
    assert all(o[-1]["cost"] < 1e-4 for o in outs)
