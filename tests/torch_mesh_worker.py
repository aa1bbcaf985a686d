"""One rank of the port's sharded-solve tests: a process that imports only
the port, torch and numpy (never jax, never a test module).

    python tests/torch_mesh_worker.py <rank> <size> <port> <dir>

It joins a world of <size> gloo ranks on the CPU through
`multihost.initialize` (coordinator 127.0.0.1:<port>), reads the cases of
<dir>/cases.json, runs each on its shard of the case's problem
(<dir>/<name>.npz: the JAX problem's leaves under dotted names, or a
stacked fleet / ring schedules) and writes its outputs to
<dir>/<name>.rank<rank>.npz.  Every rank runs with one thread
(`torch.set_num_threads(1)`), so that a rank's arithmetic is the same as
any other one-thread process's.

Case kinds:
  rows    row-sharded GN (`sharded_gn_iteration`), `iters` iterations;
  lm      landmark-sharded: one build (`shard._sharded_build`: delta_p,
          the rank's delta_l, cost, Cauchy factor), then `iters` GN or
          dogleg iterations (`sharded_*_iteration_lm`);
  fixed   `sharded_solve_fixed` over `iters` iterations;
  multihost  the problem built here by every rank from the seeds (the
          port's simulator and builder), partitioned, each rank keeping
          its rows, checked by `global_problem_from_local`, then
          `sharded_solve_fixed`;
  fleet   a stacked fleet: `sharded_fleet_solve` of the rank's windows,
          and on rank 0 also `step.solve_fleet` of every window;
  ring    ring schedules: `sharded_ring_fleet` of the rank's rings.
"""

import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch


def _tree(flat, prefix):
    """SimpleNamespace tree of the npz entries under `prefix.`."""
    root = SimpleNamespace()
    for key in flat.files:
        if not key.startswith(prefix + "."):
            continue
        node = root
        *path, leaf = key[len(prefix) + 1:].split(".")
        for name in path:
            if not hasattr(node, name):
                setattr(node, name, SimpleNamespace())
            node = getattr(node, name)
        setattr(node, leaf, flat[key])
    return root


def _config(spec):
    from ba_tpu_torch.core.problem import BAConfig

    return BAConfig(**spec["config"])


def _np(t):
    return t.detach().cpu().numpy()


def _states(p, out, tag=""):
    for f in ("q", "t", "v", "b"):
        out[f"{tag}poses_{f}"] = _np(getattr(p.poses, f))
    out[f"{tag}lms_x"] = _np(p.lms.x)


def _iterations(res_list, out):
    for key in ("pre_cost", "post_cost", "delta_norm", "accepted",
                "trust_radius", "inner_trials", "solver_ok"):
        out[key] = np.array([_np(getattr(r, key)) for r in res_list])


def run_case(spec, data, mesh):
    from ba_tpu_torch.convert import problem_from_numpy
    from ba_tpu_torch.parallel import shard
    from ba_tpu_torch.solver.step import apply_robust_reweighting

    kind, cfg = spec["kind"], _config(spec)
    use_imu, iters = spec["use_imu"], spec["iters"]
    out = {}
    if kind in ("rows", "lm", "fixed"):
        p = problem_from_numpy(_tree(data, "problem"), device="cpu")
        p = shard.shard_problem(p, mesh, landmark_sharded=kind != "rows")
    if kind == "rows":
        res = []
        for _ in range(iters):
            res.append(shard.sharded_gn_iteration(p, cfg, use_imu, mesh))
            p = res[-1].problem
        _iterations(res, out)
        _states(p, out)
    elif kind == "lm":
        off = shard._offset(p, mesh)
        local = shard._localize(p, off)
        plan = shard.shard_plan(local, cfg, mesh)
        built = shard._sharded_build(
            apply_robust_reweighting(local, cfg, use_imu, mesh), cfg,
            use_imu, mesh, plan, dogleg=cfg.use_dogleg)
        out.update(delta_p=_np(built.step.delta_p),
                   delta_l=_np(built.step.delta_l), cost=_np(built.cost),
                   ok=_np(built.step.ok))
        if cfg.use_dogleg:
            out["alpha"] = _np(built.cauchy_alpha)
        trust = torch.full((), cfg.trust_region_size, dtype=torch.float64)
        res = []
        for _ in range(iters):
            if cfg.use_dogleg:
                r = shard.sharded_dogleg_iteration_lm(p, cfg, use_imu, mesh,
                                                      trust)
                trust = r.trust_radius
            else:
                r = shard.sharded_gn_iteration_lm(p, cfg, use_imu, mesh)
            res.append(r)
            p = r.problem
        _iterations(res, out)
        _states(p, out)
        out["proj_lm"] = _np(p.proj.lm)
    elif kind == "fixed":
        p, costs, dns = shard.sharded_solve_fixed(p, cfg, use_imu, mesh,
                                                  iters)
        out.update(costs=_np(costs), dns=_np(dns))
        _states(p, out)
    elif kind == "multihost":
        out.update(_multihost(spec, cfg, mesh))
    elif kind == "fleet":
        from ba_tpu_torch.solver import step

        fleet = problem_from_numpy(_tree(data, "problem"), device="cpu")
        p, costs, dns = shard.sharded_fleet_solve(fleet, cfg, use_imu, mesh,
                                                  iters)
        out.update(costs=_np(costs), dns=_np(dns))
        _states(p, out)
        if mesh.rank == 0:
            p, costs, dns = step.solve_fleet(fleet, cfg, use_imu, iters)
            out.update(all_costs=_np(costs), all_dns=_np(dns))
            _states(p, out, "all_")
    elif kind == "ring":
        out.update(_ring(spec, data, cfg, mesh))
    else:
        raise ValueError(f"unknown case kind {kind}")
    return out


def _multihost(spec, cfg, mesh):
    import dataclasses

    from ba_tpu_torch.core.problem import prepare_landmarks
    from ba_tpu_torch.io import simulate_vins as sv
    from ba_tpu_torch.parallel import multihost, shard
    from ba_tpu_torch.parallel.partition import partition_by_landmark

    # every process builds the same problem (the tests' problem A: an
    # active random prior made from a numpy seed), then keeps only its
    # own rows (a stand-in for per-process data loading)
    sim = sv.simulate(n_poses=spec["poses"], n_lms=spec["lms"], seed=0)
    problem, _, _ = sv.build_problem(sim, cfg, perturb=spec["perturb"],
                                     seed=1, device="cpu")
    rng = np.random.default_rng(1)
    m = problem.marg
    n, scale = m.H.shape[0], spec["prior_scale"]
    A = rng.standard_normal((n, n)) * scale
    problem = dataclasses.replace(problem, marg=dataclasses.replace(
        m, H=torch.as_tensor(A @ A.T),
        g=torch.as_tensor(rng.standard_normal(n) * scale),
        lin_t=m.lin_t + 0.01 * scale, active=torch.ones((), dtype=bool)))
    problem = partition_by_landmark(problem, cfg, mesh.size)
    problem = prepare_landmarks(problem, cfg)
    local = shard.shard_problem(problem, mesh, landmark_sharded=True)
    local = multihost.global_problem_from_local(local, mesh)
    _, costs, dns = shard.sharded_solve_fixed(local, cfg, spec["use_imu"],
                                              mesh, spec["iters"])
    return dict(costs=_np(costs), dns=_np(dns))


def _ring(spec, data, cfg, mesh):
    from ba_tpu_torch.convert import ring_schedule_from_numpy
    from ba_tpu_torch.parallel import shard

    scheds = []
    for s in range(spec["rings"]):
        t = _tree(data, f"ring{s}")
        t.W, t.L_w, t.n_slides = (int(data[f"ring{s}_{k}"])
                                  for k in ("W", "L_w", "n_slides"))
        t.carry0 = tuple(getattr(t.carry0, f"c{i}") for i in range(6))
        t.inputs = vars(t.inputs)
        scheds.append(ring_schedule_from_numpy(t, device="cpu"))
    rings = shard.sharded_ring_fleet(scheds, cfg, spec["use_imu"], mesh,
                                     spec["iters"])
    return {f"outs_{k}": np.stack([_np(outs[k]) for _, outs in rings])
            for k in rings[0][1]}


def flatten(tree, prefix, out=None):
    """{dotted name: numpy array} of a tree of dataclasses, dicts, tuples
    (entries c0, c1, ...) and array-likes: the npz layout `_tree` reads."""
    import dataclasses

    out = {} if out is None else out
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            flatten(getattr(tree, f.name), f"{prefix}.{f.name}", out)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            flatten(v, f"{prefix}.{k}", out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            flatten(v, f"{prefix}.c{i}", out)
    else:
        out[prefix] = np.asarray(tree)
    return out


def run_world(out_dir, cases, arrays, size=2, timeout=120, during=None):
    """Spawn a world of `size` ranks of this module on the CPU, running
    `cases` on the problems in `arrays` ({case name: npz dict}); call
    `during()` while they run; join them within `timeout` seconds (killing
    every rank and failing on expiry or on a rank's error).  Returns
    ({case name: [each rank's outputs]}, during()'s value, {case name:
    rank 0's seconds})."""
    import os
    import subprocess

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "cases.json").write_text(json.dumps(cases))
    for name, arr in arrays.items():
        np.savez(out_dir / f"{name}.npz", **arr)
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(repo) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    from ba_tpu_torch.parallel.mesh import free_port

    port = free_port()
    logs = [open(out_dir / f"rank{r}.log", "w") for r in range(size)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(size), str(port),
         str(out_dir)], cwd=repo, env=env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(size)]
    deadline = time.monotonic() + timeout
    try:
        extra = during() if during is not None else None
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise
    finally:
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode:
            log = (out_dir / f"rank{r}.log").read_text()[-4000:]
            raise AssertionError(f"rank {r} exited {p.returncode}:\n{log}")
    results = {c["name"]: [dict(np.load(out_dir / f"{c['name']}.rank{r}.npz"))
                           for r in range(size)] for c in cases}
    times = json.loads((out_dir / "times.rank0.json").read_text())
    return results, extra, times


def main():
    rank, size, port = (int(a) for a in sys.argv[1:4])
    out_dir = Path(sys.argv[4])
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    from ba_tpu_torch.parallel import multihost

    multihost.initialize(f"127.0.0.1:{port}", size, rank, device="cpu")
    mesh = multihost.make_global_mesh("cpu")
    cases = json.loads((out_dir / "cases.json").read_text())
    times = {}
    for spec in cases:
        name = spec["name"]
        path = out_dir / f"{name}.npz"
        data = np.load(path) if path.exists() else None
        mesh.reset_stats()
        t0 = time.perf_counter()
        out = run_case(spec, data, mesh)
        times[name] = time.perf_counter() - t0
        out["collectives"] = np.array([mesh.stats["calls"],
                                       mesh.stats["bytes"]])
        np.savez(out_dir / f"{name}.rank{rank}.npz", **out)
    (out_dir / f"times.rank{rank}.json").write_text(json.dumps(times))
    mesh.close()


if __name__ == "__main__":
    main()
