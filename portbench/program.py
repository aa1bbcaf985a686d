"""The batch solve an entry drives: the program's problem from a scene,
its outputs, and the plain reference's answer to the same scene."""

from __future__ import annotations

import dataclasses

import torch

_NOT_BACONFIG = ("dtype", "camera_model", "imu")


def port_config(config: dict, mix: dict):
    """The program's `BAConfig` from the configuration's solver settings and
    the mix's (IMU noise under `imu`)."""
    from ba_tpu_torch.core.problem import BAConfig

    s = dict(config["solver"], **mix.get("solver", {}))
    kw = {k: v for k, v in s.items() if k not in _NOT_BACONFIG}
    for k, v in s.get("imu", {}).items():
        kw[k] = v
    fields = {f.name for f in dataclasses.fields(BAConfig)}
    unknown = set(kw) - fields - {"band_width_auto"}
    if unknown:
        raise ValueError(f"portbench: not BAConfig fields: {sorted(unknown)}")
    return BAConfig(**{k: v for k, v in kw.items() if k in fields}), s


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Batch:
    """The program's problem of one scene (a fleet's windows fused), built
    in bulk by `scenes/port.py`, and its landmarks prepared."""

    def __init__(self, scene, cl, device):
        from ba_tpu_torch.core.problem import prepare_landmarks
        from ba_tpu_torch.solver import assemble

        from .scenes import port

        cfg, s = port_config(cl.config, cl.mix)
        self.dtype = getattr(torch, s.get("dtype", "float32"))
        prob = port.problem(scene, cfg, self.dtype, device)
        if s.get("band_width_auto"):
            cfg = dataclasses.replace(cfg,
                                      band_width=assemble.band_width_of(prob))
        if scene.windows > 1:
            cfg = dataclasses.replace(cfg, fleet_size=scene.windows)
        self.cfg, self.mix, self.device = cfg, cl.mix, device
        self.use_imu = scene.imu_pose1.shape[0] > 0
        self.raw = prob
        self.prepared = prepare_landmarks(prob, cfg)


def states(out) -> dict:
    """The states of a solved `Problem` that the check compares."""
    return dict(q=out.poses.q, t=out.poses.t, v=out.poses.v, b=out.poses.b,
                lm=out.lms.x)


def reference(inputs, cl, dtype=torch.float64, tf32: bool = False) -> dict:
    """The reference's solve of the scene `inputs` as the cell states it,
    with its start state and semantics."""
    from .reference import ba

    sem = ba.semantics(cl.config, cl.mix, inputs.windows)
    ref = ba.solve(inputs, sem, dtype=dtype, tf32=tf32)
    ref["start"], ref["ray"] = ba.initial_state(inputs, sem)
    ref["sem"] = sem
    ref["summary"] = (
        f"reference cost {float(ref['costs'][0]):.9g} -> "
        f"{float(ref['costs'][-1]):.9g}; pcg iterations "
        f"{ref['pcg_iterations']}; phases "
        + ", ".join(f"{k} {v:.2f}" for k, v in ref["phases"].items()))
    return ref


def outputs_of(ctl: dict) -> dict:
    """A reference's result (the control) in the program's output layout,
    float64."""
    st, ray, sem = ctl["state"], ctl["ray"], ctl["sem"]
    if sem.lm_size == 3:
        lm = torch.cat([st.lm, torch.ones_like(st.lm[:, :1])], 1)
    else:
        lm = torch.cat([ray, st.lm[:, None]], 1)
    out = dict(q=st.q, t=st.t, v=st.v, b=st.b, lm=lm, costs=ctl["costs"])
    return {k: v.double() for k, v in out.items()}


def numbers(out: dict, ref: dict) -> dict:
    """The check's numbers of one output (float64, on any device) against
    the reference's answer."""
    from . import compare

    sem = ref["sem"]
    dev = ref["costs"].device
    out = {k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in out.items()}
    return compare.numbers(out, ref, ref["start"], sem.lm_size, sem.pose_dim,
                           sem.windows)
