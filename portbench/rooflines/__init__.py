"""Operation and byte counts of the port's kernels, one file per kernel.

Copied from `chip_smoke.py` (PR 9 and PR 12's reviews: the bytes "as the
function needs them", each input read once and each output written once;
the operations of the function, not of the kernel's own route), so that a
later change to the program cannot move the yardstick.  Each module has:

  WRAPPER   (module, attribute) of the program's launching function, which
            the traced run wraps to see the shapes of one call;
  count(args, kwargs, out) -> dict(bytes=..., flops=...) of one call;
  counted(args, kwargs) -> bool (optional): whether a call is one of the
            counted kind (all calls when absent);
  match(kernel_name) -> bool: the device kernels one call launches.

`bound_s(counts)` is the least time of a call on an H100 SXM at 700 W:
max(bytes / 3.35 TB/s, flops / 67 TFLOP/s, f32 outside the tensor cores).
"""

from __future__ import annotations

HBM_BPS = 3.35e12
F32_FLOPS = 67e12


def bound_s(counts: dict) -> tuple[float, str]:
    t_b = counts["bytes"] / HBM_BPS
    t_f = counts["flops"] / F32_FLOPS
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)
