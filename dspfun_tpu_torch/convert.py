"""Carry the JAX package's plans across to the port.

``dspfun_tpu``'s ``AxisPlan`` and ``FilterPlans`` hold host numpy arrays
(``hi``, ``lo``, ``digits``, ``scale``, ``rowsum``, ``support``).  These
helpers turn them into the port's tensors on a device, so one plan can
feed both packages.  Only numpy crosses the boundary: this module
imports nothing of JAX.  The bfloat16 digit planes of the ``exact``
mode arrive as ``ml_dtypes.bfloat16`` arrays; they hold small integers,
so the detour through float32 is exact.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dspfun_tpu_torch.core.transforms import AxisPlan
from dspfun_tpu_torch.models.fused import FilterPlans

__all__ = ["axis_plan_from_jax", "filter_plans_from_jax", "motion_plans_from_jax",
           "scan_plan_from_jax", "zoom_plans_from_jax"]


def _tensor(a, device) -> torch.Tensor | None:
    if a is None:
        return None
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.tensor(arr, device=device)


def axis_plan_from_jax(plan, device: torch.device | str = "cuda") -> AxisPlan:
    """A JAX-package ``AxisPlan`` as the port's ``AxisPlan`` on ``device``."""
    return AxisPlan(*(_tensor(f, device) for f in plan))


def filter_plans_from_jax(plans, device: torch.device | str = "cuda") -> FilterPlans:
    """A JAX-package ``FilterPlans`` as the port's ``FilterPlans`` on ``device``."""
    fwd, inv, support = plans
    return FilterPlans(
        tuple(axis_plan_from_jax(p, device) for p in fwd),
        tuple(axis_plan_from_jax(p, device) for p in inv),
        tuple(None if k is None else torch.tensor(np.asarray(k, np.int64), device=device)
              for k in support),
    )


def motion_plans_from_jax(plans, device: torch.device | str = "cuda") -> tuple:
    """A JAX-package motion plan tuple ``(fwd, inv[, kron])`` — ``fwd``
    and ``inv`` tuples of ``AxisPlan``, ``kron`` a pair of ``AxisPlan``
    or None (``motion_pipeline.make_plans`` and ``maybe_kron_plans``) —
    as the port's, on ``device``."""
    return tuple(None if group is None
                 else tuple(axis_plan_from_jax(p, device) for p in group)
                 for group in plans)


def scan_plan_from_jax(plan, device: torch.device | str = "cuda"):
    """A JAX-package ``ScanPlan`` (host schedule arrays and two inverse
    ``AxisPlan``s) as the port's ``ScanPlan`` with its plans on
    ``device``; the schedule arrays are shared, not copied."""
    from dspfun_tpu_torch.models.scan_pipeline import ScanPlan  # noqa: PLC0415

    fields = {f.name: getattr(plan, f.name) for f in dataclasses.fields(ScanPlan)}
    fields["plans_inv"] = tuple(axis_plan_from_jax(p, device) for p in plan.plans_inv)
    return ScanPlan(**fields)


def zoom_plans_from_jax(plans, device: torch.device | str = "cuda") -> tuple:
    """The JAX package's ``zoom_plan`` result ``(plan_y, plan_x)`` as the
    port's pair of ``AxisPlan``s on ``device``."""
    plan_y, plan_x = plans
    return axis_plan_from_jax(plan_y, device), axis_plan_from_jax(plan_x, device)
