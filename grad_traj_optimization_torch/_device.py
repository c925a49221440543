"""The batch entry points' device rule.

``solver.solve_kino_batch[_race]``, ``pipeline.plan_batch`` and
``search.kinodynamic.search``, ``search_batch`` and
``search_batch_adaptive`` run where their distance field lies:

* a tensor field sets the device;
* a numpy field goes to ``device``, the card unless the caller asks for
  another;
* any other tensor argument on another device raises ValueError: nothing
  is copied across devices without being asked.
"""

from __future__ import annotations

import numpy as np
import torch


def field_device(dists, device=None):
    """(field tensor, its device) under the rule; a numpy field becomes
    float32.  ``device`` given with a tensor field on another device
    raises ValueError."""
    if isinstance(dists, torch.Tensor):
        if device is not None:
            want = torch.device(device)
            if want.type != dists.device.type or (
                    want.index is not None
                    and want.index != dists.device.index):
                raise ValueError(f"the distance field is on {dists.device},"
                                 f" device={device!r} was asked for")
        return dists, dists.device
    d = torch.as_tensor(np.asarray(dists), dtype=torch.float32,
                        device="cuda" if device is None else device)
    return d, d.device


def check_on(dev: torch.device, **args) -> None:
    """Raise ValueError for a tensor (or a NamedTuple of tensors) in
    ``args`` that lies on another device than ``dev``."""
    for name, x in args.items():
        leaves = x if isinstance(x, tuple) else (x,)
        for leaf in leaves:
            if isinstance(leaf, torch.Tensor) and leaf.device != dev:
                raise ValueError(f"{name} is on {leaf.device}, the distance"
                                 f" field on {dev}")


def on(x, dev: torch.device, name: str, dtype=torch.float32):
    """``x`` as a ``dtype`` tensor on ``dev``, the field's device; a
    tensor on another device raises ValueError."""
    check_on(dev, **{name: x})
    return torch.as_tensor(x, dtype=dtype, device=dev)
