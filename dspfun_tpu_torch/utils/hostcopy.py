"""Device-to-host copies that do not stall the stream, and small host
scalars that reach the device without stalling it.

The frame-emitting tools (scan, zoom) dispatch the next chunk or frame
before they write the last one.  ``start_copy`` queues a tensor's copy
into a pinned host buffer behind the work that produces it and records a
CUDA event; ``finish_copy`` waits for that event only, so the device
goes on with whatever was queued after it.  On a CPU tensor both are
plain conversions.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["start_copy", "finish_copy", "upload_scalars"]


def start_copy(t: torch.Tensor | None):
    """Queue ``t``'s copy to the host; returns a handle for
    :func:`finish_copy` (None for None)."""
    if t is None:
        return None
    if t.device.type != "cuda":
        return t, None
    src = t.contiguous()
    host = torch.empty(src.shape, dtype=src.dtype, device="cpu", pin_memory=True)
    host.copy_(src, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def finish_copy(handle) -> np.ndarray | None:
    """The numpy array of a :func:`start_copy` handle, once its copy has
    landed."""
    if handle is None:
        return None
    host, event = handle
    if event is not None:
        event.synchronize()
    return host.numpy()


def upload_scalars(values, device: torch.device | str = "cuda",
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A 1-D tensor of host scalars on ``device`` in one copy.  A
    pageable upload waits for the stream's earlier work; from pinned
    memory it only queues."""
    host = torch.tensor([float(v) for v in values], dtype=dtype)
    if torch.device(device).type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)
