"""Host arrays on the device without a host synchronisation.

A tensor built with numpy and copied to the card from pageable host memory
waits for the device: such a copy is synchronous. A module that does it on
every call (a window mask, a filter's taps, a resize's weights) stalls the
host once per call, however small the array. Two ways around it:

- ``cached``: an array that depends only on its key is copied once per (key,
  device, dtype) and the same tensor is handed out after that. Callers never
  write to it. The cache is bounded in entries and in bytes (a SwinIR shift
  mask is 64 MiB at 512 x 512), the least recently used going first.
- ``to_device``: an array that changes from call to call (the weights of a
  drawn scale) is copied from pinned memory without blocking the host.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Hashable, Optional

import numpy as np
import torch

# constants and their bytes kept at once; the least recently used goes first
# past either (the newest entry stays, however large)
MAX_ENTRIES = 512
MAX_BYTES = 1 << 30

_CACHE: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()


def to_device(array, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """`array` (numpy, or a tensor, which is moved as it is) on `device`, cast
    to `dtype` when one is given; a host array goes to a CUDA device from
    pinned memory, without a host synchronisation."""
    device = torch.device(device)
    if torch.is_tensor(array):
        return array.to(device=device, dtype=dtype)
    t = torch.from_numpy(np.ascontiguousarray(array))
    if dtype is not None:  # on the host, where a copy to the card converts too
        t = t.to(dtype)
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device=device, non_blocking=True)


def cached(key: Hashable, device, build: Callable[[], np.ndarray],
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """`build()`'s array on `device` (cast to `dtype`, if given), built and
    copied once per (key, device, dtype): `key` must name everything the
    array depends on. The tensor is shared between callers, who must not
    write to it."""
    device = torch.device(device)
    full = (key, device, dtype)
    t = _CACHE.get(full)
    if t is None:
        t = to_device(build(), device, dtype)
        _CACHE[full] = t
        held = sum(x.nbytes for x in _CACHE.values())
        while len(_CACHE) > 1 and (len(_CACHE) > MAX_ENTRIES or held > MAX_BYTES):
            held -= _CACHE.popitem(last=False)[1].nbytes
    else:
        _CACHE.move_to_end(full)
    return t
