"""Device selection: the port runs on the card unless told otherwise."""
from __future__ import annotations

import functools
from typing import Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the current CUDA device, with its index (a tensor on
    the card reports ``cuda:0``, and ``torch.device("cuda")`` does not equal
    it).  Only an explicit ``"cpu"`` (what the tests pass) runs the plain
    PyTorch path on the CPU; without a CUDA device, ``None`` raises instead
    of carrying on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: lameness_tpu_torch runs on the GPU; pass "
            "device='cpu' to run its plain PyTorch path on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _frozen(values):
    if isinstance(values, (list, tuple)):
        return tuple(_frozen(v) for v in values)
    return values


@functools.lru_cache(maxsize=None)
def _constant(values, dtype: torch.dtype, device: torch.device):
    return torch.tensor(values, dtype=dtype, device=device)


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once per
    (values, dtype, device) and shared, so read it and never write it.  Made
    from host data at each call, a small tensor is copied to the card with
    a stream synchronisation, and the host can then queue no work ahead of
    the device (the serving stream's overlap needs it to)."""
    if isinstance(values, np.ndarray):
        values = values.tolist()
    return _constant(_frozen(values), dtype, torch.device(device))
