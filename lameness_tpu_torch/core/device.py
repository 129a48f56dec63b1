"""Device selection: the port runs on the card unless told otherwise."""
from __future__ import annotations

from typing import Optional, Union

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

