"""Convert reference-format weights into the port's checkpoints (port of
``scripts/convert_weights.py``): an ultralytics YOLOv8 ``.pt`` state dict,
a segment-anything or HF ``SamModel`` checkpoint, or an HF
``Dinov2Model`` goes through the port's converter
(``models/yolo.convert_ultralytics_state_dict``,
``models/sam.convert_sa_state_dict``/``convert_hf_state_dict``,
``models/dino.convert_hf_state_dict``) into
``<out>/<kind>/params.torch`` (``pipeline/checkpoint.save_params``), which
``restore_engine`` installs at start-up:

  python -m lameness_tpu_torch.tools.convert_weights yolo path/to/yolov8n.pt [--out DIR]
  python -m lameness_tpu_torch.tools.convert_weights sam  path/to/sam_vit_b.pth
  python -m lameness_tpu_torch.tools.convert_weights dino path/to/dinov2-base/

An HF model directory is read from its ``model.safetensors`` (by the small
reader here) or its ``pytorch_model.bin``; neither machine has
``transformers`` or ``safetensors``, and nothing is downloaded, so a hub id
without local files raises.  Torch files load with ``weights_only=True``:
a checkpoint that pickles a whole model object (ultralytics' own ``.pt``)
must first be saved as its ``state_dict`` where ultralytics is installed.
The converted state dict is installed into the sub-model built on
``--device`` before it is written, so a file that would not load is never
saved.
"""
from __future__ import annotations

import argparse
import json
import struct
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from . import add_device_arg, device_of

HF_FILES = ("model.safetensors", "pytorch_model.bin")
_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool}


def read_safetensors(path: Path) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> {name: CPU tensor}: an 8-byte
    little-endian header length, a JSON header of dtype, shape and byte
    offsets, then the raw little-endian data."""
    raw = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])
    data = memoryview(raw)[8 + n:]
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(meta["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name}: dtype {meta['dtype']} not "
                             f"supported")
        begin, end = meta["data_offsets"]
        t = torch.frombuffer(bytearray(data[begin:end]), dtype=torch.uint8)
        out[name] = t.view(dtype).reshape(meta["shape"])
    return out


def load_torch_file(path: Path) -> Dict[str, torch.Tensor]:
    """A torch checkpoint's state dict (a plain one, or one under
    ``state_dict`` or ``model``)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and isinstance(obj.get("state_dict"), dict):
        obj = obj["state_dict"]
    elif isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: not a state dict")
    return obj


def load_source(src: str) -> Dict[str, torch.Tensor]:
    """A ``.pt``/``.pth``/``.bin``/``.safetensors`` file, or an HF model
    directory holding one of ``HF_FILES``."""
    p = Path(src)
    if p.is_dir():
        for name in HF_FILES:
            if (p / name).exists():
                return load_source(str(p / name))
        raise FileNotFoundError(f"{src}: an HF model directory needs one of "
                                f"{', '.join(HF_FILES)}")
    if not p.exists():
        raise FileNotFoundError(
            f"{src}: no such file or directory (hub ids are not downloaded: "
            f"give a local .pt/.pth/.bin/.safetensors file or an HF model "
            f"directory with {' or '.join(HF_FILES)})")
    if p.suffix == ".safetensors":
        return read_safetensors(p)
    return load_torch_file(p)


def convert(kind: str, sd: Dict[str, torch.Tensor], variant: str = "n"
            ) -> Dict[str, torch.Tensor]:
    """The port's state dict for sub-model ``kind`` from a reference
    checkpoint's."""
    from ..weights import from_jax_params
    if kind == "yolo":
        from ..models.yolo import convert_ultralytics_state_dict
        tree = convert_ultralytics_state_dict(sd, variant=variant)
    elif kind == "sam":
        from ..models import sam
        tree = (sam.convert_sa_state_dict(sd)
                if sam.detect_sam_layout(sd) == "sa"
                else sam.convert_hf_state_dict(sd))
    elif kind == "dino":
        from ..models.dino import convert_hf_state_dict
        tree = convert_hf_state_dict(sd)
    else:
        raise ValueError(f"no converter for {kind!r}")
    return from_jax_params({kind: tree})[kind]


def check_fits(kind: str, sd: Dict[str, torch.Tensor], variant: str,
               device) -> None:
    """Install ``sd`` into a ``kind`` sub-model built on ``device`` (the
    engine's geometry; SAM at the checkpoint's variant); raises when it
    does not fit."""
    from ..models.dino import DinoV2
    from ..models.sam import build_sam, infer_variant
    from ..models.yolo import YoloV8
    if kind == "yolo":
        module = YoloV8(variant, num_classes=sd["detect0.cls2.bias"].shape[0],
                        device=device)
    elif kind == "sam":
        module = build_sam(infer_variant(
            sd["vision_encoder.pos_embed"].shape[-1]), device=device)
    else:
        module = DinoV2(device=device)
    module.load_state_dict(sd, strict=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="convert_weights")
    ap.add_argument("kind", choices=("yolo", "sam", "dino"))
    ap.add_argument("src", help=".pt/.pth/.bin/.safetensors file or HF "
                                "model directory")
    ap.add_argument("--out", type=Path, default=Path("data/models"))
    ap.add_argument("--variant", default="n", help="yolo variant")
    ap.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_of(args)
    from ..pipeline.checkpoint import save_params

    sd = convert(args.kind, load_source(args.src), args.variant)
    check_fits(args.kind, sd, args.variant, device)
    path = save_params(args.out, args.kind, sd)
    print(f"saved {args.kind} checkpoint -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
