"""The dataset, training, weight and profiling tools of the port, one
module per script of the JAX package's ``scripts/`` (same file names, same
flags, the same files and JSON keys written), run as

    python -m lameness_tpu_torch.tools.<name> [args] [--device cuda|cpu]

Each runs on the card (``--device cuda``, the default; it raises without
one) unless ``--device cpu`` is passed.  The tools:
``analyze_training_orientation``, ``bulk_upload``, ``collect_cow_pose_data``,
``compare_pose_models``, ``convert_videos``, ``convert_weights``,
``prepare_pose_dataset``, ``profile_stages``, ``run_pipeline_example``,
``train_detector`` and ``train_pose_model``.
"""
from __future__ import annotations

import argparse

import torch

from ..core.device import resolve_device


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="where the work runs: cuda (default; raises "
                         "without a card) or cpu")


def device_of(args: argparse.Namespace) -> torch.device:
    """The device the command line asks for (``--cpu``, where a JAX script
    had it, means ``--device cpu``)."""
    return resolve_device("cpu" if getattr(args, "cpu", False)
                          else args.device)
