"""The mp4 codec's device half on the card against the same code on the CPU
(``lameness_tpu_torch/video/mpeg4.py``): integer arithmetic, so bit for
bit.  Needs an NVIDIA GPU (marker ``cuda``) and skips without one; the
file imports no JAX (tests/conftest.py does, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_mp4_cuda.py

- encoding: the card's levels, predictions and reconstruction, and so the
  file's bytes, equal the CPU's (720p, 640x480 and a size that is not a
  multiple of 16);
- decoding: the committed fixture (cv2's mp4v writer, I- and P-VOPs) and
  the port's own files give the same planes on the card as on the CPU, the
  fixture's luma cv2's hashes, and ``read_selected`` the same frames.
"""
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from lameness_tpu_torch.video import mpeg4
from lameness_tpu_torch.video.decode import VideoReader, write_video
from lameness_tpu_torch.video.yuv import rgb_to_i420

pytestmark = pytest.mark.cuda

FIXTURE = Path(__file__).resolve().parent / "torch_fixtures" / \
    "mp4v_gop12.mp4"
SIZES = ((720, 1280), (480, 640), (90, 168))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card path runs only there")
    return torch.device("cuda")


def frames(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    out = []
    for t in range(n):
        base = np.stack([128 + 100 * np.sin((x + 3 * t) / 17.0 + c)
                         * np.cos(y / 23.0 - c) for c in range(3)], -1)
        out.append(np.clip(base + rng.normal(0, 12, base.shape), 0,
                           255).astype(np.uint8))
    return np.stack(out)


def planes(path, device):
    with VideoReader(path, device=device) as vr:
        return np.concatenate([c for _, c in vr.i420_chunks(16)])


@pytest.mark.parametrize("h,w", SIZES)
def test_encoder_card_equals_cpu(dev, h, w):
    i420 = rgb_to_i420(torch.from_numpy(frames(3, h, w)))
    card = mpeg4.encode_forward(i420.to(dev))
    cpu = mpeg4.encode_forward(i420)
    for name in ("coefs", "acpred", "recon"):
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name)), \
            name


@pytest.mark.parametrize("h,w", SIZES)
def test_written_file_card_equals_cpu(dev, tmp_path, h, w):
    f = frames(5, h, w, seed=1)
    card = write_video(tmp_path / "card.mp4", torch.from_numpy(f).to(dev),
                       25)
    cpu = write_video(tmp_path / "cpu.mp4", f, 25, device="cpu")
    assert card.read_bytes() == cpu.read_bytes()
    np.testing.assert_array_equal(planes(card, dev), planes(card, "cpu"))


def test_fixture_card_equals_cpu_and_cv2(dev):
    meta = json.loads(FIXTURE.with_suffix(".json").read_text())
    got = planes(FIXTURE, dev)
    np.testing.assert_array_equal(got, planes(FIXTURE, "cpu"))
    assert [hashlib.sha256(np.ascontiguousarray(y[:meta["height"]])
                           .tobytes()).hexdigest() for y in got] == \
        meta["luma_sha256"]


@pytest.mark.parametrize("indices", [[0, 11, 12, 13, 25], [20, 3]])
def test_read_selected_card_equals_cpu(dev, indices):
    with VideoReader(FIXTURE, device=dev) as a, \
            VideoReader(FIXTURE, device="cpu") as b:
        x, y = a.read_selected(indices), b.read_selected(indices)
    assert list(x) == list(y) == sorted(indices)
    for i in x:
        np.testing.assert_array_equal(x[i], y[i])
