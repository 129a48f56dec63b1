"""The image codec's device half on the card against the same code on the
CPU (``lameness_tpu_torch/video/image.py``): integer arithmetic, so bit for
bit.  Needs an NVIDIA GPU (marker ``cuda``) and skips without one; the
file imports no JAX (tests/conftest.py does, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_image_cuda.py

- decoding: the card's pixels of each of 4:4:4, 4:2:2, 4:2:0 and gray
  JPEGs (the port's own, at 720p and 640x480, and odd sizes) equal the
  CPU's;
- encoding: the card's quantised blocks, and so the file's bytes, equal
  the CPU's;
- a PNG written and read back on the card is the frame, bit for bit.
"""
import numpy as np
import pytest
import torch

from lameness_tpu_torch.video import image as im

pytestmark = pytest.mark.cuda

SIZES = ((720, 1280), (480, 640), (37, 53))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card path runs only there")
    return torch.device("cuda")


def frame(h, w, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 17.0 + c) * np.cos(y / 23.0 - c)
                     for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(
        np.uint8)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0", "gray"])
def test_card_codec_equals_cpu(dev, sampling, size):
    rgb = frame(*size)
    src = rgb[..., 0] if sampling == "gray" else rgb
    sub = "4:2:0" if sampling == "gray" else sampling
    card = im.jpeg_forward(src, 95, sub, device=dev)
    cpu = im.jpeg_forward(src, 95, sub, device="cpu")
    for a, b in zip(card.components, cpu.components):
        assert (a.coefs == b.coefs).all()
    data = im.jpeg_bytes(card)
    assert data == im.jpeg_bytes(cpu)
    got = im.decode_jpeg(data, dev)
    assert got.device.type == "cuda" and got.dtype == torch.uint8
    assert torch.equal(got.cpu(), im.decode_jpeg(data, "cpu"))


def test_png_round_trip_on_the_card(dev, tmp_path):
    rgb = torch.from_numpy(frame(480, 640, seed=1)).to(dev)
    im.imwrite(tmp_path / "f.png", rgb)
    back = im.imread(tmp_path / "f.png", dev)
    assert back.device.type == "cuda" and torch.equal(back, rgb)
