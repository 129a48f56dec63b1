"""The engine's serving ingest on the card against the same code on the CPU.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX (tests/conftest.py does, hence
``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_modes_cuda.py

- ``i420_to_rgb_device`` on the card equals the CPU's bit for bit (every
  (Y, U, V) triple; the CPU's equals the JAX program's,
  tests/test_torch_ingest.py);
- ``to_device``'s transfers (RGB, split RGB in one buffer, I420) give the
  CPU engine's frames bit for bit;
- ``pack_output``/``unpack_output`` round-trip card tensors to
  ``_to_numpy``'s tree bit for bit;
- a default engine (``device=None``) takes its own ``to_device`` output
  (the packed tensor, the split dict) as it is, and gives the host path's
  outputs bit for bit;
- the tiny engine with trained pose (full and split ingest) and with a
  SAM at ViT-H's head dim 80, card against CPU (``chip_smoke.py``'s
  ``check_small_engine``, with its gates).
"""
import numpy as np
import pytest
import torch

from lameness_tpu_torch.pipeline.engine import (EngineSpec, LamenessEngine,
                                                _to_numpy, make_test_engine)
from lameness_tpu_torch.video.yuv import i420_to_rgb_device, rgb_to_i420

pytestmark = pytest.mark.cuda

SPEC = dict(clip_frames=15, frame_height=90, frame_width=160, fps=5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card path runs only there")
    return torch.device("cuda")


def _every_triple():
    """I420 frames (64, 768, 512): every (U, V) pair, each with every Y."""
    uu, vv = np.meshgrid(np.arange(256, dtype=np.uint8),
                         np.arange(256, dtype=np.uint8), indexing="ij")
    out = []
    for k in range(64):
        y = np.empty((512, 512), np.uint8)
        for i, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            y[dy::2, dx::2] = 4 * k + i
        out.append(np.concatenate([y.ravel(), uu.ravel(), vv.ravel()]
                                  ).reshape(768, 512))
    return np.stack(out)


@pytest.mark.parametrize("case", ["every_triple", "odd_half_height"])
def test_i420_to_rgb_card_equals_cpu(dev, case):
    if case == "every_triple":
        yuv = _every_triple()
    else:                 # 45 chroma rows: the planes straddle buffer rows
        rgb = np.random.default_rng(7).integers(0, 256, (2, 3, 90, 160, 3),
                                                dtype=np.uint8)
        yuv = rgb_to_i420(rgb)
    cpu = i420_to_rgb_device(torch.from_numpy(yuv))
    card = i420_to_rgb_device(torch.from_numpy(yuv).to(dev))
    assert card.device.type == "cuda"
    assert torch.equal(card.cpu(), cpu)


@pytest.mark.parametrize("transfer,split", [("rgb", False), ("rgb", True),
                                            ("yuv420", False),
                                            ("yuv420", True)])
def test_to_device_card_equals_cpu(dev, transfer, split):
    kw = dict(SPEC, lo_height=46, lo_width=80) if split else SPEC
    frames = np.random.default_rng(1).integers(0, 256, (2, 15, 90, 160, 3),
                                               dtype=np.uint8)
    got, want = (LamenessEngine(spec=EngineSpec(pose_pixels=False, **kw),
                                device=d, init_models=False).to_device(
                                    frames, transfer) for d in (dev, "cpu"))
    if not split:
        got, want = {"": got}, {"": want}
    assert set(got) == set(want)
    for key in want:
        assert got[key].device.type == "cuda"
        assert torch.equal(got[key].cpu(), want[key]), key


def test_pack_output_round_trip_on_the_card(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    out = {"a": torch.randn(2, 3, generator=g, device=dev
                            ).to(torch.bfloat16),
           "m": torch.rand(2, 11, 64, 64, generator=g, device=dev) > 0.5,
           "i": torch.randint(-9, 9, (2, 11, 8), generator=g, device=dev),
           "loco": {"x": torch.randn(2, generator=g, device=dev)},
           "f": torch.randn(3, 2, generator=g, device=dev)[:, 0]}
    eng = LamenessEngine(spec=EngineSpec(use_sam_model=False), device=dev,
                         init_models=False)
    flat, meta = eng.pack_output(out)
    assert flat.device.type == "cuda" and flat.dtype == torch.uint8
    got = eng.unpack_output(eng._fetch(flat), meta)
    want = _to_numpy(out)
    assert list(got) == list(want)
    for key in ("a", "m", "i", "f"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(got["loco"]["x"], want["loco"]["x"])


@pytest.mark.parametrize("split", [False, True])
def test_default_engine_passes_its_device_frames_through(dev, split):
    eng = make_test_engine(with_sam=True)
    assert eng.device == torch.device("cuda", torch.cuda.current_device())
    if split:
        eng = eng.with_spec(EngineSpec(**SPEC, yolo_size=64, pose_size=64,
                                       dino_size=56, sam_size=128,
                                       sam_mask_size=64, lo_height=46,
                                       lo_width=80))
    frames = np.random.default_rng(2).integers(0, 256, (2, 15, 90, 160, 3),
                                               dtype=np.uint8)
    frames_dev = eng.to_device(frames)

    def no_transfer(*args, **kwargs):
        raise AssertionError("device frames went through to_device again")
    eng.to_device = no_transfer
    got = eng.process_clip_batch(frames_dev)
    del eng.to_device
    want = eng.process_clip_batch(frames)
    assert list(got) == list(want)
    for key, val in want.items():
        if isinstance(val, dict):
            for k, v in val.items():
                np.testing.assert_array_equal(got[key][k], v, err_msg=k)
        else:
            assert got[key].dtype == val.dtype, key
            np.testing.assert_array_equal(got[key], val, err_msg=key)


@pytest.mark.parametrize("case", ["pose", "pose_split", "sam_hd80"])
def test_small_engine_card_equals_cpu(dev, case, monkeypatch):
    import chip_smoke
    # f32 products in f32, as chip_smoke.py sets them (cuDNN's default
    # TF32 convolutions move the detections by 1e-3)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    if case == "sam_hd80":
        assert chip_smoke.check_small_engine(sam=chip_smoke.HD80_SAM)
    else:
        split = {"lo_height": 45, "lo_width": 80} if case == "pose_split" \
            else None
        assert chip_smoke.check_small_engine(split, pose=True)
