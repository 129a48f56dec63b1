"""The serving stream and the curation detector on the card against the same
code on the CPU.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX (tests/conftest.py does, hence
``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_serve_cuda.py

- the tiny engine's ``process_stream`` on the card against its CPU path
  (``chip_smoke.py``'s ``check_small_stream``, with its gates);
- on the card, the stream's result files at ``batch_size=2`` equal those
  of ``process_clip_batch`` on the same 2-clip batches followed by the
  writer, byte for byte;
- ``BatchedYoloDetector`` on the card (f32, RGB and I420 transfer, chunks
  16 and 5) against the same detector on the CPU: the same ``None``
  pattern, bbox and centroid within 1e-3 px, confidence within 1e-5;
- the upload chain (``process_video_file`` of a written ``.y4m`` with the
  motion fallback, the tiny engine) on the card against its CPU path, and
  MOG2's masks card against CPU (``chip_smoke.py``'s ``check_small_chain``,
  with its gates); the card's ``i420_to_rgb`` and ``rgb_to_gray`` equal the
  CPU's over every input.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card path runs only there")
    # f32 products in f32, as chip_smoke.py sets them (cuDNN's default
    # TF32 convolutions move the detections by 1e-3)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


def test_small_stream_card_matches_cpu(dev):
    import chip_smoke
    assert chip_smoke.check_small_stream()


def test_stream_files_equal_serial_path(dev, tmp_path):
    import chip_smoke
    from lameness_tpu_torch.core.config import Config, DataDirs
    from lameness_tpu_torch.pipeline.engine import make_test_engine
    from lameness_tpu_torch.serve.driver import PipelineDriver
    rng = np.random.default_rng(0)
    clips = {f"c{i}.mp4": rng.integers(0, 256, (15, 90, 160, 3),
                                       dtype=np.uint8) for i in range(4)}
    jobs = [(n[:-4], Path(n)) for n in clips]
    eng = make_test_engine(device=dev, with_sam=True)
    drivers = [PipelineDriver(
        config=Config(dirs=DataDirs(root=str(tmp_path / tag))), engine=eng,
        reader=chip_smoke.MemoryReader(clips, fps=5))
        for tag in ("stream", "serial")]
    drivers[0].process_stream(jobs, batch_size=2)
    serial = drivers[1]
    for o in (0, 2):
        loaded = [serial._load_engine_frames(p) for _, p in jobs[o:o + 2]]
        out = eng.process_clip_batch(np.concatenate([f for f, _, _ in
                                                     loaded]))
        for bi, ((vid, _), (_, scale, info)) in enumerate(
                zip(jobs[o:o + 2], loaded)):
            serial._write_stage_results(vid, out, bi, scale, info)
    files = [{p.relative_to(d.dirs.results): p.read_bytes()
              for p in sorted(d.dirs.results.glob("*/*.json"))}
             for d in drivers]
    assert len(files[0]) == 6 * len(clips)
    assert files[0] == files[1]


def _frames(n=37):
    """Smooth seeded frames (bicubic 6x8 -> 72x96), as
    tests/test_curation_batched.py makes them with OpenCV."""
    base = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 255, (n, 3, 6, 8)).astype(np.float32))
    up = torch.nn.functional.interpolate(base, size=(72, 96),
                                         mode="bicubic", align_corners=False)
    return up.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("transfer,chunk", [("rgb", 16), ("yuv420", 16),
                                            ("rgb", 5)])
def test_detector_card_matches_cpu(dev, transfer, chunk):
    from lameness_tpu_torch.models.yolo import YoloV8
    from lameness_tpu_torch.video.curation import BatchedYoloDetector
    from lameness_tpu_torch.weights import seeded_state_dict
    cpu = YoloV8("n", num_classes=8, device="cpu")
    cpu.load_state_dict(seeded_state_dict(cpu, torch.Generator()
                                          .manual_seed(0)))
    gpu = YoloV8("n", num_classes=8, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    frames = _frames()
    kw = dict(conf=0.0, cow_class_id=2, size=64, chunk=chunk,
              transfer=transfer)
    card = BatchedYoloDetector(gpu.eval(), **kw)
    host = BatchedYoloDetector(cpu.eval(), **kw)
    got, want = card.detect_batch(frames), host.detect_batch(frames)
    assert card.dispatches == -(-len(frames) // chunk)
    assert [g is None for g in got] == [w is None for w in want]
    assert any(w is not None for w in want)
    for g, w in zip(got, want):
        if w is not None:
            np.testing.assert_allclose(g["bbox"], w["bbox"], atol=1e-3)
            np.testing.assert_allclose(g["centroid"], w["centroid"],
                                       atol=1e-3)
            np.testing.assert_allclose(g["confidence"], w["confidence"],
                                       atol=1e-5)


def test_upload_chain_card_matches_cpu(dev, tmp_path):
    import chip_smoke
    assert chip_smoke.check_small_chain(tmp_path)


def test_decoder_conversions_card_match_cpu(dev):
    """Every (Y, U, V) triple once (each chroma sample's 2x2 block holds
    four Y values, 64 blocks a (U, V) pair), every (R, G, B) once."""
    from lameness_tpu_torch.video.yuv import i420_to_rgb, rgb_to_gray
    h = w = 4096
    block = np.arange(h // 2 * w // 2)
    uv, sub = block // 64, block % 64
    ys = (sub[:, None] * 4 + np.arange(4)).astype(np.uint8)
    y = np.zeros((h, w), np.uint8)
    for k, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        y[dy::2, dx::2] = ys[:, k].reshape(h // 2, w // 2)
    planes = torch.from_numpy(np.concatenate(
        [y.ravel(), (uv // 256).astype(np.uint8),
         (uv % 256).astype(np.uint8)]).reshape(h * 3 // 2, w))
    assert torch.equal(i420_to_rgb(planes.to(dev)).cpu(), i420_to_rgb(planes))
    idx = torch.arange(1 << 24, dtype=torch.int64).reshape(h, w)
    rgb = torch.stack([idx >> 16, idx >> 8 & 255, idx & 255],
                      -1).to(torch.uint8)
    assert torch.equal(rgb_to_gray(rgb.to(dev)).cpu(), rgb_to_gray(rgb))
