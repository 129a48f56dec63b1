"""The analysis after the engine on the card against the same code on the
CPU: the graph heads and the device tracker, under the gates of
``chip_smoke.py`` phase 7.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX (tests/conftest.py does, hence
``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_graph_cuda.py

- ``GraphHeadRunner`` on written videos of 4 cows x 4 (the global and a
  per-cow graph, padded to 128 nodes): deterministic outputs within 1e-4,
  dropout-0 result files within 1e-4 with ids and neighbours equal, two
  MC-dropout runs equal with a std above 0;
- the device tracker on the scenarios of tests/test_device_tracker.py and
  over written yolo files: ids and states equal, boxes within 1e-4; the
  same confirmed tracks as the host ByteTracker on a walking block.
"""
import numpy as np
import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card path runs only there")
    # f32 products in f32, as chip_smoke.py sets them
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


def test_graph_heads_card_matches_cpu(dev, tmp_path):
    vids = chip_smoke.write_cow_videos(tmp_path, cows=4, per_cow=4)
    (tmp_path / "results" / "tracking" / f"{vids[-1]}_tracking.json"
     ).unlink()
    assert chip_smoke.graph_card_vs_cpu(
        tmp_path, {"global": vids[-1], "per_cow": vids[0]})


@pytest.mark.parametrize("seed", [3, 7])
def test_device_tracker_card_matches_cpu(dev, seed):
    from lameness_tpu_torch.track import device_tracker as dt
    rng = np.random.default_rng(seed)
    t, k = 40, 8
    boxes = np.zeros((2, t, k, 4), np.float32)
    scores = np.zeros((2, t, k), np.float32)
    valid = np.zeros((2, t, k), bool)
    for b in range(2):
        xs = rng.uniform(0, 540, 5)
        vx = rng.uniform(4, 9, 5) * rng.choice([-1, 1], 5)
        for i in range(t):
            for j in range(5):
                if rng.random() < 0.12:
                    continue
                x1 = xs[j] + vx[j] * i + rng.normal(0, 1.5)
                y1 = 70.0 * j + rng.normal(0, 1.5)
                boxes[b, i, j] = [x1, y1, x1 + 70, y1 + 55]
                scores[b, i, j] = 0.85 if rng.random() > 0.2 else 0.35
                valid[b, i, j] = True
    outs = {d: {k: v.cpu().numpy() for k, v in dt.track_clip_batch(
        boxes, scores, valid, max_tracks=16, device=d)[1].items()}
        for d in ("cuda", "cpu")}
    same, err = chip_smoke.tracker_outputs_close(outs["cuda"], outs["cpu"])
    assert same and err <= chip_smoke.BOX_TOL


def test_device_tracker_files_and_walking_block(dev, tmp_path):
    chip_smoke.write_cow_videos(tmp_path, cows=2, per_cow=2, tracking=False)
    block = [None] * 10 + [(10.0 + 13 * i, 200.0, 490.0 + 13 * i, 500.0)
                           for i in range(60)] + [None] * 20
    assert chip_smoke.device_tracker(tmp_path, block)
