"""The engine's captured modes on the card (``process_clip_batch(mode=)``:
``pair`` two CUDA graphs, ``monolith`` one).

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX (tests/conftest.py does, hence
``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_engine_modes_cuda.py

On the tiny engine with SAM (f32, MC dropout on):
- pair and monolith equal staged bit for bit (RGB and yuv420 transfer), a
  second call with the same generator equals a second staged call, and the
  generator ends where staged leaves it;
- the graphs replay: each call adds to ``KERNELS`` the launches recorded
  in the capture, which equal a staged call's, and the capture itself
  adds none;
- a weight install drops the graphs (this engine's and a ``with_spec``
  engine's over the same modules): the next call captures anew and equals
  staged with the new weights;
- a ``readback=False`` tree is a copy: the next call leaves it as it was.
"""
import numpy as np
import pytest
import torch

from lameness_tpu_torch.ops._cuda import KERNELS
from lameness_tpu_torch.pipeline.engine import _flat_items, make_test_engine

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card path runs only there")
    return torch.device("cuda", 0)


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


def _frames(seed=0, b=2):
    return np.random.default_rng(seed).integers(0, 256, (b, 15, 90, 160, 3),
                                                dtype=np.uint8)


def _equal(got, want):
    got, want = dict(_flat_items(got)), dict(_flat_items(want))
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_array_equal(got[key], w, err_msg=str(key))


def _counts():
    return {name: k.launches for name, k in KERNELS.items()}


@pytest.mark.parametrize("mode", ["pair", "monolith"])
@pytest.mark.parametrize("transfer", ["rgb", "yuv420"])
def test_captured_modes_equal_staged(dev, mode, transfer):
    eng = make_test_engine(device=dev, with_sam=True)
    frames = _frames()
    g_staged, g_mode = _gen(dev, 3), _gen(dev, 3)
    for _ in range(2):
        want = eng.process_clip_batch(frames, g_staged, transfer=transfer)
        got = eng.process_clip_batch(frames, g_mode, mode=mode,
                                     transfer=transfer)
        _equal(got, want)
        assert torch.equal(g_mode.get_state(), g_staged.get_state())
    assert want["tcn_uncertainty"].min() > 0
    [cap] = eng._graphs.values()
    assert cap.mode == mode and len(cap.graphs) == (2 if mode == "pair"
                                                    else 1)


@pytest.mark.parametrize("mode", ["pair", "monolith"])
def test_replays_count_the_captured_launches(dev, mode):
    eng = make_test_engine(device=dev, with_sam=True)
    frames = eng.to_device(_frames())
    eng.process_clip_batch(frames)
    for k in KERNELS.values():
        k.launches = 0
    eng.process_clip_batch(frames)
    staged = _counts()
    assert staged["attention"] > 0 and staged["sam_window_attention_v3"] > 0
    assert set(eng.warmup(batch=2, mode=mode))
    [cap] = eng._graphs.values()
    assert cap.launches == {k: v for k, v in staged.items() if v}
    for k in KERNELS.values():
        k.launches = 0
    for calls in (1, 2):
        eng.process_clip_batch(frames, mode=mode)
        assert _counts() == {k: calls * v for k, v in staged.items()}


@pytest.mark.parametrize("mode", ["pair", "monolith"])
def test_weight_install_drops_the_graphs(dev, mode):
    from lameness_tpu_torch.weights import seeded_state_dict
    eng = make_test_engine(device=dev, with_sam=True)
    twin = eng.with_spec(eng.spec)
    frames = eng.to_device(_frames())
    before = eng.process_clip_batch(frames, mode=mode)
    twin.process_clip_batch(frames, mode=mode)
    assert len(eng._graphs) == len(twin._graphs) == 1
    eng.install_state_dict("dino", seeded_state_dict(
        eng.dino, torch.Generator().manual_seed(7)))
    assert not eng._graphs
    want = eng.process_clip_batch(frames)
    assert not np.array_equal(want["embeddings"], before["embeddings"])
    for e in (eng, twin):
        _equal(e.process_clip_batch(frames, mode=mode), want)
        assert len(e._graphs) == 1


@pytest.mark.parametrize("mode", ["pair", "monolith"])
def test_readback_false_survives_the_next_call(dev, mode):
    eng = make_test_engine(device=dev, with_sam=True)
    a, b = eng.to_device(_frames(0)), eng.to_device(_frames(1))
    held = eng.process_clip_batch(a, _gen(dev), mode=mode, readback=False)
    copy = {k: v.clone() for k, v in _flat_items(held)}
    eng.process_clip_batch(b, _gen(dev), mode=mode, readback=False)
    torch.cuda.synchronize()
    for key, v in _flat_items(held):
        assert torch.equal(v, copy[key]), key
    staged = eng.process_clip_batch(a, _gen(dev), readback=False)
    for key, v in _flat_items(staged):
        assert torch.equal(v, copy[key]), key
