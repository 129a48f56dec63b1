"""The mesh on the card (meshes of repeated ``cuda:0`` entries).

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX (tests/conftest.py does, hence
``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_cuda.py

- the tiny engine (with SAM) over a dp-2 mesh at B = 4: every output bit
  for bit the unsharded engine run on each half alone with the same
  generator state (RGB and yuv420 transfer), K1 and K2 launched in each
  shard (its 8x8 global grid takes the window kernel);
- the train step (small widths) over dp 2 x tp 2 with FSDP: every shard and
  its AdamW moments on its position's device after each step, the pinned
  layout kept, and the losses within 1e-5 relative of the one-device step's;
- ``Overlap.fetch`` copying a tensor of another device (a host tensor
  stands in) beside its own device's, both equal to their sources.
"""
import numpy as np
import pytest
import torch

from lameness_tpu_torch.ops._cuda import KERNELS
from lameness_tpu_torch.parallel.fsdp import (shard_train_state_fsdp,
                                              state_shardings)
from lameness_tpu_torch.parallel.mesh import DATA_AXIS, leaves, make_mesh
from lameness_tpu_torch.pipeline import train as T
from lameness_tpu_torch.pipeline.engine import _flat_items, make_test_engine

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card path runs only there")
    return torch.device("cuda", 0)


def _mesh(dev, dp, tp=1):
    return make_mesh(dp * tp, model_parallel=tp, devices=[dev] * (dp * tp))


def _gen(dev):
    return torch.Generator(device=dev).manual_seed(0)


@pytest.mark.parametrize("transfer", ["rgb", "yuv420"])
def test_dp2_engine_equals_each_half(dev, transfer):
    eng = make_test_engine(device=dev, with_sam=True)
    frames = np.random.default_rng(0).integers(0, 256, (4, 15, 90, 160, 3),
                                               dtype=np.uint8)
    halves = [dict(_flat_items(eng.process_clip_batch(
        frames[i:i + 2], _gen(dev), transfer=transfer))) for i in (0, 2)]
    m = eng.with_spec(eng.spec)
    m.shard_inference(_mesh(dev, 2))
    for k in KERNELS.values():
        k.launches = 0
    got = dict(_flat_items(m.process_clip_batch(frames, _gen(dev),
                                                transfer=transfer)))
    torch.cuda.synchronize()
    assert set(got) == set(halves[0])
    for key, val in got.items():
        np.testing.assert_array_equal(
            val, np.concatenate([h[key] for h in halves]), err_msg=str(key))
    # each shard launches the same kernels (the tiny SAM's 8x8 global grid
    # takes the window kernel)
    counts = {name: k.launches for name, k in KERNELS.items()}
    assert counts["attention"] > 0 and counts["sam_window_attention_v3"] > 0
    assert all(n % 2 == 0 for n in counts.values()), counts


def test_fsdp_step_keeps_its_layout(dev):
    def run(mesh, fsdp):
        models = T.make_models(device=dev)
        state, tx = T.init_train_state(torch.Generator().manual_seed(0),
                                       mesh, models)
        pinned = None
        if fsdp:
            state = shard_train_state_fsdp(state, mesh, min_size=256,
                                           tp_spec=lambda p, l: T.
                                           _dino_param_spec(p[1:], l)
                                           if p[0] == "dino" else None)
            pinned = state_shardings(state)
        step, _ = T.make_train_step(mesh, models, tx, state_shardings=pinned)
        rng, g = np.random.default_rng(0), _gen(dev)
        losses = []
        for _ in range(2):
            state, loss, _ = step(state, T.make_batch(rng, 4), g)
            losses.append(loss.item())
            adam = state.opt_state.adamw.state
            for leaf in leaves(state.params):
                for pos in mesh.positions():
                    t = leaf.shards[pos]
                    assert t.device == mesh.devices[pos]
                    assert adam[t]["exp_avg"].shape == t.shape
                    assert adam[t]["exp_avg"].device == t.device
        return losses, state
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want, _ = run(_mesh(dev, 1), False)
        got, state = run(_mesh(dev, 2, 2), True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert any(DATA_AXIS in leaf.spec for leaf in leaves(state.params))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_fetch_copies_a_tensor_of_another_device(dev):
    """``Overlap.fetch`` over a mesh: a tensor that is not on the lanes'
    device (on a machine of several cards, another card's shard) is copied
    to the host blocking, beside the lanes' own non-blocking copies.  The
    one card stands in a host tensor for the other device."""
    from lameness_tpu_torch.core.streams import Overlap
    ours = torch.arange(12, device=dev, dtype=torch.float32) * 2
    other = torch.arange(5, dtype=torch.int32)
    got = Overlap(dev).fetch([ours, other])()
    np.testing.assert_array_equal(got[0], ours.cpu().numpy())
    np.testing.assert_array_equal(got[1], other.numpy())
