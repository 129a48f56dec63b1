"""The mesh on the card (meshes of repeated ``cuda:0`` entries).

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX (tests/conftest.py does, hence
``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_cuda.py

- the tiny engine (with SAM) over a dp-2 mesh at B = 4 (RGB and yuv420
  transfer), at dropout 0 and with MC dropout on: every output bit for
  bit the unsharded engine on each half alone, fed that half's rows of the
  whole batch's dropout draws (``parallel/same_batch.py``; the libraries
  round a clip's floats differently at another batch size, so the whole
  batch's outputs are a printed difference, not the gate); the draws
  each shard consumes its rows of the unsharded run's bit for bit, and
  the generator left where the unsharded call leaves it; K1 and K2
  launched in each shard (its 8x8 global grid takes the window kernel);
  pair and monolith over the mesh bit for bit the sharded staged run;
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
from lameness_tpu_torch.parallel.same_batch import (batch_difference,
                                                    differing_leaves,
                                                    same_batch,
                                                    shard_draws_are_rows)
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


def _dropout0(eng):
    """``eng`` with dropout-0 heads holding its heads' weights."""
    from lameness_tpu_torch.models.gait_transformer import GaitTransformer
    from lameness_tpu_torch.models.tcn import TCN
    e = eng.with_spec(eng.spec)
    e.tcn = TCN(input_dim=44, dropout=0.0, device=eng.device)
    e.gait = GaitTransformer(input_dim=44, dropout=0.0, device=eng.device)
    e.load_state_dicts({"tcn": eng.tcn.state_dict(),
                        "gait": eng.gait.state_dict()})
    return e


@pytest.mark.parametrize("transfer", ["rgb", "yuv420"])
def test_dp2_engine_equals_each_half(dev, transfer, monkeypatch):
    """At dropout 0 and at MC dropout the sharded engine equals the
    unsharded engine on each half alone, fed the half's rows of the whole
    batch's draws, bit for bit (the module docstring)."""
    from lameness_tpu_torch.pipeline.train import RowDraws
    eng = make_test_engine(device=dev, with_sam=True)
    frames = np.random.default_rng(0).integers(0, 256, (4, 15, 90, 160, 3),
                                               dtype=np.uint8)
    shard_draws = []
    rand = RowDraws.rand

    def spy(self, shape, device):
        u = rand(self, shape, device)
        shard_draws.append((self.lo, self.hi, u))
        return u
    monkeypatch.setattr(RowDraws, "rand", spy)
    for heads in (_dropout0(eng), eng):
        m = heads.with_spec(heads.spec)
        m.shard_inference(_mesh(dev, 2))
        shard_draws.clear()
        for k in KERNELS.values():
            k.launches = 0
        g_shard, g_one = _gen(dev), _gen(dev)
        got = m.process_clip_batch(frames, g_shard, transfer=transfer)
        torch.cuda.synchronize()
        counts = {name: k.launches for name, k in KERNELS.items()}
        whole, halves, draws = same_batch(heads, frames, g_one, 2,
                                          transfer=transfer)
        assert differing_leaves(got, halves) == []
        assert torch.equal(g_shard.get_state(), g_one.get_state())
        assert (len(draws) > 0) == (heads is eng)
        if draws:
            assert shard_draws_are_rows(draws, shard_draws, 4, 2)
        print(f"batch-size difference, each half alone against the whole "
              f"batch: {batch_difference(halves, whole)}")
        # each shard launches the same kernels (the tiny SAM's 8x8 global
        # grid takes the window kernel)
        assert counts["attention"] > 0 \
            and counts["sam_window_attention_v3"] > 0
        assert all(c % 2 == 0 for c in counts.values()), counts


@pytest.mark.parametrize("mode", ["pair", "monolith"])
def test_dp2_captured_modes_equal_sharded_staged(dev, mode):
    eng = make_test_engine(device=dev, with_sam=True)
    frames = np.random.default_rng(0).integers(0, 256, (4, 15, 90, 160, 3),
                                               dtype=np.uint8)
    m = eng.with_spec(eng.spec)
    m.shard_inference(_mesh(dev, 2))
    g_staged, g_mode = _gen(dev), _gen(dev)
    for _ in range(2):
        want = dict(_flat_items(m.process_clip_batch(frames, g_staged)))
        got = dict(_flat_items(m.process_clip_batch(frames, g_mode,
                                                    mode=mode)))
        for key, w in want.items():
            np.testing.assert_array_equal(got[key], w, err_msg=str(key))
        assert torch.equal(g_mode.get_state(), g_staged.get_state())
    assert all(len(r._graphs) == 1 for r in m._replicas)


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
