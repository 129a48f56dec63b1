"""The port's mesh train step (``lameness_tpu_torch/pipeline/train.py``,
``parallel/fsdp.py``, ``head_training.train_heads(mesh=)``) on the CPU.

- One step of ``make_train_step`` against the JAX package's, unsharded,
  from the same weights (JAX's init carried across by
  ``weights.from_jax_params``), the sequence heads with dropout 0 on both
  sides as in tests/test_torch_training.py, and that file's tolerances:
  the first step's loss within 1e-5 relative, the second's within 2e-4,
  the parameters after two steps with 90% of the elements within 2% of a
  step and every element within 4·lr.
- The port's dp 2 x tp 2 step with FSDP against its own one-device step,
  dropout on (each data shard draws its rows of the whole batch's masks):
  the losses of three steps within 1e-5 relative; the parameters, gathered,
  against the one-device step's by the rule above (the gradients sum in
  another order, and Adam moves an element whose gradient is zero but for
  rounding by up to a step).  The FSDP layout: some leaf split
  over data, the AdamW moments laid out as their parameter shards, and
  every shard still on its position's device after each step; a state of
  another layout refused by the pinned step; a foreign optimiser state
  refused by ``shard_train_state_fsdp``.
- DINO's tensor-parallel forward: two positions within 1e-6 of the
  module's forward (which is ``forward_tp`` over one position).
- ``train_heads(mesh=)`` over a 2-position data axis: the loss history
  within 1e-5 relative of the unsharded run's, the checkpoints by the
  parameter rule above (lr 1e-3); also over ``cpu`` and ``cpu:0``, which
  compare unequal, so the second position holds copies of the heads.
- Distinct copies: a mesh of one device shares a replicated tensor between
  data rows, so the FSDP step is also run with the second row's shared
  tensors cloned, as distinct cards hold them: the optimiser's all-reduce
  sums their gradients, the step equals the one-device step by the rules
  above and the copies stay equal bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lameness_tpu.models.gait_transformer import GaitTransformer as JGait
from lameness_tpu.models.tcn import TCN as JTCN
from lameness_tpu.parallel import mesh as jmesh
from lameness_tpu.pipeline import train as jtrain
from lameness_tpu_torch.models import dino as dino_mod
from lameness_tpu_torch.models.gait_transformer import GaitTransformer
from lameness_tpu_torch.models.tcn import TCN
from lameness_tpu_torch.parallel.fsdp import (shard_train_state_fsdp,
                                              state_shardings)
from lameness_tpu_torch.parallel.mesh import (DATA_AXIS, leaves, make_mesh,
                                              replica_groups)
from lameness_tpu_torch.pipeline import head_training as tht
from lameness_tpu_torch.pipeline import train as T
from lameness_tpu_torch.weights import from_jax_params
from tests.test_torch_training import LOSS_RTOL, _assert_close

CPU = torch.device("cpu")
LR = 1e-4
BATCH = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: small tensor ops, test workers sharing cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _gathered(state):
    """{"dino.<key>": numpy} of the whole parameters."""
    return {f"{name}.{k}": v.full().detach().numpy()
            for name, sub in state.params.items() for k, v in sub.items()}


def test_train_step_matches_jax():
    jdino, _, _ = jtrain.make_models()
    jmodels = (jdino, JTCN(input_dim=44, dropout=0.0),
               JGait(input_dim=44, dropout=0.0))
    jm = jmesh.make_mesh(1)
    jstate, jtx = jtrain.init_train_state(jax.random.PRNGKey(0), jm, jmodels)
    jstep, _ = jtrain.make_train_step(jm, jmodels, jtx)
    dino, _, _ = T.make_models(device="cpu")
    models = (dino, TCN(input_dim=44, dropout=0.0, device="cpu"),
              GaitTransformer(input_dim=44, dropout=0.0, device="cpu"))
    sd = from_jax_params(_np(jstate.params))
    for name, m in zip(("dino", "tcn", "gait"), models):
        m.load_state_dict(sd[name])
    mesh = make_mesh(1, devices=[CPU])
    state, tx = T.init_train_state(None, mesh, models)
    step, _ = T.make_train_step(mesh, models, tx)
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(1)
    for rtol in LOSS_RTOL:
        batch = T.make_batch(rng, BATCH)
        key, sub = jax.random.split(key)
        with jm:
            jstate, jloss, jmet = jstep(
                jstate, {k: jnp.asarray(v) for k, v in batch.items()}, sub)
        state, loss, met = step(state, batch, None)
        assert loss.item() == pytest.approx(float(jloss), rel=rtol)
        for k in met:
            assert met[k].item() == pytest.approx(float(jmet[k]), rel=rtol)
    want = {f"{n}.{k}": v.numpy() for n, sub in
            from_jax_params(_np(jstate.params)).items()
            for k, v in sub.items()}
    _assert_close(_gathered(state), want, LR)
    assert state.step == 2


def _tp_spec(path, leaf):
    return T._dino_param_spec(path[1:], leaf) if path[0] == "dino" else None


def _distinct_copies(state, tx):
    """``state`` with each data row past the first holding its own copy of
    every tensor it shares with the first row, as distinct cards hold
    them (a mesh of one device shares them), and the optimiser rebuilt
    over them: its all-reduce then has groups to sum."""
    for leaf in leaves(state.params):
        first = {id(t) for t in leaf.shards[0].flat}
        copies = {}
        for pos in leaf.mesh.positions():
            t = leaf.shards[pos]
            if pos[0] > 0 and id(t) in first:
                leaf.shards[pos] = copies.setdefault(
                    (pos[0], id(t)), t.detach().clone().requires_grad_())
    opt = tx([t for leaf in leaves(state.params) for t in leaf.tensors()],
             replicas=replica_groups(state.params))
    return T.TrainState(state.params, opt, state.step)


def _run(mesh, fsdp: bool, steps: int, copies: bool = False):
    models = T.make_models(device="cpu")
    state, tx = T.init_train_state(torch.Generator().manual_seed(0), mesh,
                                   models)
    pinned = None
    if fsdp:
        state = shard_train_state_fsdp(state, mesh, tp_spec=_tp_spec,
                                       min_size=256)
    if copies:
        state = _distinct_copies(state, tx)
        assert state.opt_state.replicas
    if fsdp:
        pinned = state_shardings(state)
    step, batch_sh = T.make_train_step(mesh, models, tx,
                                       state_shardings=pinned)
    rng, gen = np.random.default_rng(0), torch.Generator().manual_seed(1)
    losses = []
    for _ in range(steps):
        state, loss, _ = step(state, T.make_batch(rng, BATCH), gen)
        losses.append(loss.item())
        if fsdp:
            _assert_layout(state, mesh)
        for group in state.opt_state.replicas:
            assert all(torch.equal(t, group[0]) for t in group[1:])
    return losses, state, (step, models)


def _assert_layout(state, mesh):
    """Every shard on its position's device, each AdamW moment laid out as
    its parameter shard."""
    adam = state.opt_state.adamw.state
    for leaf in leaves(state.params):
        for pos in mesh.positions():
            t = leaf.shards[pos]
            assert t.device == mesh.devices[pos]
            for key in ("exp_avg", "exp_avg_sq"):
                m = adam[t][key]
                assert m.shape == t.shape and m.device == t.device


def test_fsdp_step_matches_one_device():
    steps = 3
    want, one, _ = _run(make_mesh(1, devices=[CPU]), False, steps)
    mesh = make_mesh(4, model_parallel=2, devices=[CPU] * 4)
    got, state, (step, models) = _run(mesh, True, steps)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_close(_gathered(state), _gathered(one), LR)
    sharded = [l for l in leaves(state.params) if DATA_AXIS in l.spec]
    assert sharded, "no leaf picked up the data axis"
    big = max(sharded, key=lambda l: np.prod(l.shape))
    assert big.shards[0, 0].numel() * 2 <= np.prod(big.shape)
    # the pinned step refuses a state of another layout
    other, _ = T.init_train_state(None, mesh, models)
    with pytest.raises(ValueError, match="state_shardings"):
        step(other, T.make_batch(np.random.default_rng(1), BATCH), None)


def test_fsdp_step_with_distinct_copies_matches_one_device():
    """The dp 2 x tp 2 FSDP step with the second data row's replicated
    tensors distinct copies: the gradients of each parameter's copies are
    summed into every copy (the all-reduce), so the step still equals the
    one-device step (losses 1e-5, parameters by the rule above) and the
    copies stay equal bit for bit after every step."""
    steps = 3
    want, one, _ = _run(make_mesh(1, devices=[CPU]), False, steps)
    mesh = make_mesh(4, model_parallel=2, devices=[CPU] * 4)
    got, state, _ = _run(mesh, True, steps, copies=True)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_close(_gathered(state), _gathered(one), LR)


def test_fsdp_refuses_a_foreign_optimiser_state():
    mesh = make_mesh(2, devices=[CPU] * 2)
    models = T.make_models(device="cpu")
    state, tx = T.init_train_state(torch.Generator().manual_seed(0), mesh,
                                   models)
    step, _ = T.make_train_step(mesh, models, tx)
    state, _, _ = step(state, T.make_batch(np.random.default_rng(0), 2),
                       None)
    t = leaves(state.params)[0].shards[0, 0]
    state.opt_state.adamw.state[t]["other"] = torch.zeros(3)
    with pytest.raises(TypeError, match="placed"):
        shard_train_state_fsdp(state, mesh, min_size=256)


def test_dino_forward_tp_matches_module():
    dino = dino_mod.DinoV2(hidden_size=64, num_layers=2, num_heads=4,
                           patch_size=14, pos_grid=4, ls_init=0.5,
                           device="cpu")
    from lameness_tpu_torch.weights import seeded_state_dict
    dino.load_state_dict(seeded_state_dict(dino,
                                           torch.Generator().manual_seed(3)))
    sd = dino.state_dict()
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 70, 56, 3)).astype(np.float32))
    from lameness_tpu_torch.parallel.mesh import shard_params_tp
    with torch.no_grad():
        want = dino(x)["pooled"]
        shards = shard_params_tp(make_mesh(2, model_parallel=2,
                                           devices=[CPU] * 2),
                                 {"dino": sd})["dino"]
        two = dino_mod.forward_tp(
            dino, lambda k, m: shards[k].shards[0, m], x, [CPU] * 2)
    np.testing.assert_allclose(two["pooled"].numpy(), want.numpy(),
                               atol=1e-6, rtol=0)
    assert shards["block0.attn.query.weight"].shards[0, 1].shape == (32, 64)
    assert shards["block0.attn.out.weight"].shards[0, 1].shape == (64, 32)


def _heads_dataset(n=8):
    rng = np.random.default_rng(9)
    return {"features": rng.standard_normal((n, 125, 44)).astype(np.float32),
            "masks": rng.random((n, 125)) < 0.1,
            "labels": np.asarray([0, 1] * (n // 2), np.float32),
            "video_ids": [f"v{i}" for i in range(n)]}


def test_train_heads_mesh_matches_unsharded(tmp_path):
    """Batches of 4 and a trailing 2 (both split over the data axis)."""
    _heads_mesh_matches_unsharded(tmp_path, [CPU] * 2)


def test_train_heads_mesh_copies_match_unsharded(tmp_path):
    """The same over a data axis of ``cpu`` and ``cpu:0``: devices that
    compare unequal, so ``train_heads`` deep-copies the heads onto the
    second position, as onto a second card, and the optimiser sums each
    parameter's two gradients (the all-reduce) and clips their global norm
    with each parameter counted once."""
    _heads_mesh_matches_unsharded(tmp_path, [CPU, torch.device("cpu", 0)])


def _heads_mesh_matches_unsharded(tmp_path, devices):
    data = _heads_dataset(10)
    want = tht.train_heads(None, tmp_path / "a", epochs=2, batch_size=4,
                           dataset=data, device="cpu")
    got = tht.train_heads(None, tmp_path / "b", epochs=2, batch_size=4,
                          dataset=data, device="cpu",
                          mesh=make_mesh(2, devices=devices))
    np.testing.assert_allclose(got["loss_history"], want["loss_history"],
                               rtol=1e-5)
    from lameness_tpu_torch.pipeline.checkpoint import load_params
    for name in ("tcn", "gait"):
        a = load_params(tmp_path / "a", name)
        b = load_params(tmp_path / "b", name)
        _assert_close({k: v.numpy() for k, v in b.items()},
                      {k: v.numpy() for k, v in a.items()}, 1e-3)
