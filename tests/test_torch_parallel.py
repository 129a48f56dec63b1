"""The port's sequence, pipeline, SAM, ensemble and FSDP-spec helpers
(``lameness_tpu_torch/parallel/``) against the JAX package on the CPU.

The JAX side runs its sharded functions over the 8 virtual CPU devices of
tests/conftest.py; the port's meshes repeat ``torch.device("cpu")``.  Inputs
are float32, made from a seed with numpy.

- ``ring_attention`` against JAX's ``ring_attention`` at the (devices,
  sequence) cases of tests/test_ring_attention.py: within 2e-5 (both sum in
  float32 in other orders; JAX's own test holds it to full attention within
  2e-4);
- ``pipeline_apply`` against JAX's at the (stages, microbatches) cases of
  tests/test_pipeline_parallel.py: within 1e-5; and equal bit for bit to
  ``sequential_reference`` on each microbatch;
- ``sam_ring_attention`` against JAX's ``sam_attention_reference`` (8x8
  grid over 4 positions, nonzero tables): within 1e-5, JAX's own bound;
- ``sam_encoder_pipeline`` (depth 8, [window, global] repeating, 4 stages
  of 2, 2 microbatches) against JAX's plain encoder: within 2e-4, JAX's
  own bound;
- ``mc_dropout_sharded``: 8 TCN samples over 4 positions bit for bit the
  stack on one position, and spread (std > 0);
- ``fsdp_leaf_spec`` equal to JAX's on the cases of tests/test_fsdp.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lameness_tpu.models.sam import SamVisionEncoder as JEncoder
from lameness_tpu.ops.attention import reference_attention as jref_attention
from lameness_tpu.ops.sam_attention import (
    project_rel_tables as jproject, sam_attention_reference as jsam_ref)
from lameness_tpu.parallel import fsdp as jfsdp
from lameness_tpu.parallel import pipeline_parallel as jpp
from lameness_tpu.parallel import ring_attention as jring
from lameness_tpu_torch.models.sam import SamVisionEncoder
from lameness_tpu_torch.models.tcn import TCN
from lameness_tpu_torch.ops.sam_attention import project_rel_tables
from lameness_tpu_torch.parallel.ensemble_parallel import (
    make_ensemble_mesh, mc_dropout_sharded)
from lameness_tpu_torch.parallel.fsdp import fsdp_leaf_spec
from lameness_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, P
from lameness_tpu_torch.parallel.pipeline_parallel import (
    make_stage_mesh, pipeline_apply, sequential_reference,
    stack_stage_params)
from lameness_tpu_torch.parallel.ring_attention import (make_seq_mesh,
                                                         ring_attention)
from lameness_tpu_torch.parallel.sam_parallel import (encoder_stages,
                                                      sam_encoder_pipeline,
                                                      sam_ring_attention)
from lameness_tpu_torch.weights import from_jax_params

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: small tensor ops, test workers sharing cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n_dev,s", [(4, 64), (8, 64), (2, 32)])
def test_ring_attention_matches_jax(n_dev, s):
    rng = np.random.default_rng(n_dev * 100 + s)
    q, k, v = (rng.standard_normal((2, 3, s, 16)).astype(np.float32)
               for _ in range(3))
    want = jring.ring_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jring.make_seq_mesh(n_dev))
    got = ring_attention(*map(torch.from_numpy, (q, k, v)),
                         make_seq_mesh(n_dev, devices=[CPU] * n_dev))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    full = jref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(full), atol=2e-5,
                               rtol=0)


def _stage_params(rng, d, n_stages):
    return [{"w1": rng.standard_normal((d, d)).astype(np.float32) * 0.2,
             "b1": rng.standard_normal(d).astype(np.float32) * 0.1,
             "w2": rng.standard_normal((d, d)).astype(np.float32) * 0.2,
             "b2": rng.standard_normal(d).astype(np.float32) * 0.1}
            for _ in range(n_stages)]


def _jmlp(p, x):
    return jnp.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def _tmlp(p, x):
    return torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


@pytest.mark.parametrize("n_stages,n_micro", [(4, 4), (4, 8), (8, 4),
                                              (2, 6)])
def test_pipeline_apply_matches_jax(n_stages, n_micro):
    rng = np.random.default_rng(n_stages * 10 + n_micro)
    d, b = 16, n_micro * 3
    per_stage = _stage_params(rng, d, n_stages)
    x = rng.standard_normal((b, d)).astype(np.float32)
    jstacked = jpp.stack_stage_params(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in per_stage])
    want = jpp.pipeline_apply(_jmlp, jstacked, jnp.asarray(x),
                              jpp.make_stage_mesh(n_stages), n_micro)
    tper = [{k: torch.from_numpy(v) for k, v in p.items()}
            for p in per_stage]
    xt = torch.from_numpy(x)
    got = pipeline_apply(_tmlp, stack_stage_params(tper), xt,
                         make_stage_mesh(n_stages, devices=[CPU] * n_stages),
                         n_micro)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    seq = torch.cat([sequential_reference(_tmlp, tper, mb)
                     for mb in xt.chunk(n_micro)])
    assert torch.equal(got, seq)


def test_sam_ring_attention_matches_jax_reference():
    rng = np.random.default_rng(3)
    g, d, bh = 8, 16, 6                  # 64 tokens over 4 positions
    q, k, v = (rng.standard_normal((bh, g * g, d)).astype(np.float32)
               for _ in range(3))
    rel_h = (rng.standard_normal((2 * g - 1, d)) * 0.2).astype(np.float32)
    rel_w = (rng.standard_normal((2 * g - 1, d)) * 0.2).astype(np.float32)
    jrh, jrw = jproject(jnp.asarray(q), jnp.asarray(rel_h),
                        jnp.asarray(rel_w), g)
    want = jsam_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jrh, jrw)
    qt = torch.from_numpy(q)
    rh, rw = project_rel_tables(qt, torch.from_numpy(rel_h),
                                torch.from_numpy(rel_w), g)
    np.testing.assert_allclose(rh.numpy(), np.asarray(jrh), atol=1e-5)
    got = sam_ring_attention(qt, torch.from_numpy(k), torch.from_numpy(v),
                             rh, rw, make_seq_mesh(4, devices=[CPU] * 4))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


ENC = dict(img_size=64, patch_size=16, dim=32, depth=8, heads=4,
           mlp_ratio=2.0, out_chans=16, window_size=2,
           global_attn_indexes=(1, 3, 5, 7))


def test_sam_encoder_pipeline_matches_jax():
    """tests/test_sam_parallel.py's geometry: 4 stages x [window, global],
    2 microbatches of 2 images; nonzero rel-pos tables."""
    rng = np.random.default_rng(4)
    imgs = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    jenc = JEncoder(**ENC)
    params = jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.asarray(imgs))
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 if a.ndim == 2 else a, params)
    want = jax.jit(jenc.apply)(params, jnp.asarray(imgs))
    enc = SamVisionEncoder(**ENC)
    enc.load_state_dict(from_jax_params(
        {"e": jax.tree_util.tree_map(np.asarray, params)})["e"])
    x = torch.from_numpy(imgs)
    mesh = make_stage_mesh(4, devices=[CPU] * 4)
    with torch.no_grad():
        got = sam_encoder_pipeline(enc, None, x, mesh, num_microbatches=2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                                   rtol=2e-4)
        stage_fn, per_stage = encoder_stages(enc, 4)
        seq = torch.cat([enc.neck(sequential_reference(
            stage_fn, per_stage, enc.embed(mb))) for mb in x.chunk(2)])
    assert torch.equal(got, seq)
    with pytest.raises(ValueError, match="not uniform"):
        encoder_stages(enc, 8)


def test_mc_dropout_sharded_equals_unsharded():
    tcn = TCN(channels=(8, 8), kernel_size=3, input_dim=44, device="cpu")
    feats = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 125, 44)).astype(np.float32))

    def one(g):
        with torch.no_grad():
            return tcn(feats.to(g.device), generator=g)
    sharded = mc_dropout_sharded(one, make_ensemble_mesh(4, [CPU] * 4),
                                 torch.Generator().manual_seed(42), 8)
    alone = mc_dropout_sharded(one, make_ensemble_mesh(1, [CPU]),
                               torch.Generator().manual_seed(42), 8)
    assert sharded.shape == (8, 2, 1)
    assert [s.shape[0] for s in sharded.shards.flat] == [2, 2, 2, 2]
    full = sharded.full()
    assert torch.equal(full, alone.full())
    assert float(full.std(dim=0).max()) > 0
    with pytest.raises(ValueError, match="multiple"):
        mc_dropout_sharded(one, make_ensemble_mesh(4, [CPU] * 4),
                           torch.Generator(), 6)


class _L:
    def __init__(self, shape):
        self.shape = shape


FSDP_CASES = [
    ((32, 64), 4, None, 1024), ((64,), 4, None, 1024),
    ((33, 35), 4, None, 1), ((64, 64), 4, (None, MODEL_AXIS), 1),
    ((33, 64), 4, (None, MODEL_AXIS), 1),
    ((64, 64), 4, (DATA_AXIS, MODEL_AXIS), 1),
    ((64, 64), 4, ((DATA_AXIS, MODEL_AXIS),), 1),
    ((3, 8, 8), 2, None, 16), ((), 2, None, 1)]


@pytest.mark.parametrize("shape,dp,base,min_size", FSDP_CASES)
def test_fsdp_leaf_spec_matches_jax(shape, dp, base, min_size):
    from jax.sharding import PartitionSpec as JP
    want = jfsdp.fsdp_leaf_spec(_L(shape), dp, None if base is None
                                else JP(*base), min_size=min_size)
    got = fsdp_leaf_spec(_L(shape), dp, None if base is None else P(*base),
                         min_size=min_size)
    assert tuple(got) == tuple(want)
