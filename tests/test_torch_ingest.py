"""The port's serving ingest modes against the JAX engine, on the CPU.

- ``EngineSpec`` bookkeeping (packed rows, split ingest, ``pose_pixels``)
  index for index against the JAX spec;
- ``split_pack_host``: hi rows exact, lo rows within 1 of the JAX
  package's cv2 resize;
- I420: ``rgb_to_i420`` byte for byte cv2's (the JAX package's host
  converter), the device conversion bit for bit the JAX program's, over
  every (Y, U, V) triple;
- the tiny engine of tests/test_torch_engine.py under ``pose_pixels=False``
  and split ingest against the JAX engine (same seeded weights, the same
  host frames or dict), with that file's gates;
- the port's modes against its own default: ``pose_pixels=False`` and the
  ``yuv420`` transfer (on frames that went through I420 and back) give
  the same outputs bit for bit; the one-buffer readback gives
  ``_to_numpy``'s tree bit for bit.
"""
import numpy as np
import pytest
import torch

import jax

from lameness_tpu.pipeline import engine as jengine
from lameness_tpu.video import yuv as jyuv
from lameness_tpu_torch.pipeline import engine as tengine
from lameness_tpu_torch.pipeline.engine import EngineSpec, _to_numpy
from lameness_tpu_torch.video import yuv as tyuv
from tests.test_torch_engine import (_assert_gates, _jax_engine, _leaves,
                                     _port_engine)

# the tiny engine's geometry (tests/test_torch_engine.py)
TINY = dict(clip_frames=15, frame_height=90, frame_width=160, fps=5,
            yolo_size=64, pose_size=64, dino_size=56, use_sam_model=True,
            sam_size=128, sam_mask_size=64)
SPLIT = dict(lo_height=45, lo_width=80)


@pytest.fixture(scope="module")
def engines():
    jeng = _jax_engine()
    return jeng, _port_engine(jeng.params)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).integers(0, 256, (2, 15, 90, 160, 3),
                                             dtype=np.uint8)


def _gen():
    return torch.Generator().manual_seed(0)


def _equal_trees(a, b):
    a, b = dict(_leaves(a)), dict(_leaves(b))
    assert set(a) == set(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


SPEC_PROPS = ("det_idx", "dino_idx", "pose_idx", "packed_idx", "n_packed",
              "det_pos", "dino_pos", "pose_pos", "split", "hi_idx",
              "lo_idx", "dino_pos_lo", "pose_pos_lo")


@pytest.mark.parametrize("pose_pixels", [True, False])
@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("geometry", ["720p", "tiny"])
def test_spec_bookkeeping_matches_jax(geometry, split, pose_pixels):
    kw = {} if geometry == "720p" else dict(TINY)
    if split:
        kw.update(lo_height=360, lo_width=640) if geometry == "720p" \
            else kw.update(SPLIT)
    want = jengine.EngineSpec(pose_pixels=pose_pixels, **kw)
    got = EngineSpec(pose_pixels=pose_pixels, **kw)
    for prop in SPEC_PROPS:
        try:
            w = getattr(want, prop)
        except AssertionError:
            with pytest.raises(AssertionError):
                getattr(got, prop)
            continue
        np.testing.assert_array_equal(getattr(got, prop), w, err_msg=prop)
    if geometry == "720p":
        # det ∪ dino = 11 + 5 - 1 rows without the pose-only ones
        assert got.n_packed == (33 if pose_pixels else 15)


@pytest.mark.parametrize("pose_pixels", [True, False])
def test_split_pack_host_matches_jax(frames, pose_pixels):
    """hi rows are copies, lo rows within 1 of cv2's INTER_LINEAR; full
    clips and packed rows give the same dict."""
    kw = dict(TINY, pose_pixels=pose_pixels, **SPLIT)
    want = jengine.EngineSpec(**kw).split_pack_host(frames)
    spec = EngineSpec(**kw)
    got = spec.split_pack_host(frames)
    np.testing.assert_array_equal(got["hi"], want["hi"])
    np.testing.assert_array_equal(got["hi"], frames[:, spec.det_idx])
    assert got["lo"].shape == want["lo"].shape == (
        2, len(spec.lo_idx), 45, 80, 3)
    assert got["lo"].dtype == np.uint8
    assert np.abs(got["lo"].astype(int) - want["lo"]).max() <= 1
    packed = spec.split_pack_host(frames[:, spec.packed_idx])
    for key in ("hi", "lo"):
        np.testing.assert_array_equal(packed[key], got[key])
    with pytest.raises(ValueError):
        spec.split_pack_host(frames[:, :7])


def test_split_pack_host_resizes_hi_rows():
    """A 1080p source: the hi rows are resized too, within 1 of cv2."""
    kw = dict(clip_frames=4, fps=2, frame_height=72, frame_width=128,
              lo_height=36, lo_width=64)
    src = np.random.default_rng(3).integers(0, 256, (1, 4, 108, 192, 3),
                                            dtype=np.uint8)
    want = jengine.EngineSpec(**kw).split_pack_host(src)
    got = EngineSpec(**kw).split_pack_host(src)
    for key in ("hi", "lo"):
        assert got[key].shape == want[key].shape
        assert np.abs(got[key].astype(int) - want[key]).max() <= 1, key


@pytest.mark.parametrize("shape", [(90, 160), (720, 1280), (46, 64),
                                   (2, 3, 90, 160)])
def test_rgb_to_i420_matches_jax(shape):
    """The port's converter is cv2's fixed-point arithmetic: equal to the
    JAX package's (cv2) byte for byte."""
    img = np.random.default_rng(7).integers(0, 256, shape + (3,),
                                            dtype=np.uint8)
    want = jyuv.rgb_to_i420(img)
    got = tyuv.rgb_to_i420(img)
    assert got.shape == want.shape == shape[:-2] + tyuv.i420_shape(
        *shape[-2:])
    np.testing.assert_array_equal(got, want)


def _every_triple(k0: int, k1: int):
    """I420 frames (k1 - k0, 768, 512) that hold every (U, V) pair in the
    chroma planes and, over 64 frames, each pair with every Y (four a
    2x2 block)."""
    uu, vv = np.meshgrid(np.arange(256, dtype=np.uint8),
                         np.arange(256, dtype=np.uint8), indexing="ij")
    out = []
    for k in range(k0, k1):
        y = np.empty((512, 512), np.uint8)
        for i, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            y[dy::2, dx::2] = 4 * k + i
        out.append(np.concatenate([y.ravel(), uu.ravel(), vv.ravel()]
                                  ).reshape(768, 512))
    return np.stack(out)


@pytest.mark.parametrize("part", range(4))
def test_i420_to_rgb_every_triple_matches_jax(part):
    """Bit for bit the JAX program (XLA on the CPU) over every (Y, U, V)
    triple, a quarter of them per case."""
    yuv = _every_triple(16 * part, 16 * part + 16)
    want = np.asarray(jax.jit(jyuv.i420_to_rgb_device)(yuv))
    got = tyuv.i420_to_rgb_device(torch.from_numpy(yuv)).numpy()
    np.testing.assert_array_equal(got, want)


def test_i420_flat_matches_jax():
    """The flat buffer of a split dict and of a bare array, with an odd
    half height (90 rows: the chroma planes do not align to buffer rows):
    the port's unpacker equals the JAX one bit for bit."""
    rng = np.random.default_rng(7)
    tree = {"hi": jyuv.rgb_to_i420(
                rng.integers(0, 256, (2, 3, 90, 160, 3), np.uint8)),
            "lo": jyuv.rgb_to_i420(
                rng.integers(0, 256, (2, 5, 46, 64, 3), np.uint8))}
    for t in (tree, tree["hi"]):
        want_flat, layout = jyuv.pack_i420_flat(t)
        flat, got_layout = tyuv.pack_i420_flat(t)
        assert got_layout == layout
        np.testing.assert_array_equal(flat, want_flat)
        want = jax.jit(lambda f: jyuv.i420_flat_to_rgb_device(f, layout))(
            want_flat)
        got = tyuv.i420_flat_to_rgb_device(torch.from_numpy(flat), layout)
        assert isinstance(got, dict) == isinstance(t, dict)
        if not isinstance(t, dict):
            want, got = {"": want}, {"": got}
        for key in want:
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))


def _specs(**kw):
    return jengine.EngineSpec(**TINY, **kw), EngineSpec(**TINY, **kw)


def test_engine_pose_pixels_false_matches_jax(engines, frames):
    jeng, teng = engines
    jspec, tspec = _specs(pose_pixels=False)
    assert tspec.n_packed == 9
    want = jeng.with_spec(jspec).process_clip_batch(frames)
    got = teng.with_spec(tspec).process_clip_batch(frames, _gen())
    _assert_gates(got, want)


@pytest.mark.parametrize("pose_pixels", [True, False])
def test_engine_split_matches_jax(engines, frames, pose_pixels):
    """Split ingest, the same host dict (the JAX package's cv2 resize) fed
    to both engines."""
    jeng, teng = engines
    jspec, tspec = _specs(pose_pixels=pose_pixels, **SPLIT)
    host = jspec.split_pack_host(frames)
    want = jeng.with_spec(jspec).process_clip_batch(host)
    got = teng.with_spec(tspec).process_clip_batch(host, _gen())
    _assert_gates(got, want)


def test_pose_pixels_false_equals_default(engines, frames):
    """The rows pose_pixels=False drops were never read: every output bit
    for bit the default's, with and without split ingest."""
    teng = engines[1]
    base = teng.process_clip_batch(frames, _gen())
    trim = teng.with_spec(EngineSpec(**TINY, pose_pixels=False))
    _equal_trees(trim.process_clip_batch(frames, _gen()), base)
    split = [teng.with_spec(EngineSpec(**TINY, pose_pixels=p, **SPLIT))
             for p in (True, False)]
    outs = [e.process_clip_batch(frames, _gen()) for e in split]
    _equal_trees(outs[1], outs[0])
    for key in base:
        if key != "embeddings":       # DINO reads the lo rows
            _equal_trees({key: outs[0][key]}, {key: base[key]})


@pytest.mark.parametrize("split", [False, True])
def test_yuv420_equals_rgb_on_round_tripped_frames(engines, frames,
                                                   monkeypatch, split):
    """LAMENESS_YUV_INGEST=1: the outputs equal those of the RGB path fed
    the frames that went through I420 and back."""
    teng = engines[1]
    if split:         # I420 needs even sizes
        teng = teng.with_spec(EngineSpec(**TINY, lo_height=46, lo_width=80))
    trip = tyuv.i420_to_rgb_device(torch.from_numpy(
        tyuv.rgb_to_i420(frames))).numpy()
    if split:
        host = teng.spec.split_pack_host(frames)
        trip_host = {k: tyuv.i420_to_rgb_device(torch.from_numpy(
            tyuv.rgb_to_i420(v))).numpy() for k, v in host.items()}
    monkeypatch.setenv("LAMENESS_YUV_INGEST", "1")
    assert teng.default_transfer() == "yuv420"
    got = teng.process_clip_batch(host if split else frames, _gen())
    monkeypatch.setenv("LAMENESS_YUV_INGEST", "0")
    assert teng.default_transfer() == "rgb"
    want = teng.process_clip_batch(trip_host if split else trip, _gen())
    _equal_trees(got, want)


def test_to_device_rejects_an_unknown_transfer(engines, frames):
    with pytest.raises(ValueError, match="transfer"):
        engines[1].to_device(frames, transfer="nv12")


def test_pack_output_round_trip():
    """unpack_output(pack_output(out)) is _to_numpy(out) bit for bit: bf16
    leaves as f32, bool leaves as bool, a nested dict, a 0-d leaf."""
    g = torch.Generator().manual_seed(0)
    out = {"a": torch.randn(2, 3, generator=g).to(torch.bfloat16),
           "m": torch.rand(2, 5, 7, generator=g) > 0.5,
           "i": torch.randint(-9, 9, (2, 4), generator=g),
           "k": torch.randint(-9, 9, (3,), generator=g, dtype=torch.int32),
           "loco": {"x": torch.randn(2, generator=g),
                    "y": torch.tensor(3.5, dtype=torch.float64)},
           "u": torch.randint(0, 255, (5,), generator=g, dtype=torch.uint8),
           "f": torch.randn(3, 1, generator=g)[:, 0]}
    eng = tengine.LamenessEngine(spec=EngineSpec(use_sam_model=False),
                                 device="cpu", init_models=False)
    flat, meta = eng.pack_output(out)
    assert flat.dtype == torch.uint8 and flat.dim() == 1
    got = eng.unpack_output(flat.numpy(), meta)
    assert list(got) == list(out) and list(got["loco"]) == ["x", "y"]
    _equal_trees(got, _to_numpy(out))


def test_process_clip_batch_inputs(engines, frames):
    """Full clips, packed clips, the host split dict and the device split
    dict give one result; a lo array of the wrong length is refused."""
    teng = engines[1]
    base = teng.process_clip_batch(frames, _gen())
    packed = frames[:, teng.spec.packed_idx]
    _equal_trees(teng.process_clip_batch(packed, _gen()), base)
    _equal_trees(teng.process_clip_batch(torch.from_numpy(packed), _gen()),
                 base)
    split = teng.with_spec(EngineSpec(**TINY, **SPLIT))
    host = split.spec.split_pack_host(frames)
    out = split.process_clip_batch(host, _gen())
    _equal_trees(split.process_clip_batch(split.to_device(host), _gen()),
                 out)
    _equal_trees(split.process_clip_batch(frames, _gen()), out)
    bad = dict(host, lo=host["lo"][:, :-1])
    with pytest.raises(ValueError, match="lo"):
        split.process_clip_batch(bad, _gen())
    with pytest.raises(ValueError):
        split.process_clip_batch({k: torch.from_numpy(v)
                                  for k, v in bad.items()}, _gen())


def test_with_spec_shares_the_modules(engines):
    teng = engines[1]
    teng.spec.dtype = torch.bfloat16
    try:
        other = teng.with_spec(EngineSpec(**TINY, pose_pixels=False))
    finally:
        teng.spec.dtype = torch.float32
    assert other.sam is teng.sam and other.dino is teng.dino
    assert other.spec.dtype == torch.bfloat16 and not other.spec.pose_pixels
    with pytest.raises(AssertionError, match="input sizes"):
        teng.with_spec(EngineSpec(**dict(TINY, dino_size=112)))


def test_warmup_split(engines):
    split = engines[1].with_spec(EngineSpec(**TINY, pose_pixels=False,
                                            **SPLIT))
    assert set(split.warmup(batch=1)) == {"detect", "sam", "dino", "heads"}
