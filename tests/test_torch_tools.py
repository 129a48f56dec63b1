"""The port's dataset, training, weight and profiling tools
(``lameness_tpu_torch/tools/``) against the JAX package's scripts
(``scripts/``) on the same seeded COCO-keypoints set, built as
``tests/test_scripts.py`` builds one (with textured images), on the CPU:

- ``load_coco_pose_dataset`` and ``load_coco_detection``: boxes and
  keypoints to 1e-6, images within 1 of JAX's (cv2's decode and resize);
- ``prepare_pose_dataset`` (with ``--flip-augment``) and
  ``analyze_training_orientation`` (with ``--fix``): the same JSON key for
  key, the same report;
- ``compare_pose_models``' heuristic row within 1e-5;
- ``train_detector`` (``--synthetic`` and ``--data``) and
  ``train_pose_model`` for one epoch: the JAX script's lines and keys, a
  checkpoint ``load_params`` and ``restore_engine`` read back;
- ``convert_weights`` on seeded state dicts (ultralytics, HF and
  segment-anything SAM, HF DINOv2 from ``.bin`` and ``.safetensors``): the
  tensors of ``weights.from_jax_params`` of JAX's converter;
- ``collect_cow_pose_data`` extract/import, ``profile_stages``,
  ``run_pipeline_example`` and ``bulk_upload`` on the tiny engine;
- ``convert_videos`` on a folder of mp4v files (cv2's and the port's), a
  broken one and entries it skips: JAX's lines, names and frame counts;
- every tool refuses to run without a card unless ``--device cpu``.
"""
import json
import struct
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from lameness_tpu_torch.pipeline import pose_training as tpose
from lameness_tpu_torch.pipeline.checkpoint import load_params, \
    restore_engine
from lameness_tpu_torch.pipeline.engine import make_test_engine
from lameness_tpu_torch.tools import (analyze_training_orientation,
                                      bulk_upload, collect_cow_pose_data,
                                      compare_pose_models, convert_videos,
                                      convert_weights, prepare_pose_dataset,
                                      profile_stages, run_pipeline_example,
                                      train_detector, train_pose_model)
from lameness_tpu_torch.video.decode import write_video
from lameness_tpu_torch.weights import from_jax_params

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"
sys.path.insert(0, str(SCRIPTS))

import analyze_training_orientation as j_analyze  # noqa: E402
import compare_pose_models as j_compare  # noqa: E402
import convert_videos as j_convert  # noqa: E402
import prepare_pose_dataset as j_prepare  # noqa: E402
import train_detector as j_detector  # noqa: E402
from tests.test_scripts import _coco_dataset  # noqa: E402


def textured(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 90 * np.sin(x / (5.0 + c) + seed)
                     * np.cos(y / 9.0 - c) for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 10, base.shape), 0, 255).astype(
        np.uint8)


def coco_source(root: Path, facing_right=True):
    """``tests/test_scripts.py``'s 6-image AP-10K set, its images redrawn
    with texture and a cow block (cv2.imwrite, quality 95, 4:2:0)."""
    ann, images = _coco_dataset(root, n=6, img=96, facing_right=facing_right)
    for i, f in enumerate(sorted(images.glob("*.jpg"))):
        im = textured(96, 96, i)
        im[20:60, 10:70] = np.clip(im[20:60, 10:70].astype(int) + 80, 0,
                                   255)
        cv2.imwrite(str(f), im)
    return ann, images


def run_jax_main(module, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [module.__name__, *argv])
    module.main()
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """The source set, and the port's prepare_pose_dataset (--flip-augment)
    of it."""
    root = tmp_path_factory.mktemp("coco")
    ann, images = coco_source(root / "src")
    assert prepare_pose_dataset.main(
        ["coco", str(ann), str(images), "--out", str(root / "ds"),
         "--flip-augment", "--device", "cpu"]) == 0
    return root


def test_prepare_pose_dataset_matches_jax(prepared, tmp_path, monkeypatch,
                                          capsys):
    src = prepared / "src"
    run_jax_main(j_prepare, ["coco", str(src / "ann.json"),
                             str(src / "images"), "--out",
                             str(tmp_path / "ds"), "--flip-augment"],
                 monkeypatch, capsys)
    want = json.load(open(tmp_path / "ds" / "annotations.json"))
    got = json.load(open(prepared / "ds" / "annotations.json"))
    assert got == want
    assert len(got["images"]) == 12
    for e in want["images"]:
        a = cv2.imread(str(prepared / "ds" / "images" / e["file_name"]))
        b = cv2.imread(str(tmp_path / "ds" / "images" / e["file_name"]))
        # the flips: decoded, flipped and encoded as cv2 does it
        assert (a == b).all(), e["file_name"]


def test_name_tables_match_jax():
    assert prepare_pose_dataset.AP10K_NAMES == j_prepare.AP10K_NAMES
    assert prepare_pose_dataset.AP10K_TO_OLD == j_prepare.AP10K_TO_OLD
    assert prepare_pose_dataset.OLD_IDX == j_prepare.OLD_IDX
    assert prepare_pose_dataset._FLIP_PAIRS == j_prepare._FLIP_PAIRS
    assert analyze_training_orientation.HEAD == j_analyze.HEAD
    assert analyze_training_orientation.REAR == j_analyze.REAR


def test_analyze_training_orientation_matches_jax(tmp_path, monkeypatch,
                                                  capsys):
    """Report and --fix on a set that faces one way, both sides."""
    ann, images = coco_source(tmp_path / "src")
    out = {}
    for side in ("jax", "port"):
        ds = tmp_path / side
        assert prepare_pose_dataset.main(
            ["coco", str(ann), str(images), "--out", str(ds),
             "--device", "cpu"]) == 0
        capsys.readouterr()
        runs = []
        for extra in ([], ["--fix"], []):
            if side == "jax":
                runs.append(run_jax_main(j_analyze, [str(ds), *extra],
                                         monkeypatch, capsys))
            else:
                analyze_training_orientation.main(
                    [str(ds), *extra, "--device", "cpu"])
                runs.append(capsys.readouterr().out)
        out[side] = runs, json.load(open(ds / "annotations.json"))
    assert out["port"] == out["jax"]
    assert "imbalance: 100%" in out["port"][0][0]
    assert "imbalance: 0%" in out["port"][0][2]


def test_load_coco_pose_dataset_matches_jax(prepared):
    from lameness_tpu.pipeline.pose_training import \
        load_coco_pose_dataset as jax_load
    want = jax_load(prepared / "ds", img_size=64)
    got = tpose.load_coco_pose_dataset(prepared / "ds", img_size=64,
                                       device="cpu")
    assert got[0].shape == want[0].shape and got[0].dtype == np.uint8
    assert np.abs(got[0].astype(int) - want[0]).max() <= 1
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_load_coco_detection_matches_jax(prepared):
    want = j_detector.load_coco_detection(prepared / "ds", 80)
    got = train_detector.load_coco_detection(prepared / "ds", 80,
                                             device="cpu")
    assert np.abs(got[0] - want[0]).max() <= 1 / 255 + 1e-7
    for g, w in zip(got[1:4], want[1:4]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    assert got[4] == want[4]


def test_compare_pose_models_heuristic_matches_jax(prepared, tmp_path,
                                                   capsys):
    from lameness_tpu.models import pose as jpose
    from lameness_tpu.pipeline.pose_training import \
        load_coco_pose_dataset as jax_load
    images, boxes, kpts = jax_load(prepared / "ds", img_size=64, limit=8)
    heur = np.stack([np.asarray([[kp["x"], kp["y"]] for kp in
                                 jpose.heuristic_keypoints(list(b))])
                     for b in boxes])
    want = j_compare._pose_metrics(heur, kpts, boxes)
    got = compare_pose_models.compare(prepared / "ds", [str(tmp_path)], 64,
                                      8, "cpu")
    assert "no pose checkpoint" in capsys.readouterr().out
    assert list(got) == ["heuristic"]
    for key in ("oks", "pck@0.1", "pck@0.2", "mean_err_px"):
        assert abs(got["heuristic"][key] - want[key]) <= 1e-5, key
    np.testing.assert_allclose(got["heuristic"]["per_kpt_err"],
                               want["per_kpt_err"], rtol=0, atol=1e-4)


def test_train_pose_model_and_compare(prepared, tmp_path, capsys):
    models = tmp_path / "models"
    assert train_pose_model.main(
        [str(prepared / "ds"), "--epochs", "1", "--img-size", "64",
         "--batch-size", "4", "--models-dir", str(models),
         "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "dataset: 12 images, 20 keypoints"
    assert lines[1].startswith("completed: final loss ")
    assert lines[2] == f"checkpoint: {models}/pose/"
    assert load_params(models, "pose") is not None
    eng = make_test_engine(device="cpu")
    assert restore_engine(eng, models)["pose"]
    compare_pose_models.main([str(prepared / "ds"), "--model", str(models),
                              "--img-size", "64", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "heuristic" in out and str(models) in out
    assert "per-keypoint mean error" in out


def _restore_detector(out: Path):
    """The detector checkpoint installs into an engine's YOLO of its
    class count through restore_engine, and loads by load_params."""
    from lameness_tpu_torch.models.yolo import YoloV8
    sd = load_params(out, "detector_best")
    assert sd is not None
    models = out / "models" / "yolo"
    models.mkdir(parents=True)
    (models / "params.torch").write_bytes(
        (out / "detector_best" / "params.torch").read_bytes())
    eng = make_test_engine(device="cpu")
    eng.yolo = YoloV8("n", num_classes=1, device="cpu")
    assert restore_engine(eng, out / "models")["yolo"]
    for k, v in eng.yolo.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_train_detector_synthetic_cli(tmp_path):
    """The module's command line, as a user runs it."""
    r = subprocess.run(
        [sys.executable, "-m", "lameness_tpu_torch.tools.train_detector",
         "--synthetic", "--epochs", "1", "--out", str(tmp_path),
         "--device", "cpu"], capture_output=True, text=True, cwd=REPO,
        timeout=600)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    images, labels, boxes, masks, nc = j_detector.synthetic_dataset(
        img_size=160)
    n_val = max(1, int(len(images) * 0.2))
    assert lines[0] == (f"dataset: {len(images) - n_val} train / {n_val} "
                        f"val, {nc} classes")
    assert lines[1].startswith("epoch 0: loss ")
    assert set(json.loads(lines[-1])) == {"best_mAP50_95"}
    _restore_detector(tmp_path)


def test_train_detector_on_a_dataset(prepared, tmp_path, capsys):
    assert train_detector.main(["--data", str(prepared / "ds"), "--img",
                                "64", "--epochs", "1", "--batch", "4",
                                "--out", str(tmp_path), "--cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "dataset: 10 train / 2 val, 1 classes"
    assert set(json.loads(out[-1])) == {"best_mAP50_95"}
    _restore_detector(tmp_path)


# -- convert_weights -------------------------------------------------------------
def write_safetensors(path: Path, sd) -> None:
    header, blobs, off = {}, [], 0
    for k, v in sd.items():
        b = v.contiguous().numpy().tobytes()
        header[k] = {"dtype": "F32", "shape": list(v.shape),
                     "data_offsets": [off, off + len(b)]}
        blobs.append(b)
        off += len(b)
    h = json.dumps({"__metadata__": {"format": "pt"}, **header}).encode()
    path.write_bytes(struct.pack("<Q", len(h)) + h + b"".join(blobs))


@pytest.fixture(scope="module")
def reference_checkpoints(tmp_path_factory):
    """Seeded state dicts in the reference layouts, with the JAX
    converter's state dicts of them."""
    from transformers import Dinov2Config, Dinov2Model, \
        SamConfig as HfSamConfig, SamModel

    from lameness_tpu.models import dino as jdino
    from lameness_tpu.models import sam as jsam
    from lameness_tpu.models import yolo as jyolo
    from lameness_tpu_torch.models import sam as tsam
    from lameness_tpu_torch.models.yolo import YoloV8, \
        export_ultralytics_state_dict
    from lameness_tpu_torch.weights import conv_tree_from_state_dict, \
        seeded_state_dict
    root = tmp_path_factory.mktemp("ckpt")
    torch.manual_seed(0)
    with torch.no_grad():
        sam = SamModel(HfSamConfig()).eval().state_dict()
        dino = Dinov2Model(Dinov2Config(image_size=518)).eval().state_dict()
    yolo = YoloV8("n", device="cpu")
    yolo.load_state_dict(seeded_state_dict(yolo,
                                           torch.Generator().manual_seed(3)))
    ultra = {k: torch.as_tensor(v) for k, v in export_ultralytics_state_dict(
        conv_tree_from_state_dict(yolo.state_dict())).items()}
    files = {"yolo": root / "yolov8n.pt", "sam-hf": root / "sam_hf.bin",
             "sam-sa": root / "sam_vit_b.pth", "dino-bin": root / "dino.bin",
             "dino-safetensors": root / "dinov2-base"}
    torch.save(ultra, files["yolo"])
    torch.save(sam, files["sam-hf"])
    torch.save(tsam.hf_to_sa_state_dict(sam), files["sam-sa"])
    torch.save(dino, files["dino-bin"])
    files["dino-safetensors"].mkdir()
    write_safetensors(files["dino-safetensors"] / "model.safetensors", dino)
    sd = {k: v.numpy() for k, v in ultra.items()}
    want = {"yolo": from_jax_params(
                {"yolo": jyolo.convert_ultralytics_state_dict(sd)})["yolo"],
            "sam": from_jax_params(
                {"sam": jsam.convert_hf_state_dict(sam)})["sam"],
            "dino": from_jax_params(
                {"dino": jdino.convert_hf_state_dict(dino)})["dino"]}
    return files, want


@pytest.mark.parametrize("case", ["yolo", "sam-hf", "sam-sa", "dino-bin",
                                  "dino-safetensors"])
def test_convert_weights_matches_jax(reference_checkpoints, tmp_path, case,
                                     capsys):
    files, want = reference_checkpoints
    kind = case.split("-")[0]
    assert convert_weights.main([kind, str(files[case]), "--out",
                                 str(tmp_path), "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == (
        f"saved {kind} checkpoint -> {tmp_path / kind / 'params.torch'}")
    got = load_params(tmp_path, kind)
    assert set(got) == set(want[kind])
    for k, v in want[kind].items():
        assert torch.equal(got[k], v), k


def test_convert_weights_refuses_a_hub_id(tmp_path):
    with pytest.raises(FileNotFoundError, match="pytorch_model.bin"):
        convert_weights.main(["dino", "facebook/dinov2-base", "--out",
                              str(tmp_path), "--device", "cpu"])
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        convert_weights.load_source(str(tmp_path / "empty"))


# -- the tools around the app ----------------------------------------------------
def walk_frames(n=70, w=320, h=90, size=30):
    """tests/test_video.py's bright square walking across the frame."""
    frames = np.full((n, h, w, 3), 60, np.uint8)
    for i in range(n):
        x, y = int(i / (n - 1) * (w - size)), h // 3
        frames[i, y:y + size, x:x + size] = 220
        frames[i, y:y + size:4, x:x + size] = 160
    return frames


def test_collect_extract_import(tmp_path, capsys):
    videos = tmp_path / "data" / "videos"
    videos.mkdir(parents=True)
    write_video(videos / "w1", walk_frames(), 10, device="cpu")
    sess = tmp_path / "sess"
    assert collect_cow_pose_data.main(
        ["extract", "--data", str(tmp_path / "data"), "--out", str(sess),
         "--per-video", "4", "--device", "cpu"]) == 0
    man = json.load(open(sess / "manifest.json"))
    assert man["frames"], "no frames extracted"
    rec = man["frames"][0]
    assert set(rec) == {"image", "video", "frame", "width", "height",
                        "bbox_xyxy", "keypoints", "reviewed"}
    assert len(rec["keypoints"]) == 20
    assert cv2.imread(str(sess / "frames" / rec["image"])).shape == \
        (90, 320, 3)
    out = tmp_path / "ds"
    assert collect_cow_pose_data.main(["import", str(sess), "--out",
                                       str(out)]) == 0
    doc = json.load(open(out / "annotations.json"))
    assert len(doc["images"]) == len(man["frames"])
    images, boxes, kpts = tpose.load_coco_pose_dataset(out, img_size=64,
                                                       device="cpu")
    assert images.shape[1:] == (64, 64, 3) and kpts.shape[1:] == (20, 3)


def test_profile_stages_small(tmp_path, capsys):
    assert profile_stages.main(["--small", "--runs", "2", "--trace",
                                str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "p50 ms" in out and "p95 ms" in out and "run_staged" in out
    traces = list(tmp_path.glob("trace_*.json"))
    assert len(traces) == 1 and json.load(open(traces[0]))["traceEvents"]


def test_run_pipeline_example_and_bulk_upload_small(tmp_path, capsys):
    src = write_video(tmp_path / "walk", walk_frames(), 10, device="cpu")
    assert run_pipeline_example.main(
        [str(src), "--small", "--data", str(tmp_path / "d1"),
         "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "final probability:" in out and "tleap" in out
    for split in ("lame", "sound"):
        (tmp_path / "bulk" / split).mkdir(parents=True)
        write_video(tmp_path / "bulk" / split / "v", walk_frames(), 10,
                    device="cpu")
    assert bulk_upload.main([str(tmp_path / "bulk"), "--small", "--data",
                             str(tmp_path / "d2"), "--device", "cpu"]) == 0
    assert "uploaded 2 videos" in capsys.readouterr().out


def test_convert_videos_matches_jax(tmp_path, monkeypatch, capsys):
    """The same folder through the JAX script and the port's tool: the
    same ``ok``/``FAIL`` lines (a FAIL's reason is each side's), the same
    output names, and every output read by cv2 at the JAX output's frame
    count, fps and size."""
    from lameness_tpu.video.decode import write_video as jax_write
    src = tmp_path / "src"
    src.mkdir()
    frames = walk_frames()
    jax_write(src / "a_cv2.mp4", list(frames), 10, reencode=False)
    write_video(src / "b_port.mov", frames[:7], 25, device="cpu")
    (src / "c_broken.mkv").write_bytes(b"\0" * 64)
    (src / "notes.txt").write_text("not a video")
    (src / "d.mp4").mkdir()                    # a directory is skipped
    monkeypatch.setattr(sys, "argv", ["convert_videos.py", str(src),
                                      str(tmp_path / "jax")])
    j_convert.main()
    want = capsys.readouterr().out.splitlines()
    assert convert_videos.main([str(src), str(tmp_path / "port"),
                                "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()

    def head(line):
        return line.split(":")[0] if line.startswith("FAIL") else line
    assert [head(x) for x in got] == [head(x) for x in want]
    assert sum(x.startswith("ok") for x in got) == 2
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) \
        == ["a_cv2.mp4", "b_port.mp4"]
    for name in names:
        caps = [cv2.VideoCapture(str(tmp_path / side / name))
                for side in ("jax", "port")]
        props = [[c.get(k) for k in (cv2.CAP_PROP_FRAME_COUNT,
                                     cv2.CAP_PROP_FPS,
                                     cv2.CAP_PROP_FRAME_WIDTH,
                                     cv2.CAP_PROP_FRAME_HEIGHT)]
                 for c in caps]
        assert props[1] == props[0], name
        n = 0
        while caps[1].read()[0]:
            n += 1
        assert n == props[0][0], name
    assert convert_videos.main([]) == 1
    assert "Usage" in capsys.readouterr().out


@pytest.mark.parametrize("tool,argv", [
    (prepare_pose_dataset, ["coco", "a.json", "imgs", "--out", "o"]),
    (analyze_training_orientation, ["ds"]),
    (train_pose_model, ["ds"]),
    (compare_pose_models, ["ds"]),
    (train_detector, ["--synthetic"]),
    (collect_cow_pose_data, ["extract", "--out", "s"]),
    (convert_weights, ["dino", "x.bin"]),
    (profile_stages, ["--small"]),
    (run_pipeline_example, ["v.y4m", "--small"]),
    (bulk_upload, ["ds", "--small"]),
    (convert_videos, ["."]),
])
def test_tools_need_a_card_unless_asked(tool, argv, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs there")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)
