"""The port's CLIP benchmark harness (``bcosification_tpu_torch/
clip_benchmark/``) against the JAX package's ``clip_benchmark`` on the CPU.

Both packages load one small random CLIP-RN50 checkpoint in OpenAI's layout
(tests/test_torch_clip_import.py's ``openai_state_dict``: layers (1, 1, 1,
1), width 16, embed_dim 32, a 2-layer width-64 text tower; its attention
pool sized for 224x224) from ``$CLIP_WEIGHTS_PATH``, so every bundle, the
B-cosified students of the clip_bcosification experiments included, holds
the same weights in both. Tolerances:

- a ``bcos_clip`` bundle, pooled and attn-unpool: the image features (the
  tower's outputs before any normalisation, RMS ~1-10: not contracted) and
  the text features within 1e-5, the zero-shot classifier within 1e-5, the
  logits within ten port spreads under 1e-7 relative input noise (their
  cancellations amplify the features' rounding) and ``evaluate``'s metrics
  equal;
- retrieval and caption selection on shared features with ties: equal;
- ``fit_linear_aligner`` within 1e-6; the aligner npz read by the other
  package: equal; ``TextToConcept.fit_aligner`` on the two bundles: W
  within ten port spreads under 1e-7 relative input noise (the regression
  amplifies the features' rounding), the aligned features within 1e-5;
- the VOC dataset's labels and boxes on a seeded XML tree: equal;
- ``build_dataset`` on a seeded wds tree (classification, captions) and the
  webdataset writer: equal arrays, labels and caption lists;
- the CLI's ``eval`` (``device="cpu"``) on the dummy sets for every task but
  captioning (tests/test_torch_captioner.py runs that one), with
  standard_clip, bcos_clip and bcos_clip_cc3m, its JSON keys and values
  against the JAX CLI's within 1e-5, and ``build``'s CSV;
- ``standard_clip`` with a ViT name and the external model types raise.
"""
import csv
import io
import json
import sys
import tarfile
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

NAME = "resnet_50_clip_b2_noBias_randomResizedCrop_sigLip_ImageNet_bcosification"


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def small_clip_env(tmp_path, monkeypatch):
    """Point both packages at one small random CLIP-RN50 checkpoint (224x224
    attention pool) and at an empty experiment root under ``tmp_path``."""
    from test_torch_clip_import import openai_state_dict

    from bcosification_tpu import settings as jsettings
    from bcosification_tpu_torch import settings as tsettings

    sd = openai_state_dict(seed=0)
    e = sd["visual.attnpool.positional_embedding"].shape[1]
    sd["visual.attnpool.positional_embedding"] = (
        np.random.default_rng(1).standard_normal((7 * 7 + 1, e)) * 0.5).astype(np.float32)
    np.savez(tmp_path / "rn50.npz", **sd)
    monkeypatch.setenv("CLIP_WEIGHTS_PATH", str(tmp_path / "rn50.npz"))
    for settings in (jsettings, tsettings):
        monkeypatch.setattr(settings, "EXPERIMENT_ROOT", str(tmp_path / "experiments"))
    warnings.filterwarnings("ignore", message=".*random init.*")


def _bundles(model_type, name, tmp_path, monkeypatch, pretrained=""):
    from clip_benchmark.models import load_clip as jload
    from bcosification_tpu_torch.clip_benchmark.models import load_clip as tload

    small_clip_env(tmp_path, monkeypatch)
    return jload(model_type, name, pretrained), tload(model_type, name, pretrained,
                                                       device="cpu")


def _noise(shape, seed=11):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _images(transform, n, seed=0):
    """``n`` seeded 80x64 RGB images through ``transform``."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    return np.stack([transform(Image.fromarray((rng.random((64, 80, 3)) * 255).astype(np.uint8)))
                     for _ in range(n)]).astype(np.float32)


@pytest.mark.parametrize("unpool", [False, True], ids=["pooled", "unpool"])
def test_bcos_clip_bundle_zeroshot_matches_jax(unpool, tmp_path, monkeypatch):
    from clip_benchmark.metrics import zeroshot_classification as jzs
    from bcosification_tpu_torch.clip_benchmark.metrics import zeroshot_classification as tzs
    from bcosification_tpu_torch.clip_benchmark.models import features_numpy

    (jb, jt, _), (tb, tt, _) = _bundles("bcos_clip", NAME + ("_attnUnpool" if unpool else ""),
                                        tmp_path, monkeypatch)
    assert jb.cosine_power == tb.cosine_power == (2 if unpool else 0)
    x = _images(tt, 4)
    np.testing.assert_array_equal(x, _images(jt, 4))
    jf = np.asarray(jax.jit(jb.encode_image)(jnp.asarray(x)))
    tf = features_numpy(tb.encode_image(tb.images(x)))
    assert 1e-2 < float(np.sqrt((jf ** 2).mean())) < 100  # not contracted to ~0
    assert _rel(tf, jf) <= 1e-5
    classes, templates = ["dog", "cat", "tree", "car", "boat", "fish"], [
        "a photo of a {c}.", "itap of a {}.", "a {} in the wild"]
    texts = [t.replace("{c}", "{}").format(c) for c in classes for t in templates]
    assert _rel(tb.encode_texts(texts), jb.encode_texts(texts)) <= 1e-5
    jw = np.asarray(jzs.zero_shot_classifier(jb, classes, templates))
    tw = tzs.zero_shot_classifier(tb, classes, templates)
    assert tw.shape == jw.shape == (32, len(classes)) and _rel(tw, jw) <= 1e-5
    labels = np.arange(4) % len(classes)
    loader = [(x[:2], labels[:2]), (x[2:], labels[2:])]
    jl, jy = jzs.run_classification(jb, jnp.asarray(jw), loader, jb.cosine_power)
    tl, ty = tzs.run_classification(tb, jw, loader, tb.cosine_power)
    # the logits (100 x cosines, summed over the locations unpooled) carry
    # the features' ~1e-6 rounding amplified by their cancellations: held
    # within ten times the port's own spread under 1e-7 relative input noise
    noisy = [(xb * (1 + 1e-7 * _noise(xb.shape)), yb) for xb, yb in loader]
    spread = _rel(tzs.run_classification(tb, jw, noisy, tb.cosine_power)[0], tl)
    assert 0 < spread and _rel(tl, jl) <= 10 * spread
    assert np.array_equal(ty, jy)
    want = jzs.evaluate(jb, loader, classes, templates, cosine_power=jb.cosine_power)
    got = tzs.evaluate(tb, loader, classes, templates, cosine_power=tb.cosine_power)
    assert got == want


class _FeatureBundle:
    """A bundle whose 'images' are their own features and whose text
    features come from a fixed table: both packages' metrics see the same
    numbers, small integers with many tied scores."""

    def __init__(self, table, torch_side):
        self.table, self.torch_side = table, torch_side
        self.device = torch.device("cpu")

    def images(self, images):
        return torch.from_numpy(np.asarray(images, np.float32))

    def encode_image(self, images):
        return images

    def encode_texts(self, texts):
        return np.stack([self.table[t] for t in texts])


def test_retrieval_on_shared_features_matches_jax():
    from clip_benchmark.metrics import zeroshot_retrieval as jret
    from bcosification_tpu_torch.clip_benchmark.metrics import zeroshot_retrieval as tret

    rng = np.random.default_rng(0)
    img = rng.integers(0, 2, (24, 4)).astype(np.float32) + np.eye(24, 4, dtype=np.float32)
    caps = [[f"c{i}_{j}" for j in range(rng.integers(1, 4))] for i in range(24)]
    table = {c: rng.integers(0, 2, 4).astype(np.float32) + 0.5 for cs in caps for c in cs}
    loader = [(img[i:i + 8], caps[i:i + 8]) for i in range(0, 24, 8)]
    want = jret.evaluate(_FeatureBundle(table, False), loader, recall_k_list=[1, 2, 5])
    got = tret.evaluate(_FeatureBundle(table, True), loader, recall_k_list=[1, 2, 5])
    assert got == want


@pytest.mark.parametrize("images_per_instance", [1, 2])
def test_caption_selection_on_shared_features_matches_jax(images_per_instance):
    from clip_benchmark.metrics import image_caption_selection as jsel
    from bcosification_tpu_torch.clip_benchmark.metrics import image_caption_selection as tsel

    rng = np.random.default_rng(1)
    # [B, H, W, C] images (here 1 x 1 x 5) or [B, images, H, W, C]
    shape = (12, 1, 1, 5) if images_per_instance == 1 else (12, 2, 1, 1, 5)
    img = rng.integers(0, 2, shape).astype(np.float32) + 0.25
    caps = [[f"i{i}_{j}" for j in range(3)] for i in range(12)]
    table = {c: rng.integers(0, 2, 5).astype(np.float32) + 0.25 for cs in caps for c in cs}
    loader = [(img[i:i + 4], caps[i:i + 4]) for i in range(0, 12, 4)]
    want = jsel.evaluate(_FeatureBundle(table, False), loader)
    got = tsel.evaluate(_FeatureBundle(table, True), loader)
    assert got == want


def test_average_precision_and_recalls_match_jax():
    """The multilabel mAP (VOC targets), accuracy with ties and the
    mean-per-class recall: numpy in both packages, equal."""
    from clip_benchmark.metrics import zeroshot_classification as jzs
    from bcosification_tpu_torch.clip_benchmark.metrics import zeroshot_classification as tzs

    rng = np.random.default_rng(2)
    scores = rng.integers(0, 4, (30, 20)).astype(np.float32)
    targets = (rng.random((30, 20)) < 0.2).astype(np.float32)
    np.testing.assert_array_equal(tzs.average_precision(scores, targets),
                                  jzs.average_precision(scores, targets))
    y = rng.integers(0, 20, 30)
    assert tzs.accuracy(scores, y, (1, 5)) == jzs.accuracy(scores, y, (1, 5))
    assert tzs.mean_per_class_recall(scores, y) == jzs.mean_per_class_recall(scores, y)


@pytest.mark.parametrize("bias", [False, True])
def test_fit_linear_aligner_and_npz_round_trip(bias, tmp_path):
    from clip_benchmark.models import text2concept as jt2c
    from bcosification_tpu_torch.clip_benchmark.models import text2concept as tt2c

    rng = np.random.default_rng(3)
    F = rng.standard_normal((64, 12)).astype(np.float32)
    G = (F @ rng.standard_normal((12, 8)) + 0.1 * rng.standard_normal((64, 8))).astype(np.float32)
    jw, jb = jt2c.fit_linear_aligner(F, G, bias=bias)
    tw, tb = tt2c.fit_linear_aligner(F, G, bias=bias)
    assert _rel(tw, jw) <= 1e-6 and (tb is None) == (jb is None) == (not bias)
    if bias:
        assert _rel(tb, jb) <= 1e-6
    # one npz serves both packages: each reads the other's file
    holder = type("Holder", (), {})
    for save_cls, load_cls, path in ((tt2c.TextToConcept, jt2c.TextToConcept, "port.npz"),
                                     (jt2c.TextToConcept, tt2c.TextToConcept, "jax.npz")):
        src, dst = holder(), holder()
        src.W, src.b = tw, tb
        save_cls.save_aligner(src, tmp_path / path)
        load_cls.load_aligner(dst, tmp_path / path)
        np.testing.assert_array_equal(dst.W, tw)
        assert (dst.b is None) == (tb is None)
        if tb is not None:
            np.testing.assert_array_equal(dst.b, tb)


def test_text2concept_fit_aligner_matches_jax(tmp_path, monkeypatch):
    """The text2concept_clip bundles of both packages: fit_aligner over one
    loader (the model's features against the vanilla tower's on the CLIP-
    normalised first 3 channels), then the aligned features."""
    from bcosification_tpu_torch.clip_benchmark.models import features_numpy

    (jb, jt, _), (tb, tt, _) = _bundles("text2concept_clip", NAME, tmp_path, monkeypatch)
    x = _images(tt, 12, seed=5)
    loader = [(x[i:i + 4], np.zeros(4)) for i in range(0, 12, 4)]
    jb.text2concept.fit_aligner(loader, ridge=1e-2)
    tb.text2concept.fit_aligner(loader, ridge=1e-2)
    w = tb.text2concept.W.copy()
    # the regression amplifies the features' rounding: W within ten times the
    # port's own spread under 1e-7 relative input noise
    tb.text2concept.fit_aligner([(xb * (1 + 1e-7 * _noise(xb.shape)), yb) for xb, yb in loader],
                                ridge=1e-2)
    spread = _rel(tb.text2concept.W, w)
    tb.text2concept.W = w
    assert 0 < spread and _rel(w, jb.text2concept.W) <= 10 * spread
    want = np.asarray(jb.encode_image(jnp.asarray(x[:4])))
    got = features_numpy(tb.encode_image(tb.images(x[:4])))
    assert _rel(got, want) <= 1e-5


def test_voc_dataset_matches_jax(tmp_path):
    """Multilabel targets and the also_annotation boxes (rescaled to 224,
    int truncation, clamped) on a seeded XML tree: equal."""
    from test_voc import _write_voc

    from bcosification_tpu.data.datamodules import VOCDataModule as JVOC
    from bcosification_tpu_torch.data.datamodules import VOCDataModule as TVOC

    rng = np.random.default_rng(4)
    from bcosification_tpu_torch.data.categories import VOC_CATEGORIES

    entries = {}
    for i in range(6):
        w, h = int(rng.integers(100, 500)), int(rng.integers(100, 500))
        objs = []
        for _ in range(int(rng.integers(1, 4))):
            x0, y0 = int(rng.integers(0, w - 10)), int(rng.integers(0, h - 10))
            objs.append((VOC_CATEGORIES[int(rng.integers(0, 20))], x0, y0,
                         int(rng.integers(x0 + 1, w + 1)), int(rng.integers(y0 + 1, h + 1))))
        entries[f"img{i}"] = (w, h, objs)
    _write_voc(tmp_path, entries)
    (tmp_path / "ImageSets" / "Main" / "trainval.txt").write_text(
        (tmp_path / "ImageSets" / "Main" / "val.txt").read_text())
    for annotate in (False, True):
        cfg = {"batch_size": 2, "data_root": str(tmp_path), "train_transform": None,
               "test_transform": None, "also_annotation": annotate}
        jdm, tdm = JVOC(dict(cfg)), TVOC(dict(cfg))
        jdm.setup("fit")
        tdm.setup("fit")
        assert tdm.CATEGORIES == jdm.CATEGORIES and tdm.NUM_CLASSES == jdm.NUM_CLASSES == 20
        for jds, tds in ((jdm.train_dataset, tdm.train_dataset),
                         (jdm.eval_dataset, tdm.eval_dataset)):
            assert len(tds) == len(jds) == 6
            for i in range(6):
                want, got = jds[i], tds[i]
                assert len(got) == len(want)
                for a, b in zip(got[:2], want[:2]):
                    np.testing.assert_array_equal(a, b)
                if len(want) == 3:
                    assert got[2] == want[2]


def _write_wds(root, n, captions, seed):
    """A wds tree: <root>/test/0.tar of n JPEGs with a class id (or a caption
    list), classnames and templates."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    (root / "test").mkdir(parents=True)
    (root / "classnames.txt").write_text("dog\ncat\nbird\n")
    (root / "zeroshot_classification_templates.txt").write_text("a photo of a {c}.\n")
    with tarfile.open(root / "test" / "0.tar", "w") as tf:
        for i in range(n):
            buf = io.BytesIO()
            Image.fromarray((rng.random((40, 50, 3)) * 255).astype(np.uint8)).save(
                buf, format="JPEG")
            extra = ("txt", "\n".join(f"caption {i} {j}" for j in range(1 + i % 3))) if captions \
                else ("cls", str(i % 3))
            for ext, data in (("jpg", buf.getvalue()), (extra[0], extra[1].encode())):
                info = tarfile.TarInfo(f"{i:05d}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


@pytest.mark.parametrize("task", ["zeroshot_classification", "zeroshot_retrieval"])
def test_build_dataset_on_a_wds_tree_matches_jax(task, tmp_path):
    from clip_benchmark.datasets import builder as jbuild
    from clip_benchmark.models import _addinverse_transform as jtransform
    from bcosification_tpu.data.loader import DataLoader as JLoader
    from bcosification_tpu_torch.clip_benchmark.datasets import builder as tbuild
    from bcosification_tpu_torch.clip_benchmark.models import _addinverse_transform as ttransform
    from bcosification_tpu_torch.data.loader import DataLoader as TLoader

    retrieval = task == "zeroshot_retrieval"
    name = "flickr30k" if retrieval else "cifar10"  # the name picks the collate
    _write_wds(tmp_path / name, 7, retrieval, seed=5)
    kw = dict(root=str(tmp_path / "{dataset}"), task=task)
    jds = jbuild.build_dataset(f"wds/{name}", transform=jtransform(32), **kw)
    tds = tbuild.build_dataset(f"wds/{name}", transform=ttransform(32), **kw)
    assert (tds.classes, tds.templates) == (jds.classes, jds.templates)
    jl = JLoader(jds, 3, num_workers=1, collate_fn=jbuild.get_dataset_collate_fn(f"wds/{name}"))
    tl = TLoader(tds, 3, num_workers=1, collate_fn=tbuild.get_dataset_collate_fn(f"wds/{name}"))
    for (jx, jy), (tx, ty) in zip(jl, tl):
        np.testing.assert_array_equal(tx, jx)
        if retrieval:  # caption lists survive the collate
            assert ty == jy and all(isinstance(c, list) for c in ty)
        else:
            np.testing.assert_array_equal(ty, jy)


def test_webdataset_builder_round_trip_matches_jax(tmp_path):
    from clip_benchmark import webdataset_builder as jwb
    from clip_benchmark.datasets.builder import DummyDataset as JDummy
    from clip_benchmark.datasets.builder import build_dataset as jbuild
    from bcosification_tpu_torch.clip_benchmark import webdataset_builder as twb
    from bcosification_tpu_torch.clip_benchmark.datasets.builder import DummyDataset
    from bcosification_tpu_torch.clip_benchmark.datasets.builder import build_dataset

    assert twb.build_webdataset(DummyDataset(), str(tmp_path / "port"), max_count=10) == \
        jwb.build_webdataset(JDummy(), str(tmp_path / "jax"), max_count=10) == 4
    tds, jds = build_dataset("wds/port", root=str(tmp_path / "port")), jbuild(
        "wds/jax", root=str(tmp_path / "jax"))
    for i in range(len(jds)):
        for a, b in zip(tds[i], jds[i]):
            np.testing.assert_array_equal(a, b)


def test_model_collection_is_the_jax_one():
    from clip_benchmark import model_collection as jmc
    from bcosification_tpu_torch.clip_benchmark import model_collection as tmc

    assert tmc.model_collection == jmc.model_collection


CLI_RUNS = {
    "zeroshot": ["--dataset", "dummy"],
    "bcos_clip zeroshot": ["--dataset", "dummy", "--model_type", "bcos_clip", "--model",
                           NAME + "_attnUnpool"],
    "bcos_clip_cc3m probe": ["--dataset", "dummy", "--task", "linear_probe", "--fewshot_epochs",
                             "2", "--model_type", "bcos_clip_cc3m", "--model",
                             "resnet_50_clip_b2_noBias_randomResizedCrop_sigLip_kd_CC3M_"
                             "bcosification"],
    "retrieval": ["--dataset", "dummy_retrieval", "--recall_k", "1", "5"],
    "selection": ["--dataset", "dummy_retrieval", "--task", "image_caption_selection"],
    "probe": ["--dataset", "dummy", "--task", "linear_probe", "--fewshot_epochs", "3",
              "--val_proportion", "0.25"],
}


@pytest.mark.parametrize("run", sorted(CLI_RUNS))
def test_cli_eval_matches_jax(run, tmp_path, monkeypatch):
    """``eval --model_type standard_clip --pretrained none`` (the small
    checkpoint through $CLIP_WEIGHTS_PATH; two runs take a B-cos student of
    the clip_bcosification experiments instead) in both CLIs; the port's with
    device="cpu". The JSONs' keys equal, their values within 1e-5; then
    ``build`` merges both into one CSV."""
    from clip_benchmark import cli as jcli
    from bcosification_tpu_torch.clip_benchmark import cli as tcli

    small_clip_env(tmp_path, monkeypatch)
    args = ["eval", "--model_type", "standard_clip", "--pretrained", "none", "--batch_size", "8",
            "--num_workers", "1", *CLI_RUNS[run]]
    monkeypatch.setattr(sys, "argv", ["cli", *args, "--output", str(tmp_path / "j.json"),
                                      "--feature_root", str(tmp_path / "jf")])
    jcli.main()
    tcli.main(args + ["--output", str(tmp_path / "t.json"), "--feature_root",
                      str(tmp_path / "tf")], device="cpu")
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    assert set(got) == set(want) and set(got["metrics"]) == set(want["metrics"])
    for key, value in want["metrics"].items():
        assert got["metrics"][key] == pytest.approx(value, rel=1e-5, nan_ok=True), key
    assert {k: v for k, v in got.items() if k != "metrics"} == {
        k: v for k, v in want.items() if k != "metrics"}
    tcli.main(["build", str(tmp_path / "j.json"), str(tmp_path / "t.json"), "--output",
               str(tmp_path / "b.csv")])
    with open(tmp_path / "b.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2 and rows[0].keys() == rows[1].keys()


def test_standard_clip_vit_and_external_types_raise(tmp_path, monkeypatch):
    """standard_clip with a ViT name raises, naming ROADMAP A6 (the port has
    no CLIP ViT tower yet); the external model types raise ImportError
    without their packages, as in JAX."""
    from bcosification_tpu_torch.clip_benchmark.models import load_clip

    small_clip_env(tmp_path, monkeypatch)
    for name in ("ViT-B-32", "ViT-B/16"):
        with pytest.raises(NotImplementedError, match="A6"):
            load_clip("standard_clip", name, "openai", device="cpu")
    for model_type in ("open_clip", "ja_clip", "nllb_clip"):
        try:
            __import__({"ja_clip": "japanese_clip"}.get(model_type, "open_clip"))
            continue  # the package is installed here: nothing to refuse
        except ImportError:
            pass
        with pytest.raises(ImportError):
            load_clip(model_type, "RN50", "openai", device="cpu")


def test_probe_grid_drives_the_port_cli(tmp_path, monkeypatch):
    """The probe sweeps' grids are the JAX package's, and run_probe_grid
    drives the port's cli.run on the device it is given (one real grid
    point on the CPU, then the resume skips it)."""
    from clip_benchmark.probe_benchmark import laion5b_fewshot_experiments as jl5
    from clip_benchmark.probe_benchmark import scaling_experiments as jse
    from bcosification_tpu_torch.clip_benchmark.probe_benchmark import common
    from bcosification_tpu_torch.clip_benchmark.probe_benchmark import (
        laion5b_fewshot_experiments as tl5,
    )
    from bcosification_tpu_torch.clip_benchmark.probe_benchmark import (
        scaling_experiments as tse,
    )

    for j, t in ((jse, tse), (jl5, tl5)):
        argv = ["--dry_run", "--data_dir", str(tmp_path / "dry")]
        assert t.main(argv) == j.main(argv)
    small_clip_env(tmp_path, monkeypatch)
    kw = dict(models=["RN50,none"], datasets=["dummy"], ks=[-1], lrs=[0.1], epoch_vals=[2],
              batch_sizes=[8], data_dir=str(tmp_path / "grid"), dataset_root_fn=lambda d: "root",
              feature_root=str(tmp_path / "features"), device="cpu")
    (out,) = common.run_probe_grid(**kw)
    assert set(json.loads(open(out).read())["metrics"]) >= {"lp_acc1", "weight_decay"}
    assert common.run_probe_grid(**kw) == []  # resumed: nothing left to run
