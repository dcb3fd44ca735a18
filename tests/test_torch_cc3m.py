"""The port's CC3M tar-shard pipeline (``data/cc3m.py``) and its experiment
configs against the JAX package, on the CPU:

- ``expand_shard_pattern`` and ``iter_tar_samples`` give the same lists;
- ``WdsPipeline`` in image, text and pair modes, batch for batch equal to
  the JAX ``WdsPipeline(native_decode=False)`` for the same shards, seed,
  epoch and shuffle buffer: keys, images bit for bit (the eval preset, and
  the train preset with the same per-thread rng installed in both), token
  ids; ``repeat`` and its reshuffled passes;
- ``CC3MDataModule``: the seed reaches the pipeline, a missing shard raises
  FileNotFoundError, ``native_decode=True`` and ``split_shards_by_process``
  raise naming their slices;
- the CC3M/clip_bcosification grid: the JAX names, each config equal
  through ``sanitize_config``, built through ``Experiment``;
- ``data/synthetic.py``'s CC3M tree, read by the data module.
"""
import io
import re
import shutil
import tarfile

import numpy as np
import pytest
import torch

from bcosification_tpu.data import cc3m as jcc3m
from bcosification_tpu.data import presets as jpresets
from bcosification_tpu.data import transforms as jT
from bcosification_tpu_torch.data import cc3m
from bcosification_tpu_torch.data import presets as tpresets
from bcosification_tpu_torch.data import transforms as tT

torch.set_num_threads(1)

NAME = "resnet_50_clip_b2_noBias_randomResizedCrop_sigLip_kd_CC3M_bcosification"


def write_shard(path, keys, rng):
    """A tar of (jpg, txt) pairs under ``keys``; the images vary in size."""
    from PIL import Image

    with tarfile.open(path, "w") as tf:
        for key in keys:
            h, w = rng.integers(24, 48, size=2)
            arr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="JPEG")
            caption = f"a photo of thing {key}, café n°{int(key) % 7}".encode()
            for ext, data in (("jpg", buf.getvalue()), ("txt", caption)):
                info = tarfile.TarInfo(f"{key}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    return str(path)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Three shards of 7 samples each."""
    root = tmp_path_factory.mktemp("shards")
    rng = np.random.default_rng(0)
    return [write_shard(root / f"{s:05d}.tar", [f"{7 * s + i:05d}" for i in range(7)], rng)
            for s in range(3)]


def _batches(pipe, n=None):
    out = []
    for batch in pipe:
        out.append(batch)
        if n is not None and len(out) == n:
            break
    return out


def _assert_same(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["key"] == w["key"]
        if "image" in w:
            assert g["image"].dtype == w["image"].dtype
            np.testing.assert_array_equal(g["image"], w["image"])
        if "text" in w:
            np.testing.assert_array_equal(g["text"], w["text"])


@pytest.mark.parametrize("pattern", ["/x/{00000..00002}.tar", "/x/plain.tar",
                                     "s3/training/{00000..00331}.tar", "/x/{7..11}-a.tar"])
def test_expand_shard_pattern_matches_jax(pattern):
    assert cc3m.expand_shard_pattern(pattern) == jcc3m.expand_shard_pattern(pattern)


def test_iter_tar_samples_matches_jax(shards):
    got, want = list(cc3m.iter_tar_samples(shards[1])), list(jcc3m.iter_tar_samples(shards[1]))
    assert len(got) == 7 and got == want
    assert all(sorted(s) == ["__key__", "jpg", "txt"] for s in got)


def _pipes(shards, mode, shuffle_buffer, preset, seed=3, epoch=1, **kw):
    """(port pipeline, JAX pipeline) over the same shards, with the same
    settings; the JAX one on PIL (native_decode=False)."""
    from bcosification_tpu.clip.tokenizer import tokenize as jtokenize
    from bcosification_tpu_torch.clip.tokenizer import tokenize

    if preset == "eval":
        tt = tpresets.CLIPBcosImageNetClassificationPresetEval(crop_size=16, resize_size=20)
        jt = jpresets.CLIPBcosImageNetClassificationPresetEval(crop_size=16, resize_size=20)
    else:
        tt = tpresets.CLIPBcosImageNetClassificationPresetTrain(crop_size=16)
        jt = jpresets.CLIPBcosImageNetClassificationPresetTrain(crop_size=16)
    t = cc3m.WdsPipeline(shards, 4, mode=mode, transform=tt, tokenizer=tokenize,
                         shuffle_buffer=shuffle_buffer, seed=seed, **kw)
    j = jcc3m.WdsPipeline(shards, 4, mode=mode, transform=jt, tokenizer=jtokenize,
                          shuffle_buffer=shuffle_buffer, seed=seed, native_decode=False, **kw)
    t.set_epoch(epoch)
    j.set_epoch(epoch)
    return t, j


@pytest.mark.parametrize("shuffle_buffer", [0, 5], ids=["in_order", "shuffled"])
@pytest.mark.parametrize("mode", ["image", "text", "pair"])
def test_wds_pipeline_matches_jax(shards, mode, shuffle_buffer):
    t, j = _pipes(shards, mode, shuffle_buffer, "eval")
    got, want = _batches(t), _batches(j)
    assert len(got) == 21 // 4  # partial batches dropped
    _assert_same(got, want)
    if mode != "image":
        assert got[0]["text"].shape == (4, 77)
    if mode != "text":
        assert got[0]["image"].shape == (4, 16, 16, 3)


def test_wds_pipeline_train_preset_matches_jax(shards):
    """The train preset's random crops and flips, drawn from the same
    per-thread Generator in both packages: the same pixels."""
    t, j = _pipes(shards, "image", 5, "train", drop_partial=False)
    try:
        tT.set_sample_rng(np.random.default_rng(9))
        got = _batches(t)
        jT.set_sample_rng(np.random.default_rng(9))
        want = _batches(j)
    finally:
        tT.set_sample_rng(None)
        jT.set_sample_rng(None)
    assert sum(len(b["key"]) for b in got) == 21  # the partial batch kept
    _assert_same(got, want)


def test_order_depends_on_seed_and_epoch(shards):
    def keys(seed, epoch):
        t, _ = _pipes(shards, "text", 5, "eval", seed=seed, epoch=epoch)
        return [k for b in t for k in b["key"]]

    base = keys(3, 1)
    assert base == keys(3, 1)
    assert base != keys(4, 1) and base != keys(3, 2)


def test_repeat_matches_jax(shards):
    """``repeat`` loops the stream, each pass reshuffled from (seed, epoch,
    pass), as the JAX pipeline does."""
    t, j = _pipes(shards, "text", 5, "eval", repeat=True)
    got, want = _batches(t, 12), _batches(j, 12)
    _assert_same(got, want)
    keys = [tuple(b["key"]) for b in got]
    assert keys[:5] != keys[5:10]  # one pass is 5 batches; the next one differs
    seen = [k for b in keys for k in b]
    assert set(seen) == {f"{i:05d}" for i in range(21)}
    t.repeat = False
    assert len(_batches(t)) == 5


def _cc3m_tree(tmp_path, shards):
    root = tmp_path / "cc3m"
    (root / "training").mkdir(parents=True)
    (root / "validation").mkdir()
    for i in range(332):
        (root / "training" / f"{i:05d}.tar").symlink_to(shards[i % 3])
    for i in range(2):
        shutil.copy(shards[i], root / "validation" / f"{i:05d}.tar")
    return root


def _datamodule(root, **extra):
    preset = tpresets.CLIPBcosImageNetClassificationPresetEval(crop_size=16, resize_size=20)
    return cc3m.CC3MDataModule({"data_root": str(root), "batch_size": 4,
                                "train_transform": preset, "test_transform": preset, **extra})


def test_cc3m_datamodule(tmp_path, shards):
    """The registered module over the 332 + 2 shard layout: the run's seed
    reaches the train pipeline, both pipelines pair images with tokens, and
    validation streams its two shards in order."""
    from bcosification_tpu_torch.data.datamodules import ClassificationDataModule

    assert ClassificationDataModule.registry()["CC3M"] is cc3m.CC3MDataModule
    dm = _datamodule(_cc3m_tree(tmp_path, shards))
    dm.setup("fit")
    loader = dm.train_dataloader(seed=5)
    assert loader.seed == 5 and loader.mode == "pair" and loader.shuffle_buffer == 1000
    assert len(loader.shards) == 332 and not loader.repeat
    first = next(iter(loader))
    assert first["image"].shape == (4, 16, 16, 3) and first["text"].shape == (4, 77)
    val = list(dm.val_dataloader())
    assert [k for b in val for k in b["key"]] == [f"{i:05d}" for i in range(12)]
    assert dm.test_dataloader() is dm.val_dataloader()


def test_missing_shard_raises(tmp_path, shards):
    root = _cc3m_tree(tmp_path, shards)
    (root / "validation" / "00001.tar").unlink()
    dm = _datamodule(root)
    dm.setup("test")
    with pytest.raises(FileNotFoundError, match="00001.tar"):
        list(dm.val_dataloader())


def test_native_decode_raises_naming_its_slice(shards):
    with pytest.raises(NotImplementedError, match="slice 6e"):
        cc3m.WdsPipeline(shards, 4, native_decode=True)
    # "auto" takes PIL, as the JAX package does without its C++ library
    assert cc3m.WdsPipeline(shards, 4, native_decode="auto").native_decode == "auto"


def test_split_shards_by_process_raises(tmp_path, shards):
    with pytest.raises(NotImplementedError, match="slice 8"):
        _datamodule(tmp_path, split_shards_by_process=True)


# --------------------------------------------------------------------------
# the CC3M/clip_bcosification grid
# --------------------------------------------------------------------------
_OBJECT_AT = re.compile(r"<([\w.]+\.)?(\w+) object at 0x[0-9a-f]+>")


def _without_class_paths(value):
    if isinstance(value, dict):
        return {k: _without_class_paths(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_without_class_paths(v) for v in value]
    if isinstance(value, str):
        return _OBJECT_AT.sub(r"<\2>", value)
    return value


def _grids():
    from bcosification_tpu.experiments.CC3M.clip_bcosification import (
        experiment_parameters as jparams,
    )
    from bcosification_tpu_torch.experiments.CC3M.clip_bcosification import (
        experiment_parameters as tparams,
    )

    return jparams.CONFIGS, tparams.CONFIGS


def test_cc3m_grid_matches_jax():
    from bcosification_tpu.experiments.utils import config_utils as jcu
    from bcosification_tpu_torch.experiments.utils import config_utils as tcu

    jconfigs, tconfigs = _grids()
    assert sorted(tconfigs) == sorted(jconfigs) and len(tconfigs) == 6
    assert NAME in tconfigs
    for name in jconfigs:
        want = _without_class_paths(jcu.sanitize_config(jconfigs[name]))
        assert _without_class_paths(tcu.sanitize_config(tconfigs[name])) == want, name


def test_cc3m_experiment_builds_the_student(monkeypatch):
    """Experiment("CC3M", "clip_bcosification", ...) finds the config, the
    ImageNet model factory (here at random init, on the CPU) and the CC3M
    data module; its checkpoints rank by val_loss."""
    from bcosification_tpu_torch.experiments.utils.experiment_utils import Experiment

    monkeypatch.delenv("CLIP_WEIGHTS_PATH", raising=False)
    monkeypatch.delenv("CLIP_WEIGHTS_DIR", raising=False)
    monkeypatch.setenv("HOME", "/nonexistent")
    exp = Experiment("CC3M", "clip_bcosification", NAME)
    assert exp.config["clip_kd"] and exp._is_clip_kd()
    with pytest.warns(UserWarning, match="random init"):
        net = exp.get_model(device="cpu")
    assert net.model.attnpool.c_proj.features == 1024 and not net.with_logit_layer
    dm = exp.get_datamodule(data_root="/nonexistent")
    assert isinstance(dm, cc3m.CC3MDataModule) and dm.batch_size == 64


def test_synthetic_cc3m_tree(tmp_path):
    """data/synthetic.py's CC3M tree: 332 train shards, the first few
    distinct and the rest links to them, 2 val shards, each a tar of JPEG +
    caption pairs the data module reads; the same seed writes the same
    bytes."""
    from bcosification_tpu_torch.data.synthetic import write_cc3m_tree

    write_cc3m_tree(tmp_path / "a", n_distinct=2, n_pairs=3, size=(40, 30), seed=1)
    write_cc3m_tree(tmp_path / "b", n_distinct=2, n_pairs=3, size=(40, 30), seed=1)
    train = sorted((tmp_path / "a" / "training").iterdir())
    assert len(train) == 332 and not train[1].is_symlink() and train[3].is_symlink()
    assert list(cc3m.iter_tar_samples(str(train[3]))) == list(
        cc3m.iter_tar_samples(str(train[1])))
    for split, name in (("training", "00001.tar"), ("validation", "00001.tar")):
        assert ((tmp_path / "a" / split / name).read_bytes()
                == (tmp_path / "b" / split / name).read_bytes())
    dm = _datamodule(tmp_path / "a")
    dm.setup("fit")
    (batch,) = list(dm.val_dataloader())  # 6 pairs: one batch of 4, the rest dropped
    assert batch["image"].shape == (4, 16, 16, 3) and batch["text"].shape == (4, 77)
