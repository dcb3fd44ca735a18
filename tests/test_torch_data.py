"""The port's input pipeline against the JAX package's on the CPU: on one
JPEG folder, the ImageNet data modules give bit-identical train and val
batches (images and labels) for the same seed and epoch; the
repeated-augmentation sampler draws the same indices; the Mixup, Cutmix and
SplitAndGrid collates agree under the same rng; the category lists and
the synthetic-tree writer hold."""
import numpy as np
import pytest

from bcosification_tpu import settings as jsettings
from bcosification_tpu.data import datamodules as jdm
from bcosification_tpu.data import presets as jpresets
from bcosification_tpu.data import sampler as jsampler
from bcosification_tpu.data import transforms as jT
from bcosification_tpu.data import categories as jcat
from bcosification_tpu_torch import settings as tsettings
from bcosification_tpu_torch.data import datamodules as tdm
from bcosification_tpu_torch.data import presets as tpresets
from bcosification_tpu_torch.data import sampler as tsampler
from bcosification_tpu_torch.data import transforms as tT
from bcosification_tpu_torch.data import categories as tcat
from bcosification_tpu_torch.data.synthetic import write_imagenet_tree

N_CLASSES, N_TRAIN, N_VAL, BATCH = 3, 20, 9, 4
SIZES = ((56, 48), (48, 60), (50, 50))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("imagenet")
    write_imagenet_tree(root, N_CLASSES, N_TRAIN, N_VAL, sizes=SIZES, seed=0)
    return str(root)


def _config(presets, **extra):
    return dict(train_transform=presets.ImageNetClassificationPresetTrain(crop_size=32,
                                                                           is_bcos=True),
                test_transform=presets.ImageNetClassificationPresetEval(
                    crop_size=32, resize_size=36, is_bcos=True),
                batch_size=BATCH, num_workers=3, **extra)


def _modules(tree, monkeypatch, **extra):
    monkeypatch.setattr(jsettings, "IMAGENET_PATH", tree)
    monkeypatch.setattr(tsettings, "IMAGENET_PATH", tree)
    out = []
    for dm, presets in ((jdm, jpresets), (tdm, tpresets)):
        module = dm.ImageNetDataModule(_config(presets, **extra))
        module.setup("fit")
        out.append(module)
    return out


def _assert_same_batches(jbatches, tbatches):
    assert len(jbatches) == len(tbatches) > 0
    for jb, tb in zip(jbatches, tbatches):
        assert sorted(jb) == sorted(tb) == ["image", "label"]
        for key in jb:
            assert jb[key].dtype == tb[key].dtype and jb[key].shape == tb[key].shape
            np.testing.assert_array_equal(jb[key], tb[key])


@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("ra_repetitions", [None, 3], ids=["shuffle", "ra"])
def test_train_batches_are_bit_identical(tree, monkeypatch, epoch, ra_repetitions):
    extra = {} if ra_repetitions is None else {"ra_repetitions": ra_repetitions}
    jmod, tmod = _modules(tree, monkeypatch, **extra)
    batches = []
    for module in (jmod, tmod):
        loader = module.train_dataloader(seed=7)
        loader.set_epoch(epoch)
        batches.append(list(loader))
    if ra_repetitions is not None:  # below 256 samples the RA sampler selects none
        assert batches[0] == batches[1] == []
        return
    assert len(batches[1]) == N_TRAIN // BATCH  # drop_last
    _assert_same_batches(*batches)
    assert batches[1][0]["image"].shape == (BATCH, 32, 32, 6)


def test_val_batches_are_bit_identical(tree, monkeypatch):
    jmod, tmod = _modules(tree, monkeypatch)
    jb, tb = list(jmod.val_dataloader()), list(tmod.test_dataloader())
    _assert_same_batches(jb, tb)
    assert sum(len(b["label"]) for b in tb) == N_VAL  # the ragged last batch is kept
    assert tmod.eval_dataset.classes == jmod.eval_dataset.classes


def test_epochs_and_seeds_draw_different_crops(tree, monkeypatch):
    _, tmod = _modules(tree, monkeypatch)
    first = []
    for seed, epoch in ((7, 0), (7, 1), (8, 0)):
        loader = tmod.train_dataloader(seed=seed)
        loader.set_epoch(epoch)
        first.append(next(iter(loader))["image"])
    assert not np.array_equal(first[0], first[1])
    assert not np.array_equal(first[0], first[2])


@pytest.mark.parametrize("n,reps,replicas,rank,select_all", [
    (600, 3, 1, 0, False), (600, 3, 4, 2, False), (37, 1, 2, 1, True), (300, 2, 1, 0, True)])
def test_rasampler_indices_are_equal(n, reps, replicas, rank, select_all):
    data = list(range(n))
    for epoch in (0, 3):
        samplers = [mod.RASampler(data, num_replicas=replicas, rank=rank, seed=11,
                                  repetitions=reps, select_all=select_all)
                    for mod in (jsampler, tsampler)]
        for s in samplers:
            s.set_epoch(epoch)
        j, t = (list(s) for s in samplers)
        assert j == t and len(t) == len(samplers[1])


@pytest.mark.parametrize("kind", ["mixup", "cutmix", "mixup+cutmix", "gridify"])
def test_batch_collates_are_equal(kind):
    kw = {"mixup": dict(mixup_alpha=0.2), "cutmix": dict(cutmix_alpha=1.0),
          "mixup+cutmix": dict(mixup_alpha=0.2, cutmix_alpha=1.0),
          "gridify": dict(p_gridified=0.5)}[kind]
    rng = np.random.default_rng(5)
    samples = [(rng.random((16, 12, 6)).astype(np.float32), np.int32(i % 7))
               for i in range(8)]
    outs = []
    for dm, T in ((jdm, jT), (tdm, tT)):
        collate = dm.ImageNetDataModule.get_train_collate_fn(**kw)
        for trial in range(3):
            np.random.seed(trial)  # the per-batch choice between Mixup and Cutmix
            T.set_sample_rng(np.random.default_rng((1, trial)))
            try:
                outs.append(collate(samples))
            finally:
                T.set_sample_rng(None)
    j, t = outs[:3], outs[3:]
    for jb, tb in zip(j, t):
        for key in ("image", "label"):
            np.testing.assert_array_equal(jb[key], tb[key])
    # gridify turns 4 of the 8 images into one 2x2 mosaic with a multi-hot label
    n = 5 if kind == "gridify" else 8
    assert t[0]["label"].shape == (n, 1000) and t[0]["image"].shape == (n, 16, 12, 6)


def test_transforms_and_presets_match():
    rng = np.random.default_rng(3)
    img = (rng.random((40, 52, 3)) * 255).astype(np.uint8)
    for make in (lambda P: P.ImageNetClassificationPresetTrain(crop_size=24, is_bcos=True),
                 lambda P: P.ImageNetClassificationPresetEval(crop_size=24, resize_size=28,
                                                              is_bcos=False),
                 lambda P: P.CIFAR10ClassificationPresetTrain(),
                 lambda P: P.CLIPBcosImageNetClassificationPresetEval(crop_size=24,
                                                                      resize_size=28)):
        outs = []
        for P, T in ((jpresets, jT), (tpresets, tT)):
            T.set_sample_rng(np.random.default_rng(9))
            try:
                outs.append(make(P)(img))
            finally:
                T.set_sample_rng(None)
        np.testing.assert_array_equal(outs[0], outs[1])


def test_categories_and_registry_match():
    for name in ("IMAGENET_CATEGORIES", "CIFAR10_CATEGORIES", "CIFAR100_CATEGORIES",
                 "VOC_CATEGORIES", "FASHION_MNIST_CATEGORIES", "STL10_CATEGORIES"):
        assert getattr(jcat, name) == getattr(tcat, name), name
    assert jcat.imagenet_class_index() == tcat.imagenet_class_index()
    ported = set(tdm.ClassificationDataModule.registry())
    assert ported == {"ImageNet", "CIFAR10", "CIFAR100", "FashionMNIST", "STL10", "CC3M"}
    assert ported < set(jdm.ClassificationDataModule.registry())


@pytest.mark.parametrize("key,slice_name", [("native_loader", "6e"),
                                            ("split_by_process", "slice 8")])
def test_unported_data_options_raise(key, slice_name):
    with pytest.raises(NotImplementedError, match=slice_name):
        tdm.ImageNetDataModule(_config(tpresets, **{key: True}))


def test_synthetic_tree_layout(tree):
    from bcosification_tpu_torch.data.datamodules import ImageFolder

    wnids = [tcat.imagenet_class_index()[str(i)][0] for i in range(N_CLASSES)]
    train = ImageFolder(f"{tree}/train")
    assert train.classes == sorted(wnids) and len(train) == N_TRAIN
    image, label = train[0]
    assert image.dtype == np.float32 and image.shape[-1] == 3 and label.dtype == np.int32
