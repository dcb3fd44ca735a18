"""The port's linear probe (``bcosification_tpu_torch.clip_benchmark.metrics.
linear_probe``) against the JAX package's on the CPU, on the same seeded
features:

- ``train_linear_head`` (torch AdamW with optax.adamw's arithmetic, the lr
  set by hand from the count 0) after 3 epochs at two weight decays: w and b
  within 1e-5 of the optax head (relative norm);
- ``openai_wd_sweep``'s chosen weight decay: equal;
- ``evaluate`` from cached features (the ``--skip_load`` route) with and
  without ``fewshot_k`` and with a validation split: the result dicts equal,
  the insufficient-data ``None`` included; ``featurize``'s cache files equal;
- the acc5 gate on the highest test class id (``y_test.max() >= 5``).
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _features(n, d=16, classes=4, seed=0, spread=1.5):
    """Normalised features of ``classes`` gaussian clusters and their labels."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((classes, d)) * spread
    y = rng.integers(0, classes, n).astype(np.int32)
    x = (centres[y] + rng.standard_normal((n, d))).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True), y


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_train_linear_head_matches_jax(weight_decay):
    from clip_benchmark.metrics import linear_probe as jlp
    from bcosification_tpu_torch.clip_benchmark.metrics import linear_probe as tlp

    x, y = _features(150)
    kw = dict(lr=0.1, epochs=3, batch_size=32, weight_decay=weight_decay, seed=3)
    jw, jb = jlp.train_linear_head(x, y, 4, **kw)
    tw, tb = tlp.train_linear_head(x, y, 4, device="cpu", **kw)
    assert _rel(tw.numpy(), np.asarray(jw)) <= 1e-5
    assert _rel(tb.numpy(), np.asarray(jb)) <= 1e-5


def test_openai_wd_sweep_chooses_the_jax_weight_decay():
    """The 7 + 4 x 3 heads of the sweep on features where the decay matters
    (overlapping clusters, a small train split)."""
    from clip_benchmark.metrics import linear_probe as jlp
    from bcosification_tpu_torch.clip_benchmark.metrics import linear_probe as tlp

    x, y = _features(160, spread=0.6, seed=1)
    args = (x[:100], y[:100], x[100:], y[100:], 4, 0.1, 4, 25, 0)
    want = jlp.openai_wd_sweep(*args)
    got = tlp.openai_wd_sweep(*args, device="cpu")
    assert got == want


def test_wd_grid_and_cosine_lr_are_the_jax_ones():
    from clip_benchmark.metrics import linear_probe as jlp
    from bcosification_tpu_torch.clip_benchmark.metrics import linear_probe as tlp

    assert tlp.reference_wd_grid() == jlp.reference_wd_grid()
    j, t = jlp.cosine_lr(0.1, 3, 20), tlp.cosine_lr(0.1, 3, 20)
    assert [t(s) for s in range(20)] == [j(s) for s in range(20)]


def _write_cache(root, model_id, dataset, splits, seed=2, n_test=40):
    """Cached features of the ``--skip_load`` route: <root>/<model>_<data>_norm_<split>_{x,y}.npy."""
    x, y = _features(120 + n_test, seed=seed, classes=6)
    parts = {"train": (x[:100], y[:100]), "val": (x[100:120], y[100:120]),
             "test": (x[120:], y[120:])}
    root.mkdir(parents=True, exist_ok=True)
    for split in splits:
        np.save(root / f"{model_id}_{dataset}_norm_{split}_x.npy", parts[split][0])
        np.save(root / f"{model_id}_{dataset}_norm_{split}_y.npy", parts[split][1])


@pytest.mark.parametrize("fewshot_k", [-1, 3, 60], ids=["full", "3shot", "insufficient"])
def test_evaluate_from_cached_features_matches_jax(tmp_path, fewshot_k):
    """--skip_load's route (no bundle, no loaders): the fewshot subsample,
    the insufficient-data None (60 shots of a class that has fewer), the
    result keys and values."""
    from clip_benchmark.metrics import linear_probe as jlp
    from bcosification_tpu_torch.clip_benchmark.metrics import linear_probe as tlp

    _write_cache(tmp_path, "m", "d", ("train", "test"))
    kw = dict(fewshot_k=fewshot_k, fewshot_lr=0.1, fewshot_epochs=4, batch_size=16,
              feature_root=str(tmp_path), model_id="m", dataset_name="d", seed=0)
    want = jlp.evaluate(None, None, None, **kw)
    got = tlp.evaluate(None, None, None, device="cpu", **kw)
    if fewshot_k == 60:
        assert want is None and got is None
    else:
        assert got is not None and set(got) == set(want)
        for key, value in want.items():
            assert got[key] == pytest.approx(value, abs=0.0, nan_ok=True), key


class _Bundle:
    """An image 'encoder' that is the identity: the loader's images are the
    features (3-D for attn-unpool's mean over locations)."""

    device = torch.device("cpu")

    def images(self, images):
        return torch.from_numpy(np.asarray(images, np.float32))

    def encode_image(self, images):
        return images


def test_evaluate_with_a_validation_split_matches_jax(tmp_path):
    """The full protocol through featurize (3-D features mean-pooled, then
    normalised), the cache files, the weight-decay sweep on the validation
    loader and the final head on train + val."""
    from clip_benchmark.metrics import linear_probe as jlp
    from bcosification_tpu_torch.clip_benchmark.metrics import linear_probe as tlp

    rng = np.random.default_rng(4)
    x, y = _features(200, classes=6, seed=4, spread=0.8)
    x3 = (x[:, None, :] + 0.1 * rng.standard_normal((200, 3, 16))).astype(np.float32)

    def loader(lo, hi):
        return [(x3[i:i + 16], y[i:i + 16]) for i in range(lo, hi, 16)]

    out = {}
    for name, lib, bundle, kw in (("jax", jlp, _Bundle(), {}),
                                  ("port", tlp, _Bundle(), {"device": "cpu"})):
        out[name] = lib.evaluate(bundle, loader(0, 112), loader(144, 200), fewshot_epochs=3,
                                 batch_size=16, feature_root=str(tmp_path / name),
                                 model_id="m", dataset_name="d", val_loader=loader(112, 144),
                                 **kw)
    assert out["port"] == out["jax"]
    for split in ("train", "val", "test"):
        for part in ("x", "y"):
            f = f"m_d_norm_{split}_{part}.npy"
            np.testing.assert_array_equal(np.load(tmp_path / "port" / f),
                                          np.load(tmp_path / "jax" / f))


@pytest.mark.parametrize("top_class", [4, 5])
def test_acc5_gate_on_the_highest_test_class(tmp_path, top_class):
    """acc5 is reported iff the test split's highest class id is >= 5 (the
    reference's gate), NaN otherwise, as in JAX."""
    from clip_benchmark.metrics import linear_probe as jlp
    from bcosification_tpu_torch.clip_benchmark.metrics import linear_probe as tlp

    _write_cache(tmp_path, "m", "d", ("train", "test"))
    y_test = np.load(tmp_path / "m_d_norm_test_y.npy")
    np.save(tmp_path / "m_d_norm_test_y.npy", np.minimum(y_test, top_class).astype(np.int32))
    kw = dict(fewshot_epochs=2, batch_size=16, feature_root=str(tmp_path), model_id="m",
              dataset_name="d")
    want = jlp.evaluate(None, None, None, **kw)
    got = tlp.evaluate(None, None, None, device="cpu", **kw)
    assert np.isnan(got["lp_acc5"]) == (top_class < 5) == np.isnan(want["lp_acc5"])
    assert got == pytest.approx(want, nan_ok=True)
