"""The port's explanation API (explain/core.py) against the JAX package's, on
the CPU in fp32, on the same weights (the calibrated small flagship of
torch_port_helpers): gradient_to_image, explain, make_explain_fn, attribute
and attribute_selection. Tolerance 1e-5: on the same W, gradient_to_image
agrees entry by entry (absolute; entries lie in [0, 1]); W from the two
packages, and the RGBA image made from it, agree in the norm (relative),
since the fold pos / (pos + inv) passes W's per-entry rounding differences
on. Predictions and classes are equal. The port caches no explain function,
so it keeps no model alive after its caller drops it."""
import gc
import weakref

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bcosification_tpu.explain import core as jcore
from bcosification_tpu_torch.explain import core as tcore
from torch_port_helpers import small_pair

torch.set_num_threads(1)
SIZE = 32


@pytest.fixture(scope="module")
def pair():
    return small_pair("resnet50", ("bottleneck", (1, 1)), SIZE, seed=3)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _jax_explain_mode(net, variables):
    return lambda xx: net.apply(variables, xx, train=False, explain=True)


@pytest.mark.parametrize("smooth,percentile", [(15, 99.5), (0, 90.0), (5, 50.0)])
def test_gradient_to_image_matches_jax(smooth, percentile):
    rng = np.random.default_rng(smooth)
    image = rng.random((SIZE, SIZE, 6)).astype(np.float32)
    w = rng.standard_normal((SIZE, SIZE, 6)).astype(np.float32)
    want = np.asarray(jcore.gradient_to_image(jnp.asarray(image), jnp.asarray(w), smooth,
                                              percentile))
    got = tcore.gradient_to_image(torch.from_numpy(image), torch.from_numpy(w), smooth,
                                  percentile).numpy()
    assert got.shape == want.shape == (SIZE, SIZE, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert got.min() >= 0 and got.max() <= 1


def test_gradient_to_image_rejects_a_batch():
    with pytest.raises(ValueError, match="H, W, 6"):
        tcore.gradient_to_image(torch.zeros(1, 8, 8, 6), torch.zeros(1, 8, 8, 6))


def test_explain_matches_jax(pair):
    net, variables, tnet, x = pair
    want = jcore.explain(net, variables, jnp.asarray(x[:1]))
    got = tcore.explain(tnet, torch.from_numpy(x[:1]), device="cpu")
    assert got["prediction"] == want["prediction"]
    assert got["explained_class_idx"] == want["explained_class_idx"]
    assert _rel(got["dynamic_linear_weights"], want["dynamic_linear_weights"]) <= 1e-5
    assert _rel(got["explanation"], want["explanation"]) <= 1e-5
    np.testing.assert_allclose(got["contribution_map"].numpy(),
                               np.asarray(want["contribution_map"]), rtol=1e-4, atol=1e-6)


def test_explain_rejects_non_4d_input(pair):
    _, _, tnet, x = pair
    with pytest.raises(ValueError, match="4-dimensional"):
        tcore.explain(tnet, torch.from_numpy(x[0]), device="cpu")


@pytest.mark.parametrize("fast", ["auto", False])
@pytest.mark.parametrize("idx", [None, 4])
def test_make_explain_fn_matches_jax(pair, fast, idx):
    net, variables, tnet, x = pair
    want = jcore.make_explain_fn(net, fast=fast)(variables, jnp.asarray(x), idx)
    got = tcore.make_explain_fn(tnet, fast=fast)(torch.from_numpy(x), idx, device="cpu")
    for key in ("prediction", "explained_class_idx"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert _rel(got["dynamic_linear_weights"], want["dynamic_linear_weights"]) <= 1e-5
    assert _rel(got["explanation"], want["explanation"]) <= 1e-5
    assert got["explanation"].shape == (2, SIZE, SIZE, 4)


def test_auto_routes_through_the_fast_pass(pair, monkeypatch):
    from bcosification_tpu_torch.explain import fast_resnet

    _, _, tnet, x = pair
    calls = []
    real = fast_resnet.fast_dynamic_linear_weights
    monkeypatch.setattr(fast_resnet, "fast_dynamic_linear_weights",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tcore.make_explain_fn(tnet, with_image=False)(torch.from_numpy(x), device="cpu")
    assert calls == [1]


def test_make_explain_fn_without_image_gives_the_same_weights(pair):
    _, _, tnet, x = pair
    with_image = tcore.make_explain_fn(tnet)(torch.from_numpy(x), device="cpu")
    without = tcore.make_explain_fn(tnet, with_image=False)(torch.from_numpy(x), device="cpu")
    assert "explanation" not in without and "explanation" in with_image
    torch.testing.assert_close(without["dynamic_linear_weights"],
                               with_image["dynamic_linear_weights"], rtol=0, atol=0)


class _Linear6(torch.nn.Module):
    """A linear model on [N, H, W, 6] input, called as model(x, explain=...)."""

    def __init__(self, size):
        super().__init__()
        self.fc = torch.nn.Linear(size * size * 6, 10)

    def forward(self, x, explain=False):
        return self.fc(x.flatten(1))


def test_explain_keeps_no_reference_to_the_model():
    model = _Linear6(8)
    ref = weakref.ref(model)
    x = torch.from_numpy(np.random.default_rng(0).random((1, 8, 8, 6)).astype(np.float32))
    out = tcore.explain(model, x, device="cpu")
    # a linear model's W is its weight row of the explained class
    torch.testing.assert_close(out["dynamic_linear_weights"].flatten(),
                               model.fc.weight[out["explained_class_idx"]].detach())
    del model
    gc.collect()
    assert ref() is None


def test_attribute_matches_jax(pair):
    net, variables, tnet, x = pair
    want = jcore.attribute(_jax_explain_mode(net, variables), jnp.asarray(x), 3)
    got = tcore.attribute(lambda t: tnet(t, explain=True), torch.from_numpy(x), 3,
                          device="cpu")
    assert _rel(got, want) <= 1e-5


def test_attribute_selection_matches_jax_with_one_backward(pair, monkeypatch):
    net, variables, tnet, x = pair
    targets = [1, 3, 8]
    want = jcore.attribute_selection(_jax_explain_mode(net, variables), jnp.asarray(x[:1]),
                                     targets)
    backwards = []
    grad = torch.autograd.grad
    monkeypatch.setattr(torch.autograd, "grad",
                        lambda *a, **k: backwards.append(1) or grad(*a, **k))
    got = tcore.attribute_selection(lambda t: tnet(t, explain=True), torch.from_numpy(x[:1]),
                                    targets, device="cpu")
    assert backwards == [1]
    assert got.shape == (3, SIZE, SIZE, 6)
    for t in range(len(targets)):
        assert _rel(got[t], want[t]) <= 1e-5


def test_plot_contribution_map():
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    cm = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 8)).astype(np.float32))
    ax, im = tcore.plot_contribution_map(cm)
    assert im.get_array().shape == (8, 8)
    with pytest.raises(ValueError):
        tcore.plot_contribution_map(cm[None])
