"""The port's wrapper API (bcosification_tpu_torch/common.py, BcosModel) and
its lazy package surface against the JAX package's, on the CPU in fp32 on
the same weights (the calibrated small flagship of torch_port_helpers).
Tolerance 1e-5 as in test_torch_explain_api.py: logits entry by entry
(absolute), W, attributions and the RGBA image in the norm (relative);
predictions and classes are equal. The JAX wrapper's calls run under
``jax.jit`` (eager flax takes tens of seconds on the flagship)."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bcosification_tpu.common import BcosModel as JaxBcosModel
from bcosification_tpu_torch.common import BcosModel
from torch_port_helpers import small_pair

torch.set_num_threads(1)
SIZE = 32
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def models():
    net, variables, tnet, x = small_pair("resnet50", ("bottleneck", (1, 1)), SIZE, seed=5)
    return JaxBcosModel(net, variables), BcosModel(tnet), x


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("explain", [False, True])
def test_call_and_probabilities_match_jax(models, explain):
    jm, tm, x = models
    want = np.asarray(jax.jit(lambda t: jm(t, explain=explain))(jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), explain=explain)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm.to_probabilities(got).numpy(),
                               np.asarray(jm.to_probabilities(jnp.asarray(want))),
                               rtol=0, atol=1e-6)
    assert tm.device == torch.device("cpu")


def test_explanation_mode_switches_the_default_and_restores_it(models):
    jm, tm, x = models
    xt = torch.from_numpy(x)
    with torch.no_grad():
        plain, expl = tm(xt), tm(xt, explain=True)
        with tm.explanation_mode() as inside:
            assert inside is tm
            torch.testing.assert_close(tm(xt), expl, rtol=0, atol=0)
        torch.testing.assert_close(tm(xt), plain, rtol=0, atol=0)
        with pytest.raises(RuntimeError, match="inside"):
            with tm.explanation_mode():
                raise RuntimeError("inside")
        assert tm._explain_default is False and jm._explain_default is False
        torch.testing.assert_close(tm(xt), plain, rtol=0, atol=0)
    # the JAX wrapper's mode switches the same way
    with jm.explanation_mode():
        np.testing.assert_allclose(np.asarray(jax.jit(jm)(jnp.asarray(x))), expl.numpy(),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("idx", [None, 7])
def test_explain_matches_jax(models, idx):
    jm, tm, x = models
    want = jm.explain(jnp.asarray(x[:1]), idx=idx)
    got = tm.explain(torch.from_numpy(x[:1]), idx=idx)
    assert got["prediction"] == want["prediction"]
    assert got["explained_class_idx"] == want["explained_class_idx"]
    if idx is not None:
        assert got["explained_class_idx"] == idx
    assert _rel(got["dynamic_linear_weights"], want["dynamic_linear_weights"]) <= 1e-5
    assert _rel(got["explanation"], want["explanation"]) <= 1e-5
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["contribution_map"].numpy(),
                               np.asarray(want["contribution_map"]), rtol=1e-4, atol=1e-6)


def test_attribute_and_selection_match_jax(models):
    jm, tm, x = models
    want = jax.jit(lambda t: jm.attribute(t, 3))(jnp.asarray(x))
    got = tm.attribute(torch.from_numpy(x), 3)
    assert got.shape == x.shape and _rel(got, want) <= 1e-5
    targets = [0, 4, 9]
    want = jax.jit(lambda t: jm.attribute_selection(t, targets))(jnp.asarray(x[:1]))
    got = tm.attribute_selection(torch.from_numpy(x[:1]), targets)
    assert got.shape == (3, SIZE, SIZE, 6)
    for t in range(len(targets)):
        assert _rel(got[t], want[t]) <= 1e-5
    # each row is the attribution of its target on the explanation-variant forward
    torch.testing.assert_close(got[1], tm.attribute(torch.from_numpy(x[:1]), 4)[0],
                               rtol=1e-5, atol=1e-7)


def test_static_helpers_are_the_explain_core_ones(models):
    from bcosification_tpu_torch.explain import core

    _, tm, _ = models
    assert tm.gradient_to_image is core.gradient_to_image
    assert tm.plot_contribution_map is core.plot_contribution_map


_LAZY = """
import sys
import bcosification_tpu_torch as b
heavy = sorted(k for k in sys.modules if k.startswith(("matplotlib",
               "bcosification_tpu_torch.ops.cuda", "bcosification_tpu_torch.models",
               "bcosification_tpu_torch.explain", "bcosification_tpu_torch.common")))
assert not heavy, heavy
assert b.__version__ == "0.3.0", b.__version__
from bcosification_tpu_torch.common import BcosModel, gradient_to_image, plot_contribution_map
assert b.BcosModel is BcosModel and b.gradient_to_image is gradient_to_image
assert b.plot_contribution_map is plot_contribution_map
import bcosification_tpu_torch.data.presets as presets
assert b.presets is presets
for name, mod in [("transforms", "data.transforms"), ("models", "models"),
                  ("pretrained", "models.pretrained"), ("modules", "modules"),
                  ("optim", "optim"), ("settings", "settings"), ("losses", "losses"),
                  ("explain", "explain"), ("clip", "clip")]:
    assert getattr(b, name) is sys.modules["bcosification_tpu_torch." + mod], name
assert "matplotlib" not in sys.modules
try:
    b.nothing_here
except AttributeError:
    print("LAZY OK")
"""


def test_package_surface_is_lazy_and_matches_jax():
    import bcosification_tpu

    out = subprocess.run([sys.executable, "-c", _LAZY], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LAZY OK" in out.stdout
    import bcosification_tpu_torch

    assert bcosification_tpu_torch.__version__ == bcosification_tpu.__version__
