"""The ViT entries of the port's model zoo (``models/pretrained.py``) against
the JAX package's registry on the CPU, in fp32, on the same weights:

- ``load_model(name, pretrained=False, num_classes=10)`` of the B-cos
  ``simple_vit_ti_patch16_224`` and ``vitc_ti_patch1_14`` and of their
  ``standard_*`` baselines, the archs cut to the small nets of
  test_torch_vit_final (dim 32, depth 2, 32x32) in both packages for the
  call, JAX variables drawn with numpy from a seed and carried across by
  bcosify/from_jax.py: logits and the generic W (autograd) within 1e-5;
  the hand-scheduled pass (``explain/fast_vit.py``) on the B-cos entries
  equal to the generic W (1e-5) and served by ``export_explain``; on the
  standard baselines the hand-scheduled pass of ``explain/fast_vit_standard.py``,
  whose W equals the JAX package's generic W (1e-5) and whose exported
  program equals the eager pass;
- every ViT entry at full width by shapes only: the port's meta build
  against the JAX package's ``abstract_init`` tree;
- the release URLs of every registered name equal to the JAX package's.
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bcosification_tpu.models import pretrained as jpretrained
from bcosification_tpu_torch.bcosify.from_jax import load_jax_variables
from bcosification_tpu_torch.explain import fast_vit, fast_vit_standard
from bcosification_tpu_torch.models import pretrained
from bcosification_tpu_torch.utils.init_mode import abstract_init
from test_torch_training import _rel
from test_torch_vit_final import NUM_CLASSES, _jax_explain, images, randomized, small_archs
from test_torch_zoo_cnn import _jax_shapes

torch.set_num_threads(1)
NAMES = ["simple_vit_ti_patch16_224", "vitc_ti_patch1_14",
         "standard_simple_vit_ti_patch16_224", "standard_vitc_ti_patch1_14"]
VIT_NAMES = [n for n in pretrained.list_available() if "vit" in n]


def zoo_pair(name, seed=0):
    """(jax net, jax variables, port net on the CPU) of entry ``name`` at the
    small size, on the same weights drawn from ``seed``."""
    with small_archs(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        net, variables = jpretrained.load_model(name, pretrained=False, num_classes=NUM_CLASSES)
        tnet = pretrained.load_model(name, pretrained=False, num_classes=NUM_CLASSES,
                                     device="cpu")
    variables_np = randomized(variables, seed)
    load_jax_variables(tnet, variables_np)
    return net, jax.tree_util.tree_map(jnp.asarray, variables_np), tnet


@pytest.fixture(scope="module")
def pairs():
    return {name: zoo_pair(name, seed=i) for i, name in enumerate(NAMES)}


def _images(name, n, seed):
    return images(name if name.startswith("standard_") else f"bcos_{name}", n, seed)


@pytest.mark.parametrize("name", NAMES)
def test_entry_matches_jax(pairs, name):
    """Logits and the generic W within 1e-5 of JAX's registry entry; the
    B-cos entries carry the logit layer of bias log(1 / (nc - 1))."""
    from bcosification_tpu_torch.explain.core import dynamic_linear_weights

    net, variables, tnet = pairs[name]
    x = _images(name, 2, 3)
    want = np.asarray(jax.jit(lambda t: net.apply(variables, t, train=False))(jnp.asarray(x)),
                      np.float64)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).double().numpy()
    bcos = not name.startswith("standard_")
    assert tnet.with_logit_layer == bcos
    bias = tnet.logit_layer.logit_bias if bcos else 0.0
    assert bias == pytest.approx(np.log(1.0 / (NUM_CLASSES - 1)) if bcos else 0.0)
    assert np.abs(want - bias).max() > 1e-2
    assert _rel(got - bias, want - bias) <= 1e-5
    jl, js, jw = _jax_explain(net, variables, x)
    logits, sel, w = dynamic_linear_weights(lambda t: tnet(t, explain=True),
                                            torch.from_numpy(x), device="cpu")
    np.testing.assert_array_equal(sel.numpy(), np.asarray(js))
    assert _rel(w.numpy(), jw) <= 1e-5


@pytest.mark.parametrize("name", NAMES)
def test_fast_pass_and_export(pairs, name):
    """The B-cos entries: fast_vit admits the zoo's build, its W equals the
    generic one (1e-5) and the exported program the eager pass. The
    standard baselines: fast_vit_standard admits them (fast_vit does not),
    their W equals the JAX package's generic W on the same weights (1e-5),
    and the exported program the eager pass."""
    from bcosification_tpu_torch import serving
    from bcosification_tpu_torch.explain.core import dynamic_linear_weights

    net, variables, tnet = pairs[name]
    x = torch.from_numpy(_images(name, 2, 4))
    size = x.shape[1]
    standard = name.startswith("standard_")
    fast = fast_vit_standard if standard else fast_vit
    assert fast.supports(tnet) and not (fast_vit if standard else fast_vit_standard).supports(tnet)
    ml, ms, mw = dynamic_linear_weights(lambda t: tnet(t, explain=True), x, device="cpu")
    fl, fs, fw = fast.fast_dynamic_linear_weights(tnet, x, device="cpu")
    np.testing.assert_array_equal(fs.numpy(), ms.numpy())
    assert _rel(fw.numpy(), mw.numpy()) <= 1e-5
    if standard:
        jl, js, jw = _jax_explain(net, variables, x.numpy())
        np.testing.assert_array_equal(fs.numpy(), np.asarray(js))
        assert _rel(fw.numpy(), np.asarray(jw)) <= 1e-5
        assert _rel(fl.double().numpy(), np.asarray(jl, np.float64)) <= 1e-5
    program = serving.load_serialized(serving.export_explain(
        tnet, input_size=size, channels=3 if standard else 6, device="cpu"))
    pl, ps, pw = program.call(x)
    assert torch.equal(ps, fs) and _rel(pw.numpy(), fw.numpy()) <= 1e-6


@pytest.mark.parametrize("name", VIT_NAMES)
def test_meta_build_shapes_match_jax(name):
    """The port's meta build (no memory, no init) has the JAX tree's shapes."""
    with abstract_init():
        net = pretrained.load_model(name, pretrained=False)
    state = net.state_dict()
    assert all(t.device.type == "meta" for t in state.values())
    assert {k: tuple(t.shape) for k, t in state.items()} == _jax_shapes(name)


def test_release_urls_match_jax():
    """pretrained_url of every registered name, and of the experiment names,
    equals the JAX package's; the table is JAX's asset."""
    assert pretrained.pretrained_urls() == jpretrained.pretrained_urls()
    names = pretrained.list_available()
    names += ["resnet_50", "densenet_121", "bcos_simple_vit_b_patch16_224", "no_such_model"]
    for name in names:
        assert pretrained.pretrained_url(name) == jpretrained.pretrained_url(name), name
    assert pretrained.pretrained_url("resnet50").endswith(".pth")


def test_bcos_sequential_passes_the_flags(pairs):
    """BcosSequential (the reference's wrapper of the released ViTs, hence
    their "0." keys) hands train/explain to the layers whose forward takes
    them and calls a plain function without: the wrapped zoo ViT, then a
    doubling, gives twice the ViT's logits and W."""
    from bcosification_tpu_torch.explain.core import dynamic_linear_weights
    from bcosification_tpu_torch.modules.containers import BcosSequential, call_with_flags

    class Double(torch.nn.Module):
        def forward(self, t):
            return 2.0 * t

    _, _, tnet = pairs["simple_vit_ti_patch16_224"]
    seq = BcosSequential(tnet, Double())
    assert all(k.startswith("0.") for k in seq.state_dict())
    x = torch.from_numpy(_images("simple_vit_ti_patch16_224", 2, 6))
    ls, ss, ws = dynamic_linear_weights(lambda t: seq(t, explain=True), x, device="cpu")
    lv, sv, wv = dynamic_linear_weights(lambda t: tnet(t, explain=True), x, device="cpu")
    assert torch.equal(ss, sv) and torch.equal(ls, 2.0 * lv) and torch.equal(ws, 2.0 * wv)
    seen = []
    call_with_flags(lambda t, train: seen.append(train) or t, x, train=True, explain=True)
    assert seen == [True]
