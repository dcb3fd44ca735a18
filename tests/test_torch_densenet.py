"""The PyTorch port's B-cosified DenseNet against the JAX package, on the CPU,
in fp32, on the same weights (carried across by bcosify/from_jax.py): the
small DenseNet of torch_port_helpers (growth 8, blocks (2, 2), 16 initial
features, bn_size 2, 32x32, 10 classes, BN gammas calibrated).

- the module forward (pre-logit features and logits, 1e-5) and the
  explanation through autograd (W, 1e-5);
- the hand-scheduled pass ``explain/fast_densenet.py`` against the port's
  autograd W (1e-5);
- one train step against JAX ``make_train_step`` (the tolerances of
  test_torch_training.py);
- the torchvision import: b=1 with the biases kept reproduces the torch
  model exactly, and the import is strict;
- the serving export round trip, and the recipe's Experiment building the
  full-width DenseNet-121.
"""
import copy
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_densenet_conversion import TorchMiniDenseNet, _randomize_bn
from test_torch_training import _jax_recipe, _leaves, _port_recipe, _rel, _t
from torch_port_helpers import (
    NUM_CLASSES,
    SMALL_DENSENET,
    jax_densenet,
    logit_bias,
    small_densenet_pair,
)

torch.set_num_threads(1)
SIZE = 32


@pytest.fixture(scope="module")
def pair():
    return small_densenet_pair(SIZE)


def _jax_autodiff(net, variables, x, idx=None):
    from bcosification_tpu.explain.core import dynamic_linear_weights

    def f(inp):
        return net.apply(variables, inp, train=False, explain=True)

    return dynamic_linear_weights(f, jnp.asarray(x), idx)


@pytest.mark.parametrize("explain", [False, True], ids=["eval", "explain"])
def test_module_forward_matches_jax(pair, explain):
    net, variables, tnet, x = pair
    want = np.asarray(net.apply(variables, jnp.asarray(x), train=False, explain=explain),
                      np.float64)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x), explain=explain).numpy().astype(np.float64)
    bias = logit_bias()
    # pre-logit features (the LogitLayer bias would hide sub-ulp differences)
    np.testing.assert_allclose(got - bias, want - bias, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.abs(want - bias).max() > 1e-2  # calibrated: the comparison has signal


def test_values_identical_between_explain_modes(pair):
    _, _, tnet, x = pair
    with torch.no_grad():
        assert torch.equal(tnet(torch.from_numpy(x), explain=True),
                           tnet(torch.from_numpy(x), explain=False))


def test_generic_explain_matches_jax(pair):
    """``make_explain_fn`` takes the DenseNet through autograd (fast="auto"
    picks no ResNet pass for it), as the JAX explain core does."""
    from bcosification_tpu_torch.explain import fast_resnet
    from bcosification_tpu_torch.explain.core import make_explain_fn

    net, variables, tnet, x = pair
    assert not fast_resnet.supports(tnet)
    l_a, s_a, w_a = _jax_autodiff(net, variables, x)
    out = make_explain_fn(tnet, smooth=3)(torch.from_numpy(x), device="cpu")
    np.testing.assert_array_equal(out["explained_class_idx"].numpy(), np.asarray(s_a))
    assert _rel(out["dynamic_linear_weights"].numpy(), w_a) <= 1e-5
    assert out["explanation"].shape == (2, SIZE, SIZE, 4)
    with pytest.raises(ValueError, match="unsupported"):
        make_explain_fn(tnet, fast=True)(torch.from_numpy(x), device="cpu")


@pytest.mark.parametrize("idx", [None, 3], ids=["argmax", "class3"])
def test_fast_densenet_matches_autograd_and_jax(pair, idx):
    from bcosification_tpu_torch.explain.core import dynamic_linear_weights
    from bcosification_tpu_torch.explain.fast_densenet import (
        fast_dynamic_linear_weights,
        supports,
    )

    net, variables, tnet, x = pair
    assert supports(tnet)
    xt = torch.from_numpy(x)
    logits, sel, w = fast_dynamic_linear_weights(tnet, xt, idx, device="cpu")
    l_m, s_m, w_m = dynamic_linear_weights(lambda t: tnet(t, explain=True), xt, idx,
                                           device="cpu")
    l_a, s_a, w_a = _jax_autodiff(net, variables, x, None if idx is None else jnp.asarray(idx))
    np.testing.assert_array_equal(sel.numpy(), s_m.numpy())
    np.testing.assert_array_equal(sel.numpy(), np.asarray(s_a))
    assert _rel(w.numpy(), w_m.numpy()) <= 1e-5
    assert _rel(w.numpy(), w_a) <= 1e-5
    bias = logit_bias()
    np.testing.assert_allclose(logits.numpy().astype(np.float64) - bias,
                               l_m.numpy().astype(np.float64) - bias, rtol=1e-5, atol=1e-6)


def test_completeness(pair):
    """Bias-free but for Normalize's mean shift: the contributions of
    (x - mean) add up to the selected pre-bias logit."""
    from bcosification_tpu_torch.explain.core import contribution_map
    from bcosification_tpu_torch.explain.fast_densenet import fast_dynamic_linear_weights

    _, _, tnet, x = pair
    xt = torch.from_numpy(x)
    logits, sel, w = fast_dynamic_linear_weights(tnet, xt, device="cpu")
    total = contribution_map(xt - torch.tensor(tnet.mean), w).double().sum(dim=(1, 2))
    picked = logits.double().gather(1, sel[:, None])[:, 0] - logit_bias()
    np.testing.assert_allclose(total.numpy(), picked.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("path", ["fast", "module"])
def test_each_1x1_conv_goes_through_the_kernels(pair, path, monkeypatch):
    """On the CPU the wrappers call the kernels' plain versions: count those
    calls. Every 1x1 conv (each dense layer's conv1, the transition, the
    classifier) is one K3 forward and one K2 backward; K1 never runs."""
    from bcosification_tpu_torch.explain.core import dynamic_linear_weights
    from bcosification_tpu_torch.explain.fast_densenet import fast_dynamic_linear_weights
    from bcosification_tpu_torch.ops.cuda import bcos_conv1x1, bcos_matmul

    _, _, tnet, x = pair
    calls = {"fwd": 0, "bwd": 0, "matmul": 0}

    def counting(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(bcos_conv1x1, "conv1x1_fwd_plain",
                        counting("fwd", bcos_conv1x1.conv1x1_fwd_plain))
    monkeypatch.setattr(bcos_conv1x1, "conv1x1_bwd_explain_plain",
                        counting("bwd", bcos_conv1x1.conv1x1_bwd_explain_plain))
    monkeypatch.setattr(bcos_matmul, "bcos_matmul_fwd_plain",
                        counting("matmul", bcos_matmul.bcos_matmul_fwd_plain))
    n_1x1 = sum(SMALL_DENSENET["block_config"]) + len(SMALL_DENSENET["block_config"])
    xt = torch.from_numpy(x)
    if path == "fast":
        fast_dynamic_linear_weights(tnet, xt, device="cpu")
    else:
        dynamic_linear_weights(lambda t: tnet(t, explain=True), xt, device="cpu")
    assert calls == {"fwd": 0, "bwd": n_1x1, "matmul": n_1x1}


def test_train_step_matches_jax(pair):
    """One step of the recipe (fp32; Adam, cosine, AGC, UniformOffLabels BCE,
    EMA), JAX make_train_step against the port's from the same variables
    and batch: the loss 1e-5, every raw gradient leaf 1e-4 relative, the
    parameters after the step 1e-5 absolute, the BN running_var 1e-5."""
    from bcosification_tpu.training import steps as jsteps
    from bcosification_tpu_torch.bcosify.from_jax import to_jax_variables
    from bcosification_tpu_torch.training import steps as tsteps

    net, variables, tnet, _ = pair
    rng = np.random.default_rng(10)
    x = rng.random((4, SIZE, SIZE, 3)).astype(np.float32)
    x = np.concatenate([x, 1.0 - x], axis=-1)
    label = rng.integers(0, NUM_CLASSES, size=4).astype(np.int32)
    criterion, tx = _jax_recipe(amp=False)
    batch = {"image": jnp.asarray(x), "label": jnp.asarray(label)}

    def loss_fn(params):
        out, _ = net.apply({"params": params, "batch_stats": variables["batch_stats"]},
                           batch["image"], train=True, mutable=["batch_stats"])
        return criterion(out.astype(jnp.float32), batch["label"])

    jgrads = {".".join(p): a for p, a in _leaves(
        jax.tree_util.tree_map(np.asarray, jax.grad(loss_fn)(variables["params"])))}
    jstep = jsteps.make_train_step(net, criterion, tx, use_agc=True, ema_decay=0.9,
                                   ema_steps=1, donate=False)
    jstate, jm = jstep(jsteps.create_train_state(variables, tx, with_ema=True), batch)

    tcrit, tfactory, schedule = _port_recipe()
    m = copy.deepcopy(tnet).requires_grad_(True)
    tcrit(m(_t(x), train=True).float(), _t(label)).backward()
    tgrads = {n: p.grad.numpy() for n, p in m.named_parameters()}
    assert set(tgrads) == set(jgrads)
    diff = {n: np.asarray(g.transpose(2, 3, 1, 0) if g.ndim == 4 else g, np.float64)
            - jgrads[n] for n, g in tgrads.items()}
    # norm0's gamma reaches the loss only through train-mode BNs, which
    # divide its per-channel scale out again: its gradient is zero but for
    # the BN eps (~4e-9, the other gammas' 5e-4 and up), rounding noise on
    # both sides, so it is held in absolute terms against the smallest
    # other gamma gradient
    stem = "model.norm0.weight"
    worst = max(np.linalg.norm(d) / np.linalg.norm(jgrads[n])
                for n, d in diff.items() if n != stem)
    assert worst <= 1e-4, worst
    smallest = min(np.linalg.norm(jgrads[n]) for n in jgrads
                   if n.endswith("norm1.weight") or n.endswith("norm2.weight"))
    assert np.linalg.norm(diff[stem]) <= 1e-4 * smallest

    tstep = tsteps.make_train_step(tcrit, schedule, use_agc=True, ema_decay=0.9, ema_steps=1)
    tstate, tm = tstep(tsteps.create_train_state(tnet, tfactory.create, with_ema=True),
                       {"image": _t(x), "label": _t(label)})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
    got = to_jax_variables(tstate.model)
    for coll, jtree in (("params", jstate.params), ("batch_stats", jstate.batch_stats)):
        want = {".".join(p): a for p, a in _leaves(jax.tree_util.tree_map(np.asarray, jtree))}
        for path, arr in _leaves(got[coll]):
            name = ".".join(path)
            if coll == "params":
                np.testing.assert_allclose(arr, want[name], rtol=0, atol=1e-5, err_msg=name)
            elif name.endswith("running_var"):
                np.testing.assert_allclose(arr, want[name], rtol=1e-5, err_msg=name)


def _torchvision_b1(rng):
    tmodel = TorchMiniDenseNet()  # 8 initial features, growth 4, blocks (2, 2), 5 classes
    _randomize_bn(tmodel, rng)
    return tmodel.eval()


B1_CONFIG = {"name": "densenet121", "bcos_args": {"b": 1},
             "bcosify_args": {"use_bias": True, "norm_layer": "BnUncV2", "gap": True,
                              "act_layer": True}}
MINI = dict(growth_rate=4, block_config=(2, 2), num_init_features=8, bn_size=2)


def test_densenet_b1_conversion_exact():
    """b=1 with the biases kept reproduces the torchvision-format DenseNet
    (the JAX package's test_densenet_b1_conversion_exact), and the port's
    import equals the JAX package's on the same state dict."""
    from bcosification_tpu_torch.bcosify.engine import build_bcosified_densenet

    rng = np.random.default_rng(0)
    tmodel = _torchvision_b1(rng)
    tsd = tmodel.state_dict()
    tnet = build_bcosified_densenet(B1_CONFIG, tsd, num_classes=5, arch_cfg=MINI, device="cpu")
    x = rng.random((2, 3, 32, 32)).astype(np.float32)
    mean = torch.tensor((0.485, 0.456, 0.406)).view(1, 3, 1, 1)
    std = torch.tensor((0.229, 0.224, 0.225)).view(1, 3, 1, 1)
    x_nhwc = x.transpose(0, 2, 3, 1)
    x6 = np.concatenate([x_nhwc, 1.0 - x_nhwc], axis=-1)
    with torch.no_grad():
        want = tmodel((torch.from_numpy(x) - mean) / std).numpy()
        got = tnet(torch.from_numpy(x6)).numpy() + np.log(5 - 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    jnet, jvars = jax_densenet(B1_CONFIG, tsd, arch_cfg=MINI, input_size=32, num_classes=5)
    jout = np.asarray(jnet.apply(jvars, jnp.asarray(x6))) + np.log(5 - 1)
    np.testing.assert_allclose(got, jout, rtol=1e-5, atol=1e-6)


def test_densenet_import_is_strict():
    from bcosification_tpu_torch.bcosify.engine import build_bcosified_densenet

    tsd = _torchvision_b1(np.random.default_rng(1)).state_dict()
    build = lambda sd: build_bcosified_densenet(B1_CONFIG, sd, num_classes=5, arch_cfg=MINI,
                                                device="cpu")
    missing = {k: v for k, v in tsd.items() if k != "features.transition1.conv.weight"}
    with pytest.raises(KeyError, match="missing torchvision entry"):
        build(missing)
    with pytest.raises(KeyError, match="map onto nothing"):
        build({**tsd, "features.denseblock3.denselayer1.conv1.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape mismatch"):
        build({**tsd, "classifier.weight": torch.zeros(5, 7)})
    # the recipe drops every bias: the classifier's may be left unused
    build_bcosified_densenet({**B1_CONFIG, "bcosify_args": {"use_bias": False}}, tsd,
                             num_classes=5, arch_cfg=MINI, device="cpu")


@pytest.fixture(scope="module")
def artifacts(pair):
    from bcosification_tpu import serving as jserving
    from bcosification_tpu_torch import serving

    net, variables, tnet, _ = pair
    return {"forward": serving.export_forward(tnet, input_size=SIZE, device="cpu"),
            "explain": serving.export_explain(tnet, input_size=SIZE, device="cpu"),
            "jax explain": jserving.export_explain(net, variables, input_size=SIZE)}


@pytest.mark.parametrize("batch", [1, 3])
def test_export_round_trip(pair, artifacts, batch):
    """Fault C3: export_explain returns a program for the DenseNet (the JAX
    package exports its generic fused VJP). The loaded programs equal the
    eager calls (1e-6) and the JAX artifact (1e-5)."""
    from bcosification_tpu import serving as jserving
    from bcosification_tpu_torch import serving
    from bcosification_tpu_torch.explain.fast_densenet import fast_dynamic_linear_weights

    _, _, tnet, _ = pair
    x = np.random.default_rng(batch).random((batch, SIZE, SIZE, 3)).astype(np.float32)
    x = np.concatenate([x, 1.0 - x], axis=-1)
    xt = torch.from_numpy(x)
    bias = logit_bias()
    logits, sel, w = serving.load_serialized(artifacts["explain"]).call(xt)
    el, es, ew = fast_dynamic_linear_weights(tnet, xt, device="cpu")
    jl, js, jw = jserving.load_serialized(artifacts["jax explain"]).call(jnp.asarray(x))
    np.testing.assert_array_equal(sel.numpy(), es.numpy())
    np.testing.assert_array_equal(sel.numpy(), np.asarray(js))
    assert _rel(w.numpy(), ew.numpy()) <= 1e-6
    assert _rel(w.numpy(), jw) <= 1e-5
    assert _rel(logits.numpy() - bias, el.numpy() - bias) <= 1e-6
    assert _rel(logits.numpy() - bias, np.asarray(jl, np.float64) - bias) <= 1e-5
    forward = serving.load_serialized(artifacts["forward"]).call(xt).numpy()
    with torch.no_grad():
        eager = tnet(xt).numpy()
    assert _rel(forward - bias, eager - bias) <= 1e-6


def test_exported_explain_calls_the_kernel_ops(artifacts):
    from bcosification_tpu_torch import serving

    graph = serving.load_serialized(artifacts["explain"]).program.graph_module
    targets = {str(n.target) for m in graph.modules() for n in getattr(m, "graph", ()).nodes
               if n.op == "call_function" and "bcos_torch" in str(n.target)}
    assert targets == {"bcos_torch.bcos_matmul_fwd.default",
                       "bcos_torch.conv1x1_bwd_explain.default"}


@pytest.mark.parametrize("name", ["resnet_18", "resnet_18_V1", "resnet_50", "resnet_50_V1",
                                  "densenet_121"])
def test_every_arch_of_the_grid_builds(name, monkeypatch):
    """No config of ImageNet/bcosification raises any more; densenet_121 is
    the full-width DenseNet-121."""
    from bcosification_tpu_torch.experiments.utils.experiment_utils import Experiment
    from bcosification_tpu_torch.models.densenet import BcosDenseNet

    monkeypatch.delenv("TORCHVISION_WEIGHTS_DIR", raising=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # random init: no torchvision weights here
        net = Experiment("ImageNet", "bcosification", name).get_model(device="cpu")
    assert net.num_classes == 1000 and not net.training
    if name == "densenet_121":
        m = net.model
        assert isinstance(m, BcosDenseNet)
        assert (m.growth_rate, m.block_config, m.num_init_features, m.bn_size) == (
            32, (6, 12, 24, 16), 64, 4)
        assert m.num_features == 1024 and m.stem_pool == "avg" and m.gap_reorder
        ones = [c for c in m.modules() if getattr(c, "kernel_size", None) == (1, 1)]
        assert len(ones) == 62


def test_trainer_fits_and_resumes_the_densenet(pair, tmp_path):
    """Trainer.fit on the small DenseNet: train-mode BN in every norm, AGC,
    EMA, a checkpoint, and a resume from it."""
    import types

    from bcosification_tpu_torch.losses import (
        BinaryCrossEntropyLoss,
        UniformOffLabelsBCEWithLogitsLoss,
    )
    from bcosification_tpu_torch.optim import LRSchedulerFactory, OptimizerFactory
    from bcosification_tpu_torch.training.trainer import Trainer
    from chip_smoke import RepeatedBatch

    _, _, tnet, x = pair
    label = torch.tensor([1, 3])
    data = RepeatedBatch({"image": torch.from_numpy(x), "label": label}, 3)
    exp = types.SimpleNamespace(save_dir=tmp_path, config=dict(
        criterion=UniformOffLabelsBCEWithLogitsLoss(), test_criterion=BinaryCrossEntropyLoss(),
        optimizer=OptimizerFactory("Adam", 1e-3, bcosify=True, b_opt=False),
        lr_scheduler=LRSchedulerFactory("cosineannealinglr", epochs=2), trainer=dict(max_epochs=1),
        use_agc=True, ema={"decay": 0.9, "steps": 1}, model={}))
    state = Trainer(exp, device="cpu").fit(tnet, data)
    assert state.step == 3
    rv = [b for n, b in state.model.named_buffers() if n.endswith("running_var")]
    assert len(rv) == 2 * 4 + 1 + 2 and all(not torch.equal(v, torch.ones_like(v)) for v in rv)
    assert any(not torch.equal(a, b) for a, b in zip(state.ema.parameters(),
                                                     state.model.parameters()))
    resumed = Trainer(exp, device="cpu").fit(tnet, data, max_epochs=2)
    assert resumed.step == 6
    assert all(torch.isfinite(p).all() for p in resumed.model.parameters())


def test_stem_and_head_variants_match_jax():
    """The options of BcosDenseNet that the recipe does not use: the 3x3
    small-inputs stem (no stem norm or pool) and the classifier after the
    global average pool (gap_reorder=False), against the JAX module."""
    from bcosification_tpu.bcosify.engine import _bcosify_factories as jax_factories
    from bcosification_tpu.models.densenet import BcosDenseNet as JaxDenseNet
    from bcosification_tpu_torch.bcosify.engine import _bcosify_factories
    from bcosification_tpu_torch.bcosify.from_jax import load_jax_variables
    from bcosification_tpu_torch.models.densenet import BcosDenseNet
    from torch_port_helpers import FLAGSHIP_CONFIG

    config = {**FLAGSHIP_CONFIG, "name": "densenet121"}
    variant = dict(SMALL_DENSENET, num_classes=NUM_CLASSES, small_inputs=True, gap_reorder=False)
    conv, norm, act, _, _ = jax_factories(config)
    jnet = JaxDenseNet(conv_layer=conv, norm_layer=norm, act_layer=act, **variant)
    x = np.random.default_rng(3).random((2, 16, 16, 6)).astype(np.float32)
    variables = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))
    conv, norm, act, _, _ = _bcosify_factories(config)
    tnet = BcosDenseNet(conv_layer=conv, norm_layer=norm, act_layer=act, **variant).eval()
    load_jax_variables(tnet, jax.tree_util.tree_map(np.array, variables))
    assert not hasattr(tnet, "norm0")
    want = np.asarray(jnet.apply(variables, jnp.asarray(x)), np.float64)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 0
    assert _rel(got, want) <= 1e-5
