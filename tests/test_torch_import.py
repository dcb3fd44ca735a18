"""Weights into the port, on the CPU in fp32, against the JAX package:

- a torchvision-format ResNet state dict (made from a numpy seed) through
  the JAX ``resnet_torch_to_variables`` (via its engine) and through the
  port's ``resnet_state_dict`` (via its engine): pre-logit features and W
  agree to 1e-5 (relative), with BnUncV2 and with BnUnc2d;
- the import's strictness: a missing, extra or mis-shaped entry raises;
- ``models/pretrained.py``: npz files in the JAX export format under
  $BCOS_WEIGHTS_DIR (plain and sha-stamped names) resolve for the zoo's
  "resnet50" (built small in both packages), and the port's outputs equal
  the JAX outputs on the same weights (1e-5); the registry's names equal
  the JAX package's but VGG and ConvNeXt.

BN gammas are calibrated first (ROADMAP "Parity method"): a random b=2 net
contracts its output to ~1e-20, which would make every comparison empty.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import calibrate
from torch_port_helpers import logit_bias

torch.set_num_threads(1)
NUM_CLASSES, INPLANES, SIZE = 10, 8, 32
LAYERS = {"resnet50": ("bottleneck", (1, 1)), "resnet18": ("basic", (1, 1))}


def torchvision_state_dict(arch, seed=0):
    """{torchvision key: tensor} of a ResNet with LAYERS[arch], INPLANES and
    NUM_CLASSES, as torchvision names and shapes them (OIHW convs, BN
    weight/bias/running_mean/running_var/num_batches_tracked, fc Linear)."""
    rng = np.random.default_rng(seed)
    block, counts = LAYERS[arch]
    expansion = 4 if block == "bottleneck" else 1
    sd = {}

    def conv(key, cout, cin, k):
        w = rng.standard_normal((cout, cin, k, k)) / np.sqrt(cin * k * k)
        sd[key] = torch.from_numpy(w.astype(np.float32))

    def bn(key, c):
        sd[f"{key}.weight"] = torch.from_numpy((rng.random(c) + 0.5).astype(np.float32))
        sd[f"{key}.bias"] = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32))
        sd[f"{key}.running_mean"] = torch.from_numpy(
            (0.1 * rng.standard_normal(c)).astype(np.float32))
        sd[f"{key}.running_var"] = torch.from_numpy((rng.random(c) + 0.5).astype(np.float32))
        sd[f"{key}.num_batches_tracked"] = torch.tensor(7)

    conv("conv1.weight", INPLANES, 3, 7)
    bn("bn1", INPLANES)
    cin = INPLANES
    for stage, n_blocks in enumerate(counts):
        planes = INPLANES * 2 ** stage
        for j in range(n_blocks):
            p = f"layer{stage + 1}.{j}"
            stride = 2 if stage > 0 and j == 0 else 1
            if block == "bottleneck":
                conv(f"{p}.conv1.weight", planes, cin, 1)
                conv(f"{p}.conv2.weight", planes, planes, 3)
                conv(f"{p}.conv3.weight", planes * 4, planes, 1)
                for k, c in ((1, planes), (2, planes), (3, planes * 4)):
                    bn(f"{p}.bn{k}", c)
            else:
                conv(f"{p}.conv1.weight", planes, cin, 3)
                conv(f"{p}.conv2.weight", planes, planes, 3)
                bn(f"{p}.bn1", planes)
                bn(f"{p}.bn2", planes)
            if stride != 1 or cin != planes * expansion:
                conv(f"{p}.downsample.0.weight", planes * expansion, cin, 1)
                bn(f"{p}.downsample.1", planes * expansion)
            cin = planes * expansion
    sd["fc.weight"] = torch.from_numpy(
        (rng.standard_normal((NUM_CLASSES, cin)) / np.sqrt(cin)).astype(np.float32))
    sd["fc.bias"] = torch.from_numpy((0.1 * rng.standard_normal(NUM_CLASSES)).astype(np.float32))
    return sd


def _config(arch, norm_layer, use_bias):
    return {"name": arch, "bcos_args": {"b": 2},
            "bcosify_args": {"fix_b": True, "use_bias": use_bias, "norm_layer": norm_layer,
                             "gap": True, "act_layer": True}}


def _bn_key(port_name):
    """Port BN module name -> its torchvision prefix."""
    name = port_name[len("model."):]
    if name == "bn1":
        return name
    block, rest = name.split(".")
    stage, j = block[len("layer"):].split("_")
    rest = "downsample.1" if rest == "downsample_norm" else rest
    return f"layer{stage}.{j}.{rest}"


def calibrated_state_dict(arch, config):
    """The torchvision state dict with its BN gammas scaled as chip_smoke's
    calibrate() scales the port's, so that the net's output has signal."""
    from bcosification_tpu_torch.bcosify.engine import build_bcosified_resnet
    from bcosification_tpu_torch.modules import BatchNormUncentered2d

    sd = torchvision_state_dict(arch)
    tnet = build_bcosified_resnet(config, state_dict=sd, num_classes=NUM_CLASSES,
                                  inplanes=INPLANES, layers=LAYERS[arch], device="cpu")
    before = {n: m.weight.clone() for n, m in tnet.named_modules()
              if isinstance(m, BatchNormUncentered2d)}
    probe = torch.from_numpy(np.random.default_rng(9).random((1, SIZE, SIZE, 6))
                             .astype(np.float32))
    calibrate(tnet, probe)
    for name, module in tnet.named_modules():
        if name in before:
            sd[f"{_bn_key(name)}.weight"] = sd[f"{_bn_key(name)}.weight"] * (
                module.weight / before[name])
    return sd


def _jax_net(arch, config, sd):
    from bcosification_tpu.bcosify import engine

    old = engine.RESNET_LAYERS[arch]
    engine.RESNET_LAYERS[arch] = LAYERS[arch]
    try:
        return engine.build_bcosified_resnet(config, sd, input_size=SIZE,
                                             num_classes=NUM_CLASSES, inplanes=INPLANES)
    finally:
        engine.RESNET_LAYERS[arch] = old


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _x(seed=1):
    x = np.random.default_rng(seed).random((2, SIZE, SIZE, 3)).astype(np.float32)
    return np.concatenate([x, 1.0 - x], axis=-1)


@pytest.mark.parametrize("arch,norm_layer,use_bias", [
    ("resnet50", "BnUncV2", True), ("resnet50", "BnUnc2d", True),
    ("resnet50", "BnUncV2", False), ("resnet18", "BnUncV2", True),
])
def test_torchvision_import_matches_jax(arch, norm_layer, use_bias):
    from bcosification_tpu.explain.core import dynamic_linear_weights as jax_dlw
    from bcosification_tpu_torch.bcosify.engine import build_bcosified_resnet
    from bcosification_tpu_torch.explain.core import dynamic_linear_weights

    config = _config(arch, norm_layer, use_bias)
    sd = calibrated_state_dict(arch, config)
    net, variables = _jax_net(arch, config, sd)
    tnet = build_bcosified_resnet(config, state_dict=sd, num_classes=NUM_CLASSES,
                                  inplanes=INPLANES, layers=LAYERS[arch], device="cpu")
    x = _x()
    want_l, want_s, want_w = jax_dlw(
        lambda t: net.apply(variables, t, train=False, explain=True), jnp.asarray(x))
    got_l, got_s, got_w = dynamic_linear_weights(lambda t: tnet(t, explain=True),
                                                 torch.from_numpy(x), device="cpu")
    bias = logit_bias()
    pre_want = np.asarray(want_l, np.float64) - bias
    assert np.abs(pre_want).max() > 1e-2  # calibrated: the comparison has signal
    assert _rel(got_l.numpy().astype(np.float64) - bias, pre_want) <= 1e-5
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert _rel(got_w.numpy(), want_w) <= 1e-5


def test_bias_fold_only_with_bnuncv2():
    """BnUncV2 folds the running mean into the bias; BnUnc2d keeps the bias."""
    from bcosification_tpu_torch.bcosify.engine import build_bcosified_resnet

    sd = torchvision_state_dict("resnet50")
    nets = {norm: build_bcosified_resnet(_config("resnet50", norm, True), state_dict=sd,
                                         num_classes=NUM_CLASSES, inplanes=INPLANES,
                                         layers=LAYERS["resnet50"], device="cpu")
            for norm in ("BnUncV2", "BnUnc2d")}
    w, b = sd["bn1.weight"], sd["bn1.bias"]
    mean, std = sd["bn1.running_mean"], torch.sqrt(sd["bn1.running_var"] + 1e-5)
    torch.testing.assert_close(nets["BnUnc2d"].model.bn1.bias, b)
    torch.testing.assert_close(nets["BnUncV2"].model.bn1.bias, b - mean / std * w)
    # the stem's channel doubling: [w, -w] / 2
    stem = nets["BnUncV2"].model.conv1.weight
    torch.testing.assert_close(stem, torch.cat([sd["conv1.weight"], -sd["conv1.weight"]], 1) / 2)


@pytest.mark.parametrize("case", ["missing", "extra", "mis-shaped"])
def test_import_is_strict(case):
    from bcosification_tpu_torch.bcosify.engine import build_bcosified_resnet

    sd = torchvision_state_dict("resnet50")
    if case == "missing":
        del sd["layer1.0.bn2.running_var"]
        error, match = KeyError, "missing"
    elif case == "extra":
        sd["layer1.0.conv4.weight"] = torch.zeros(8, 8, 1, 1)
        error, match = KeyError, "map onto nothing"
    else:
        sd["layer2.0.conv3.weight"] = sd["layer2.0.conv3.weight"][:, :-1]
        error, match = ValueError, "shape"
    with pytest.raises(error, match=match):
        build_bcosified_resnet(_config("resnet50", "BnUncV2", False), state_dict=sd,
                               num_classes=NUM_CLASSES, inplanes=INPLANES,
                               layers=LAYERS["resnet50"], device="cpu")


# --------------------------------------------------------------------------
# models/pretrained.py: local npz files
# --------------------------------------------------------------------------
@pytest.fixture
def flagship(monkeypatch):
    """Both packages' zoo entry "resnet50" (the from-scratch B-cos ResNet-50)
    built small for the test: its class with the bottleneck blocks of
    LAYERS["resnet50"], width INPLANES and NUM_CLASSES."""
    from bcosification_tpu.models import pretrained as jax_pretrained
    from bcosification_tpu.models import resnet as jresnet
    from bcosification_tpu_torch.models import pretrained
    from bcosification_tpu_torch.models import resnet as tresnet

    block, layers = LAYERS["resnet50"]
    kw = dict(block=block, layers=layers, inplanes=INPLANES, num_classes=NUM_CLASSES)
    monkeypatch.setitem(jax_pretrained._REGISTRY, "resnet50", lambda **extra: jax_pretrained._init(
        jresnet.BcosResNet(**kw, **extra), (SIZE, SIZE, 6)))
    monkeypatch.setitem(pretrained._REGISTRY, "resnet50", pretrained._cnn(tresnet.BcosResNet, **kw))
    return jax_pretrained


@pytest.mark.parametrize("sha_suffix", [False, True], ids=["plain", "sha-stamped"])
def test_npz_resolves_and_matches_jax(flagship, tmp_path, monkeypatch, sha_suffix):
    """An npz of the JAX export format under $BCOS_WEIGHTS_DIR: the port's
    load_model("resnet50") and the JAX package's give the same logits."""
    from scripts.import_torch_checkpoint import write_npz
    from test_torch_vit_final import randomized
    from bcosification_tpu_torch.models import pretrained

    jax_pretrained = flagship
    net, variables = jax_pretrained.load_model("resnet50", pretrained=False)
    path = write_npz(randomized(variables, 5), tmp_path, "resnet50", sha_suffix=sha_suffix)
    monkeypatch.setenv("BCOS_WEIGHTS_DIR", str(tmp_path))
    assert pretrained.resolve_weights("resnet50") == path
    tnet = pretrained.load_model("resnet50", device="cpu")
    _, jax_vars = jax_pretrained.load_model("resnet50")
    x = np.random.default_rng(6).random((2, SIZE, SIZE, 3)).astype(np.float32)
    x = np.concatenate([x, 1.0 - x], axis=-1)
    want = np.asarray(net.apply(jax_vars, jnp.asarray(x), train=False), np.float64)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy().astype(np.float64)
    bias = logit_bias()
    assert np.abs(want - bias).max() > 1e-2
    assert _rel(got - bias, want - bias) <= 1e-5


def test_newest_sha_stamped_npz_wins(flagship, tmp_path, monkeypatch):
    import os

    from bcosification_tpu_torch.models import pretrained

    old, new = tmp_path / "resnet50-0123abcd.npz", tmp_path / "resnet50-feedbeef99.npz"
    for i, p in enumerate((old, new)):
        np.savez(p, a=np.zeros(1))
        os.utime(p, (1000 + i, 1000 + i))
    (tmp_path / "resnet50-notahash.npz").write_bytes(b"")
    monkeypatch.setenv("BCOS_WEIGHTS_DIR", str(tmp_path))
    with pytest.warns(UserWarning, match="newest"):
        assert pretrained.resolve_weights("resnet50") == new


def test_unresolved_weights_warn_and_keep_random_init(flagship, tmp_path, monkeypatch):
    """No npz: the seeded random init, and a warning naming the release URL;
    the download switch raises (no network path)."""
    from bcosification_tpu_torch.models import pretrained

    monkeypatch.delenv("BCOS_WEIGHTS_DIR", raising=False)
    monkeypatch.delenv("BCOS_ALLOW_DOWNLOAD", raising=False)
    with pytest.warns(UserWarning, match="random init. Released reference weights: https://"):
        net = pretrained.load_model("resnet50", device="cpu")
    fresh = pretrained.load_model("resnet50", pretrained=False, device="cpu")
    for a, b in zip(net.state_dict().values(), fresh.state_dict().values()):
        assert torch.equal(a, b)
    monkeypatch.setenv("BCOS_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setenv("BCOS_ALLOW_DOWNLOAD", "1")
    with pytest.raises(RuntimeError, match="no network path"):
        pretrained.load_model("resnet50", device="cpu")


def test_registry_names():
    """The port builds every JAX entry point (the 15 VGG and ConvNeXt names
    among them); the names the port used to add (resnet_50, ...) are
    unknown in both packages."""
    from bcosification_tpu.models import pretrained as jax_pretrained
    from bcosification_tpu_torch.models import pretrained

    assert pretrained.list_available() == sorted(jax_pretrained.list_available())
    assert len(pretrained.list_available()) == 45
    assert not hasattr(pretrained, "NOT_PORTED")
    for load in (pretrained.load_model, jax_pretrained.load_model):
        for name in ("resnet_50", "resnet_18_V1", "no_such_model"):
            with pytest.raises(ValueError, match="Unknown entrypoint"):
                load(name)
