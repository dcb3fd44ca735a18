"""The PyTorch port's dynamic-int8 serving route (``BCOS_INT8=1``,
``ops/bcos.py``'s ``conv_int8_dynamic`` on ``ops/int8.py``'s
``torch._int_mm`` product) against the JAX package's
``ops.bcos._conv_int8_dynamic``, on the CPU, on the cases of
``tests/test_int8_serving.py``, with the environment set by
``monkeypatch.setenv`` for both packages.

- the quantized conv: the int8 activations and weights and the int32
  products EQUAL the JAX package's (read off its ``lax.conv_general_dilated``
  call), the bf16 outputs within bf16 rounding of it, for 3x3, grouped,
  strided and dilated, 1x1 strided and depthwise convs, a 100x sample and a
  100x output channel, a zero input and the fixed ``BCOS_INT8_SCALE``;
- the gates: each call quantizes exactly when the JAX call does (off by
  default, explain and train never, ``BCOS_INT8_MIN_CH`` on the per-group
  channels, fp32 never, the folded-epilogue 1x1 in train and serve mode),
  and an unquantized call gives the values it gives with the flag unset;
  differentiating a quantized conv raises;
- the small flagship (``_flagship(input_size=32, inplanes=8, layers=
  ("bottleneck", (1, 1)))``, bf16): the same convs quantized as in JAX,
  the quantized 1x1s off K1 and the classifier off K3 (their plain versions
  not called), the rest on them; the pre-logits' distance from the port's
  fp32 ones within twice the JAX package's own, and an export under the
  flag that keeps the int8 route after the flag is unset;
- the ``_int_mm`` route against the exact plain version (a float64 conv of
  the same integers), also at sizes off the card's rules (M <= 16, K and N
  not multiples of 8).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bcosification_tpu.modules import bcos_layers as jlayers
from bcosification_tpu.ops import bcos as jops
from bcosification_tpu.ops.pallas.bcos_conv1x1 import bcos_conv1x1_bn_act as j_conv1x1
from bcosification_tpu_torch.modules import bcos_layers as tlayers
from bcosification_tpu_torch.ops import bcos as tops
from bcosification_tpu_torch.ops import int8 as ti8
from bcosification_tpu_torch.ops.cuda import bcos_conv1x1 as k12
from bcosification_tpu_torch.ops.cuda import bcos_matmul as k3

torch.set_num_threads(1)


def _rand(shape, seed, scale=1.0):
    """A bf16-representable f32 array."""
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _nhwc(t):
    return torch.from_numpy(np.ascontiguousarray(t)).to(torch.bfloat16)


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w_hwio, (3, 2, 0, 1))))


@pytest.fixture
def recorded(monkeypatch):
    """The int8 products of both packages while the test runs: JAX's
    (xq NHWC, wq HWIO, y) from its int32 ``lax.conv_general_dilated``, the
    port's (xq NHWC, wq OIHW, y) from ``ops.int8.int8_product``."""
    seen = {"jax": [], "port": []}
    conv = jax.lax.conv_general_dilated
    product = ti8.int8_product

    def jax_conv(lhs, rhs, *args, **kwargs):
        out = conv(lhs, rhs, *args, **kwargs)
        if kwargs.get("preferred_element_type") == jnp.int32:  # under jit: counted only
            traced = isinstance(out, jax.core.Tracer)
            seen["jax"].append(None if traced else (np.asarray(lhs), np.asarray(rhs),
                                                    np.asarray(out)))
        return out

    def port_product(xq, wq, *args, **kwargs):
        y = product(xq, wq, *args, **kwargs)
        seen["port"].append((xq.numpy(), wq.numpy(), y.numpy()))
        return y

    monkeypatch.setattr(jax.lax, "conv_general_dilated", jax_conv)
    monkeypatch.setattr(ti8, "int8_product", port_product)
    return seen


def _same_products(seen):
    """Both packages made the same int8 operands and int32 products."""
    assert len(seen["jax"]) == len(seen["port"])
    for (jx, jw, jy), (tx, tw, ty) in zip(seen["jax"], seen["port"]):
        assert tx.dtype == np.int8 and tw.dtype == np.int8 and ty.dtype == np.int32
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(tw, np.transpose(jw, (3, 2, 0, 1)))
        np.testing.assert_array_equal(ty, jy)


# (label, x NHWC, w HWIO, w scale, stride, padding, dilation, groups, edit)
X = (2, 8, 8, 16)  # one input shape: JAX's eager ops compile once per shape
CONV_CASES = [
    ("3x3", X, (3, 3, 16, 24), 0.1, 1, 1, 1, 1, None),
    ("grouped strided dilated", X, (3, 3, 8, 32), 0.2, 2, 2, 2, 2, None),
    ("1x1 strided", X, (1, 1, 16, 24), 0.2, 2, 0, 1, 1, None),
    ("depthwise", X, (3, 3, 1, 16), 0.3, 1, 1, 1, 16, None),
    ("a 100x sample", X, (3, 3, 16, 24), 0.1, 1, 1, 1, 1, "sample"),
    ("a 100x output channel", X, (1, 1, 16, 24), 0.1, 1, 0, 1, 1, "channel"),
    ("zero input", X, (1, 1, 16, 24), 1.0, 1, 0, 1, 1, "zero"),
]


@pytest.mark.parametrize("case,fixed_scale", [(c, None) for c in CONV_CASES]
                         + [(c, "0.05") for c in CONV_CASES[:2]],
                         ids=[c[0] for c in CONV_CASES]
                         + [c[0] + " BCOS_INT8_SCALE" for c in CONV_CASES[:2]])
def test_conv_int8_dynamic_matches_jax(case, fixed_scale, recorded, monkeypatch):
    _, xs, ws, scale, stride, padding, dilation, groups, edit = case
    if fixed_scale is not None:
        monkeypatch.setenv("BCOS_INT8_SCALE", fixed_scale)
    x, w = _rand(xs, 0), _rand(ws, 1, scale)
    if edit == "sample":
        x[0] *= 100.0
    elif edit == "channel":
        w[..., 0] *= 100.0
    elif edit == "zero":
        x[:] = 0.0
    yj = np.asarray(jops._conv_int8_dynamic(jnp.asarray(x, jnp.bfloat16), jnp.asarray(
        w, jnp.bfloat16), stride, padding, dilation, groups).astype(jnp.float32))
    yt = tops.conv_int8_dynamic(_nhwc(x), _oihw(w), stride, padding, dilation, groups)
    assert yt.dtype == torch.bfloat16
    _same_products(recorded)
    np.testing.assert_allclose(yt.float().numpy(), yj, rtol=2.0**-8, atol=0)
    if edit == "zero":
        assert not yt.float().abs().max()
    elif fixed_scale is None:  # the quantization's own error, as the JAX tests bound it
        y32 = tops.conv2d(torch.from_numpy(x), _oihw(w), stride, padding, dilation, groups)
        sl = np.s_[..., 1:] if edit == "channel" else np.s_[...]
        for b in range(xs[0]):
            assert _rel(yt[b][sl].float(), y32[b][sl]) < 0.03


@pytest.mark.parametrize("shape", [(40, 24, 16), (5, 24, 16), (16, 13, 7), (300, 1152, 128),
                                   (1, 8, 8)], ids=lambda s: "x".join(map(str, s)))
def test_int_mm_route_matches_the_plain_version(shape):
    """``int_mm`` (zero-padded where the card's rules need it) equals the
    int64 product, and every conv route of ``int8_product`` the plain
    float64 conv, exactly."""
    m, k, n = shape
    g = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    assert torch.equal(ti8.int_mm(a, b), (a.long() @ b.long()).int())
    for _, xs, ws, _, stride, padding, dilation, groups, _ in CONV_CASES:
        xq = torch.randint(-127, 128, xs, generator=g, dtype=torch.int8)
        wq = torch.randint(-127, 128, (ws[3], ws[2], ws[0], ws[1]), generator=g,
                           dtype=torch.int8)
        args = (stride, padding, dilation, groups)
        assert torch.equal(ti8.int8_product(xq, wq, *args),
                           ti8.int8_product_plain(xq, wq, *args))


def _jax_module(module, x, **kw):
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.bfloat16))
    return variables, np.asarray(module.apply(variables, jnp.asarray(x, jnp.bfloat16), **kw)
                                 .astype(jnp.float32))


def _port_conv(cls, variables, x, **kw):
    """The port's layer of ``cls`` holding the JAX layer's weight."""
    w = np.asarray(variables["params"]["weight"])
    mod = cls(w.shape[2] * kw.pop("groups", 1), w.shape[3], w.shape[0], **kw)
    with torch.no_grad():
        mod.weight.copy_(_oihw(w))
    return mod


GATE_CASES = [  # (label, env, module call, quantized)
    ("off by default", {}, "bcos", False),
    ("BcosConv2d serve", {"BCOS_INT8": "1", "BCOS_INT8_MIN_CH": "0"}, "bcos", True),
    ("BcosConv2d explain", {"BCOS_INT8": "1", "BCOS_INT8_MIN_CH": "0"}, "bcos explain", False),
    ("BcosConv2d train", {"BCOS_INT8": "1", "BCOS_INT8_MIN_CH": "0"}, "bcos train", False),
    ("NormedConv2d serve", {"BCOS_INT8": "1", "BCOS_INT8_MIN_CH": "0"}, "normed", True),
    ("NormedConv2d train", {"BCOS_INT8": "1", "BCOS_INT8_MIN_CH": "0"}, "normed train", False),
    ("BcosConv2dWithScale serve", {"BCOS_INT8": "1", "BCOS_INT8_MIN_CH": "0"}, "scale", True),
    ("min ch 16 > 8", {"BCOS_INT8": "1", "BCOS_INT8_MIN_CH": "16"}, "bcos", False),
    ("min ch 8 <= 8", {"BCOS_INT8": "1", "BCOS_INT8_MIN_CH": "8"}, "bcos", True),
    ("fp32", {"BCOS_INT8": "1", "BCOS_INT8_MIN_CH": "0"}, "bcos fp32", False),
]


@pytest.mark.parametrize("case", GATE_CASES, ids=[c[0] for c in GATE_CASES])
def test_module_gates_match_jax(case, recorded, monkeypatch):
    """Each layer call quantizes exactly when the JAX layer's does, and a
    call that does not gives the values it gives with BCOS_INT8 unset."""
    _, env, call, quantized = case
    x = _rand((2, 6, 6, 8), 3)
    kind, _, mode = call.partition(" ")
    jcls, tcls = {"bcos": (jlayers.BcosConv2d, tlayers.BcosConv2d),
                  "normed": (jlayers.NormedConv2d, tlayers.NormedConv2d),
                  "scale": (jlayers.BcosConv2dWithScale, tlayers.BcosConv2dWithScale)}[kind]
    kw = dict(train=mode == "train", explain=mode == "explain")
    jmod = jcls(features=8, kernel_size=3, padding=1)
    variables, _ = _jax_module(jmod, x)
    tmod = _port_conv(tcls, variables, x, padding=1)
    xt = torch.from_numpy(x).to(torch.float32 if mode == "fp32" else torch.bfloat16)
    with torch.no_grad():
        y_ref = tmod(xt, **kw)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    xj = jnp.asarray(x, jnp.float32 if mode == "fp32" else jnp.bfloat16)
    yj = jmod.apply(variables, xj, **kw)
    with torch.no_grad():
        yt = tmod(xt, **kw)
    assert len(recorded["jax"]) == int(quantized)
    _same_products(recorded)
    if quantized:
        np.testing.assert_allclose(yt.float().numpy(), np.asarray(yj.astype(jnp.float32)),
                                   rtol=2e-2, atol=2e-2 * float(np.abs(np.asarray(
                                       yj.astype(jnp.float32))).max()))
        assert _rel(yt.float(), y_ref.float()) < 0.05
    else:
        assert torch.equal(yt, y_ref)


def test_per_group_depth_gates_grouped_convs(recorded, monkeypatch):
    """Under the default BCOS_INT8_MIN_CH (128) a conv of 128 channels in 32
    groups (4 per group) stays bf16, the dense one of 128 quantizes, in both
    packages; so does CLIP's plain conv."""
    from bcosification_tpu_torch.clip.model import PlainConv2d

    monkeypatch.setenv("BCOS_INT8", "1")
    monkeypatch.delenv("BCOS_INT8_MIN_CH", raising=False)
    x = _rand((1, 6, 6, 128), 40)
    for groups, quantized in ((32, False), (1, True)):
        w = _rand((3, 3, 128 // groups, 128), 41 + groups, 0.2)
        n = len(recorded["jax"])
        jops._conv(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), 1, 1, 1, groups,
                   allow_int8=True)
        tops.conv2d(_nhwc(x), _oihw(w), 1, 1, 1, groups, allow_int8=True)
        assert len(recorded["jax"]) - n == int(quantized)
        _same_products(recorded)
        clip_conv = PlainConv2d(128, 128, 3, padding=1, groups=groups)
        before = len(recorded["port"])
        with torch.no_grad():
            clip_conv(_nhwc(x))
            clip_conv(_nhwc(x), train=True)
            clip_conv(_nhwc(x), explain=True)
        assert len(recorded["port"]) - before == int(quantized)
        del recorded["port"][len(recorded["jax"]):]


@pytest.mark.parametrize("train", [False, True], ids=["serve", "train"])
def test_folded_epilogue_1x1_leaves_k1_only_when_serving(train, recorded, monkeypatch):
    """The 1x1 with a folded BN affine and ReLU: JAX's bcos_conv1x1_bn_act
    and the port's layer with ``epilogue`` quantize on a served forward and
    never in train mode; the port's quantized call leaves K1 (its plain
    version is not called), and its values follow JAX's."""
    monkeypatch.setenv("BCOS_INT8", "1")
    monkeypatch.setenv("BCOS_INT8_MIN_CH", "0")
    calls = []
    plain = k12.conv1x1_fwd_plain
    monkeypatch.setattr(k12, "conv1x1_fwd_plain", lambda *a, **k: calls.append(1) or plain(*a, **k))
    x, w2 = _rand((2, 4, 4, 16), 43), _rand((16, 8), 44, 0.2)
    mult = np.linspace(0.5, 1.5, 8).astype(np.float32)
    add = np.linspace(-0.1, 0.1, 8).astype(np.float32)
    yj = j_conv1x1(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w2), None, jnp.asarray(mult),
                   jnp.asarray(add), relu=True, train=train)
    conv = tlayers.BcosifyConv2d(16, 8, 1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w2.T.copy())[:, :, None, None])
        yt = conv(_nhwc(x), train=train, epilogue=(torch.from_numpy(mult),
                                                  torch.from_numpy(add), True))
    assert len(recorded["jax"]) == int(not train)
    _same_products(recorded)
    assert len(calls) == int(train)
    np.testing.assert_allclose(yt.float().numpy(), np.asarray(yj.astype(jnp.float32)),
                               rtol=2e-2, atol=1e-2)


def test_backward_through_a_quantized_conv_raises(monkeypatch):
    monkeypatch.setenv("BCOS_INT8", "1")
    monkeypatch.setenv("BCOS_INT8_MIN_CH", "0")
    x = _nhwc(_rand((1, 6, 6, 8), 31))
    w = _oihw(_rand((3, 3, 8, 8), 32, 0.2)).requires_grad_()
    y = tops.conv2d(x, w, 1, 1, allow_int8=True)
    with pytest.raises(RuntimeError, match="BCOS_INT8"):
        y.float().sum().backward()


@pytest.fixture(scope="module")
def flagship():
    """(jax net, variables, port net, x, jax fp32 pre-logits, port fp32
    pre-logits, the port's bf16 fast W) of the small flagship."""
    from bcosification_tpu_torch.explain.fast_resnet import fast_dynamic_linear_weights
    from torch_port_helpers import small_pair

    net, variables, tnet, x = small_pair("resnet50", ("bottleneck", (1, 1)), 32)
    tnet.with_logit_layer = False  # the pre-logits, not bf16 logits around -log(9)
    net = net.clone(with_logit_layer=False)
    j32 = np.asarray(jax.jit(lambda v, t: net.apply(v, t, train=False))(variables,
                                                                          jnp.asarray(x)))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        t32 = tnet(xt).numpy()
    w_bf16 = fast_dynamic_linear_weights(tnet, xt.bfloat16(), device="cpu")[2]
    return net, variables, tnet, x, j32, t32, w_bf16


@pytest.mark.parametrize("min_ch", ["0", "16"])
def test_small_flagship_quantizes_as_jax(flagship, min_ch, recorded, monkeypatch):
    """bf16 forward of the small flagship under BCOS_INT8=1: the same convs
    quantized (JAX's counted at trace time), the quantized 1x1s off K1 and
    the classifier off K3, the pre-logits within twice JAX's own distance
    from fp32; the fast explanation unchanged by the flag."""
    from bcosification_tpu_torch.explain.fast_resnet import fast_dynamic_linear_weights

    net, variables, tnet, x, j32, t32, w_ref = flagship
    xt = torch.from_numpy(x)
    calls = {"k1": 0, "k3": 0}
    for key, mod, name in (("k1", k12, "conv1x1_fwd_plain"),
                           ("k3", k3, "bcos_matmul_fwd_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _k=key, _f=fn, **kw:
                            calls.__setitem__(_k, calls[_k] + 1) or _f(*a, **kw))
    monkeypatch.setenv("BCOS_INT8", "1")
    monkeypatch.setenv("BCOS_INT8_MIN_CH", min_ch)
    ji8 = np.asarray(jax.jit(lambda v, t: net.apply(v, t, train=False))(
        variables, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    with torch.no_grad():
        ti8_ = tnet(xt.bfloat16()).float().numpy()
    # stem, 2 x (conv1, conv2, conv3, downsample), fc; at 16 channels those
    # with 16 channels or more on both sides of each group
    assert len(recorded["jax"]) == {"0": 10, "16": 4}[min_ch] == len(recorded["port"])
    # K1 at the unquantized conv1, conv3 and downsample of the two blocks,
    # K3 at an unquantized classifier (64 -> 10)
    assert calls == {"0": {"k1": 0, "k3": 0}, "16": {"k1": 3, "k3": 1}}[min_ch]
    assert _rel(ti8_, t32) <= 2 * _rel(ji8, j32)
    assert 0 < _rel(ti8_, t32)
    _, _, w = fast_dynamic_linear_weights(tnet, xt.bfloat16(), device="cpu")
    assert torch.equal(w, w_ref)


def test_export_forward_keeps_the_int8_route(flagship, monkeypatch):
    """``serving.export_forward`` under BCOS_INT8=1 traces the int8 route
    (torch._int_mm in the program): loaded back after the flag is unset it
    still gives the quantized forward."""
    from bcosification_tpu_torch import serving

    tnet, x = flagship[2:4]
    xt = torch.from_numpy(x).bfloat16()
    monkeypatch.setenv("BCOS_INT8", "1")
    monkeypatch.setenv("BCOS_INT8_MIN_CH", "16")
    with torch.no_grad():
        y_int8 = tnet(xt)
    blob = serving.export_forward(tnet, input_size=32, dtype=torch.bfloat16, device="cpu")
    monkeypatch.delenv("BCOS_INT8")
    with torch.no_grad():
        y_bf16 = tnet(xt)
    program = serving.load_serialized(blob)
    assert "_int_mm" in program.program.graph_module.code
    y = program.call(xt)
    assert torch.equal(y, y_int8) and not torch.equal(y, y_bf16)
