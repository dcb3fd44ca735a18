"""The port's serving export (serving.py) on the CPU, on the calibrated small
flagship: export_forward and export_explain round-trip through bytes, one
artifact serves batch 1 and batch 3, and its outputs equal the eager port's
to 1e-6 and the JAX package's serving artifact's to 1e-5 (relative; the
logits compared as pre-logit features, argmax equal)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import logit_bias, small_pair

torch.set_num_threads(1)
SIZE = 32


@pytest.fixture(scope="module")
def pair():
    return small_pair("resnet50", ("bottleneck", (1, 1)), SIZE, seed=7)


@pytest.fixture(scope="module")
def artifacts(pair):
    from bcosification_tpu import serving as jserving
    from bcosification_tpu_torch import serving

    net, variables, tnet, _ = pair
    return {
        "forward": (serving.export_forward(tnet, input_size=SIZE, device="cpu"),
                    jserving.export_forward(net, variables, input_size=SIZE)),
        "explain": (serving.export_explain(tnet, input_size=SIZE, device="cpu"),
                    jserving.export_explain(net, variables, input_size=SIZE)),
    }


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _x(batch):
    x = np.random.default_rng(batch).random((batch, SIZE, SIZE, 3)).astype(np.float32)
    return np.concatenate([x, 1.0 - x], axis=-1)


@pytest.mark.parametrize("batch", [1, 3])
def test_forward_roundtrip(pair, artifacts, batch):
    from bcosification_tpu import serving as jserving
    from bcosification_tpu_torch import serving

    _, _, tnet, _ = pair
    blob, jblob = artifacts["forward"]
    assert isinstance(blob, bytes)
    x = _x(batch)
    got = serving.load_serialized(blob).call(torch.from_numpy(x)).numpy().astype(np.float64)
    with torch.no_grad():
        eager = tnet(torch.from_numpy(x)).numpy().astype(np.float64)
    want = np.asarray(jserving.load_serialized(jblob).call(jnp.asarray(x)), np.float64)
    bias = logit_bias()
    assert got.shape == (batch, 10)
    assert _rel(got - bias, eager - bias) <= 1e-6
    assert _rel(got - bias, want - bias) <= 1e-5
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


@pytest.mark.parametrize("batch", [1, 3])
def test_explain_roundtrip(pair, artifacts, batch):
    from bcosification_tpu import serving as jserving
    from bcosification_tpu_torch import serving
    from bcosification_tpu_torch.explain.fast_resnet import fast_dynamic_linear_weights

    _, _, tnet, _ = pair
    blob, jblob = artifacts["explain"]
    x = _x(batch)
    logits, sel, w = serving.load_serialized(blob).call(torch.from_numpy(x))
    el, es, ew = fast_dynamic_linear_weights(tnet, torch.from_numpy(x), device="cpu")
    jl, js, jw = jserving.load_serialized(jblob).call(jnp.asarray(x))
    bias = logit_bias()
    assert w.shape == x.shape
    np.testing.assert_array_equal(sel.numpy(), es.numpy())
    np.testing.assert_array_equal(sel.numpy(), np.asarray(js))
    assert _rel(w, ew) <= 1e-6
    assert _rel(w, jw) <= 1e-5
    assert _rel(logits.numpy() - bias, el.numpy() - bias) <= 1e-6
    assert _rel(logits.numpy() - bias, np.asarray(jl, np.float64) - bias) <= 1e-5


def test_programs_call_the_kernel_ops(artifacts):
    """The hand-written kernels stay custom ops in the program, so a loaded
    program on a GPU launches (and counts) them as the eager model does."""
    from bcosification_tpu_torch import serving

    targets = {}
    for kind in ("forward", "explain"):
        graph = serving.load_serialized(artifacts[kind][0]).program.graph_module
        nodes = [n for m in graph.modules() for n in getattr(m, "graph", ()).nodes
                 if n.op == "call_function"]
        targets[kind] = {str(n.target) for n in nodes if "bcos_torch" in str(n.target)}
    assert targets["forward"] == {"bcos_torch.conv1x1_fwd.default",
                                  "bcos_torch.bcos_matmul_fwd.default"}
    assert targets["explain"] == targets["forward"] | {"bcos_torch.conv1x1_bwd_explain.default"}


def test_export_explain_rejects_unsupported_models():
    from bcosification_tpu_torch import serving
    from bcosification_tpu_torch.bcosify.engine import build_bcosified_resnet

    cfg = {"name": "resnet50", "bcos_args": {"b": 2},
           "bcosify_args": {"use_bias": True, "norm_layer": "BnUncV2"}}
    net = build_bcosified_resnet(cfg, num_classes=10, inplanes=8,
                                 layers=("bottleneck", (1, 1)), device="cpu")
    with pytest.raises(ValueError, match="not supported"):
        serving.export_explain(net, input_size=SIZE, device="cpu")
