"""The port's greedy caption head (``bcosification_tpu_torch/models/
captioner.py``) against the JAX package's ``models/captioner.py`` on the
CPU, the flax head's params carried across by ``captioner_from_jax``:

- ``greedy_generate``'s tokens equal, ``caption_loss`` within 1e-5 (also on
  zero-padded and EOS-padded targets), ``decode_tokens`` equal;
- three SGD steps of ``make_caption_train_step``: the losses within 1e-5;
- ``save_captioner`` / ``load_captioner`` round trip; a file that is not the
  head's npz (the JAX loader's flax bytes) raises, naming
  ``captioner_from_jax``;
- the ``bcos_captioner`` bundle through the benchmark CLI (``--task
  captioning``) on the small CLIP-RN50 of tests/test_torch_clip_benchmark.py
  with the same head: the captions and their scores equal to the JAX CLI's.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

VOCAB, BOS, EOS, MAX_LEN = 40, 38, 39, 7


def _jax_head(feature_dim=12, seed=0):
    from bcosification_tpu.models import captioner as jcap

    model = jcap.GreedyCaptioner(vocab_size=VOCAB, hidden=16, bos=BOS, eos=EOS, max_len=MAX_LEN)
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((5, feature_dim)).astype(np.float32)
    variables = model.init(jax.random.PRNGKey(seed), jnp.asarray(feats),
                           jnp.zeros((1, 1), jnp.int32))
    # redraw every leaf from the seed (flax's init leaves the biases at 0)
    variables = jax.tree_util.tree_map(
        lambda leaf: (rng.standard_normal(leaf.shape) * 0.7).astype(np.float32), variables)
    return model, variables, feats


def _port_head(variables):
    from bcosification_tpu_torch.models import captioner as tcap

    return tcap.captioner_from_jax(variables, bos=BOS, eos=EOS, max_len=MAX_LEN)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_greedy_generate_and_loss_match_jax():
    from bcosification_tpu.models import captioner as jcap
    from bcosification_tpu_torch.models import captioner as tcap

    model, variables, feats = _jax_head()
    head = _port_head(variables)
    want = np.asarray(jcap.greedy_generate(model, variables, jnp.asarray(feats)))
    with torch.no_grad():
        got = tcap.greedy_generate(head, torch.from_numpy(feats)).numpy()
    np.testing.assert_array_equal(got, want)
    tokens = np.random.default_rng(1).integers(0, BOS, (5, 9))
    tokens[:, 0] = BOS
    tokens[0, 4:] = EOS      # EOS-padded
    tokens[1, 3] = EOS       # then zero-padded, as CLIP's tokenizer pads
    tokens[1, 4:] = 0
    jl = float(jcap.caption_loss(model, variables, jnp.asarray(feats), jnp.asarray(tokens)))
    tl = float(tcap.caption_loss(head, torch.from_numpy(feats), torch.from_numpy(tokens)))
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    detok = lambda ids: " ".join(f"w{i}" for i in ids)  # noqa: E731
    assert tcap.decode_tokens(got, eos=EOS, detokenize=detok) == jcap.decode_tokens(
        want, eos=EOS, detokenize=detok)


def test_decode_tokens_with_the_clip_tokenizer_matches_jax():
    from bcosification_tpu.models import captioner as jcap
    from bcosification_tpu_torch.models import captioner as tcap

    ids = np.random.default_rng(2).integers(1000, 40000, (3, 10))
    ids[1, 4] = tcap.CLIP_EOS
    assert tcap.decode_tokens(ids) == jcap.decode_tokens(ids)


def test_train_steps_match_jax():
    """Three SGD steps (lr 0.5) of make_caption_train_step: the losses."""
    import optax

    from bcosification_tpu.models import captioner as jcap
    from bcosification_tpu_torch.models import captioner as tcap

    model, variables, feats = _jax_head(seed=3)
    head = _port_head(variables)
    tokens = np.random.default_rng(4).integers(0, BOS, (5, 6))
    tokens[:, 0] = BOS
    tx = optax.sgd(0.5)
    jstep = jcap.make_caption_train_step(model, tx)
    params, opt_state = variables["params"], tx.init(variables["params"])
    tstep = tcap.make_caption_train_step(head, torch.optim.SGD(head.parameters(), lr=0.5))
    for _ in range(3):
        params, opt_state, jl = jstep(params, opt_state, jnp.asarray(feats), jnp.asarray(tokens))
        tl = tstep(torch.from_numpy(feats), torch.from_numpy(tokens))
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))


def test_save_load_round_trip_and_foreign_files_raise(tmp_path):
    import flax.serialization

    from bcosification_tpu_torch.models import captioner as tcap

    _, variables, feats = _jax_head(seed=5)
    head = _port_head(variables)
    path = tcap.save_captioner(head, tmp_path / "head.npz")
    back = tcap.load_captioner(path, bos=BOS, eos=EOS, max_len=MAX_LEN)
    for (k, v), (k2, v2) in zip(head.state_dict().items(), back.state_dict().items()):
        assert k == k2 and torch.equal(v, v2)
    with torch.no_grad():
        x = torch.from_numpy(feats)
        assert torch.equal(tcap.greedy_generate(back, x), tcap.greedy_generate(head, x))
    (tmp_path / "flax.npz").write_bytes(flax.serialization.to_bytes(variables))
    np.savez(tmp_path / "other.npz", w=np.zeros(3))
    np.save(tmp_path / "one.npy", np.zeros(3))
    for name in ("flax.npz", "other.npz", "one.npy"):
        with pytest.raises(ValueError, match="captioner_from_jax"):
            tcap.load_captioner(tmp_path / name)


def test_bcos_captioner_cli_matches_jax(tmp_path, monkeypatch):
    """``eval --task captioning --model_type bcos_captioner`` over
    dummy_retrieval: the JAX CLI reads the head's flax bytes, the port its
    npz (captioner_from_jax + save_captioner); the metrics are equal."""
    import sys

    import flax.serialization

    from bcosification_tpu.models import captioner as jcap
    from bcosification_tpu_torch.models import captioner as tcap
    from clip_benchmark import cli as jcli
    from bcosification_tpu_torch.clip_benchmark import cli as tcli
    from test_torch_clip_benchmark import small_clip_env

    small_clip_env(tmp_path, monkeypatch)
    model = jcap.GreedyCaptioner(vocab_size=49408)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32), jnp.float32),
                           jnp.zeros((1, 1), jnp.int32))
    rng = np.random.default_rng(6)
    variables = jax.tree_util.tree_map(
        lambda leaf: (rng.standard_normal(leaf.shape) * 0.5).astype(np.float32), variables)
    (tmp_path / "head_jax.npz").write_bytes(flax.serialization.to_bytes(variables))
    tcap.save_captioner(tcap.captioner_from_jax(variables), tmp_path / "head_port.npz")
    name = "resnet_50_clip_b2_noBias_randomResizedCrop_sigLip_ImageNet_bcosification"
    args = ["eval", "--dataset", "dummy_retrieval", "--task", "captioning", "--model_type",
            "bcos_captioner", "--model", name, "--batch_size", "8", "--num_workers", "1"]
    monkeypatch.setattr(sys, "argv", ["cli"] + args + [
        "--pretrained", str(tmp_path / "head_jax.npz"), "--output", str(tmp_path / "j.json")])
    jcli.main()
    tcli.main(args + ["--pretrained", str(tmp_path / "head_port.npz"), "--output",
                      str(tmp_path / "t.json")], device="cpu")
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    assert got["metrics"] == want["metrics"]
    assert {k: v for k, v in got.items() if k != "pretrained"} == {
        k: v for k, v in want.items() if k != "pretrained"}
