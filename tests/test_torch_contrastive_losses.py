"""The reference's contrastive losses in the port (``info_nce``,
``InfoNCELoss``, ``ClipLoss``, ``CoCaLoss``, ``DistillClipLoss``) against
the JAX package's one-process forms on seeded features, in fp32 on the CPU
within 1e-6 relative, the gradients of the features within 1e-5; the
gathers across processes raise, naming ROADMAP A9."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)


def _feats(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=1e-7)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("negatives", ["none", "unpaired", "paired"])
def test_info_nce_matches_jax(negatives, reduction):
    from bcosification_tpu import losses as jl
    from bcosification_tpu_torch import losses as tl

    q, p = _feats(6, 8, seed=1), _feats(6, 8, seed=2)
    neg = {"none": None, "unpaired": _feats(5, 8, seed=3), "paired": _feats(6, 5, 8, seed=3)}[
        negatives]
    mode = "paired" if negatives == "paired" else "unpaired"

    def run(lib, asarray):
        loss = lib.InfoNCELoss(temperature=0.2, reduction=reduction, negative_mode=mode)
        return loss(asarray(q), asarray(p), None if neg is None else asarray(neg))

    want = run(jl, jnp.asarray)
    got = run(tl, torch.from_numpy)
    _close(got, want)
    if reduction == "mean":
        jg = jax.grad(lambda a: jl.info_nce(a, p, neg, 0.2, negative_mode=mode))(jnp.asarray(q))
        qt = torch.from_numpy(q).requires_grad_(True)
        tl.info_nce(qt, torch.from_numpy(p), None if neg is None else torch.from_numpy(neg),
                    0.2, negative_mode=mode).backward()
        _close(qt.grad, jg, rtol=1e-5)


def test_clip_coca_and_distill_losses_match_jax():
    from bcosification_tpu import losses as jl
    from bcosification_tpu_torch import losses as tl

    img, txt = _feats(7, 16, seed=4), _feats(7, 16, seed=5)
    dimg, dtxt = _feats(7, 16, seed=6), _feats(7, 16, seed=7)
    t = torch.from_numpy
    _close(tl.ClipLoss()(t(img), t(txt), 2.5), jl.ClipLoss()(img, txt, 2.5))
    jg = jax.grad(lambda a: jl.ClipLoss()(a, txt, 2.5))(jnp.asarray(img))
    it = t(img).requires_grad_(True)
    tl.ClipLoss()(it, t(txt), 2.5).backward()
    _close(it.grad, jg, rtol=1e-5)

    got = tl.DistillClipLoss()(t(img), t(txt), 2.5, t(dimg), t(dtxt), 4.0)
    want = jl.DistillClipLoss()(img, txt, 2.5, dimg, dtxt, 4.0)
    for g, w in zip(got, want):
        _close(g, w)

    logits = _feats(7, 9, 30, seed=8)
    labels = np.random.default_rng(9).integers(0, 30, (7, 9)).astype(np.int32)
    labels[:, -3:] = 0  # padding
    for weights in ({}, {"clip_loss_weight": 0.0, "caption_loss_weight": 2.0}):
        got = tl.CoCaLoss(**weights)(t(img), t(txt), t(logits), t(labels), 2.5)
        want = jl.CoCaLoss(**weights)(img, txt, logits, labels, 2.5)
        for g, w in zip(got, want):
            _close(g, w)


def test_gathers_across_processes_raise_naming_a9():
    from bcosification_tpu_torch import losses as tl

    x = torch.zeros(2, 4)
    for call in (lambda: tl.gather_features(x, x), lambda: tl.neighbour_exchange(x),
                 lambda: tl.neighbour_exchange_bidir(x, x),
                 lambda: tl.ClipLoss(world_size=2)(x, x, 1.0)):
        with pytest.raises(NotImplementedError, match="A9"):
            call()
