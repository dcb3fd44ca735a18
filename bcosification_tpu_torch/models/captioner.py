"""Greedy caption decoder — the in-framework generative micro-model (the
port's counterpart of ``bcosification_tpu/models/captioner.py``).

The reference's captioning task (`CLIP_benchmark/clip_benchmark/metrics/
captioning.py:1-99`) assumes an external CoCa model from open_clip with
``.generate()``. This framework ships a minimal but real autoregressive
captioner so `--task captioning` is exercisable end-to-end without external
weights: a trainable head that predicts the next token from (image feature,
previous token), decoded greedily in a loop of ``max_len`` steps on the
features' device.

Its weights are named as the JAX head's scopes (``tok_emb``, ``img_proj``,
``head``); ``captioner_from_jax`` carries a flax head's params across, and
``save_captioner`` / ``load_captioner`` keep a head as an npz of its named
arrays.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "GreedyCaptioner",
    "greedy_generate",
    "caption_loss",
    "make_caption_train_step",
    "decode_tokens",
    "captioner_from_jax",
    "save_captioner",
    "load_captioner",
]

# CLIP BPE special token ids (clip/tokenizer.py vocab layout)
CLIP_BOS = 49406
CLIP_EOS = 49407


class GreedyCaptioner(nn.Module):
    """Next-token head: logits = head(tanh(tanh(img_proj(feat)) + tok_emb(prev)))."""

    def __init__(self, feature_dim: int, vocab_size: int, hidden: int = 64,
                 bos: int = CLIP_BOS, eos: int = CLIP_EOS, max_len: int = 16, *,
                 device=None):
        super().__init__()
        self.bos, self.eos, self.max_len = bos, eos, max_len
        with torch.random.fork_rng(devices=[]):  # random init from seed 0
            torch.manual_seed(0)
            self.tok_emb = nn.Embedding(vocab_size, hidden)
            self.img_proj = nn.Linear(feature_dim, hidden)
            self.head = nn.Linear(hidden, vocab_size)
        if device is not None:
            self.to(device)

    def forward(self, features: torch.Tensor, prev_tokens: torch.Tensor) -> torch.Tensor:
        """Teacher forcing: features [B, D], prev_tokens [B, L] -> [B, L, V]."""
        h = torch.tanh(self.img_proj(features))[:, None, :] + self.tok_emb(prev_tokens)
        return self.head(torch.tanh(h))


def greedy_generate(model: GreedyCaptioner, features: torch.Tensor) -> torch.Tensor:
    """Autoregressive greedy decode: [B, D] -> token ids [B, max_len]."""
    prev = torch.full((features.shape[0],), model.bos, dtype=torch.long,
                      device=features.device)
    toks = []
    for _ in range(model.max_len):
        prev = model(features, prev[:, None])[:, 0].argmax(dim=-1)
        toks.append(prev)
    return torch.stack(toks, dim=1)


def caption_loss(model: GreedyCaptioner, features: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forcing cross-entropy. tokens [B, L] starts with BOS."""
    tokens = tokens.long()
    logits = model(features, tokens[:, :-1])
    targets = tokens[:, 1:]
    nll = -F.log_softmax(logits, dim=-1).gather(-1, targets[..., None])[..., 0]
    not_eos = (targets != model.eos).to(nll.dtype)
    # keep position t iff no EOS appears among targets[:, :t]: the first EOS
    # is still a target, and everything after it is ignored regardless of the
    # padding scheme (repeated-EOS or the CLIP tokenizer's zero-padding)
    mask = torch.cat([torch.ones_like(not_eos[:, :1]), torch.cumprod(not_eos[:, :-1], dim=1)],
                     dim=1)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def make_caption_train_step(model: GreedyCaptioner, optimizer: torch.optim.Optimizer):
    """(features, tokens) -> loss: one optimizer step of ``model``."""

    def step(features, tokens):
        loss = caption_loss(model, features, tokens)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def decode_tokens(
    token_ids: np.ndarray,
    eos: int = CLIP_EOS,
    detokenize: Optional[Callable[[Sequence[int]], str]] = None,
) -> List[str]:
    """Token id matrix [B, L] -> list of caption strings (strip at EOS)."""
    if detokenize is None:
        from bcosification_tpu_torch.clip.tokenizer import _get_tokenizer

        detokenize = _get_tokenizer().decode
    out = []
    for row in np.asarray(token_ids):
        toks = []
        for t in row:
            if int(t) == eos:
                break
            toks.append(int(t))
        out.append(detokenize(toks).strip())
    return out


_ARRAYS = ("tok_emb.weight", "img_proj.weight", "img_proj.bias", "head.weight", "head.bias")


def _from_arrays(arrays: Mapping[str, np.ndarray], device=None, **kwargs) -> GreedyCaptioner:
    vocab_size, hidden = arrays["tok_emb.weight"].shape
    model = GreedyCaptioner(arrays["img_proj.weight"].shape[1], vocab_size, hidden,
                            device=device, **kwargs)
    model.load_state_dict({k: torch.from_numpy(np.asarray(arrays[k], np.float32))
                           for k in _ARRAYS})
    return model


def captioner_from_jax(variables, *, device=None, **kwargs) -> GreedyCaptioner:
    """The head of the JAX ``GreedyCaptioner``'s variables (``{"params":
    {"tok_emb": {"embedding"}, "img_proj": {"kernel", "bias"}, "head":
    {"kernel", "bias"}}}``, numpy or JAX arrays; the flax Dense kernels are
    (in, out)). ``kwargs``: bos, eos, max_len when not the defaults."""
    p = variables.get("params", variables)
    arrays = {
        "tok_emb.weight": np.asarray(p["tok_emb"]["embedding"]),
        "img_proj.weight": np.asarray(p["img_proj"]["kernel"]).T,
        "img_proj.bias": np.asarray(p["img_proj"]["bias"]),
        "head.weight": np.asarray(p["head"]["kernel"]).T,
        "head.bias": np.asarray(p["head"]["bias"]),
    }
    return _from_arrays(arrays, device=device, **kwargs)


def save_captioner(model: GreedyCaptioner, path: Union[str, Path]) -> Path:
    """The head as an npz of its named float32 arrays."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    sd = model.state_dict()
    np.savez(path, **{k: sd[k].detach().float().cpu().numpy() for k in _ARRAYS})
    return path


def load_captioner(path: Union[str, Path], *, device=None, **kwargs) -> GreedyCaptioner:
    """A head saved by ``save_captioner``. Any other file raises: a flax
    head (the JAX package's ``flax.serialization`` bytes) converts through
    ``captioner_from_jax`` first."""
    hint = ("convert a flax head with models.captioner.captioner_from_jax and "
            "save_captioner")
    try:
        data = np.load(path, allow_pickle=False)
    except (OSError, ValueError) as e:
        raise ValueError(f"{path} is not an npz of the caption head's named arrays "
                         f"{_ARRAYS}; {hint}") from e
    if not hasattr(data, "files"):
        raise ValueError(f"{path} holds one array, not the caption head's {_ARRAYS}; {hint}")
    with data:
        arrays = {k: data[k] for k in data.files}
    if set(arrays) != set(_ARRAYS):
        raise ValueError(f"{path} holds {sorted(arrays)}, not the caption head's arrays "
                         f"{_ARRAYS}; {hint}")
    return _from_arrays(arrays, device=device, **kwargs)
