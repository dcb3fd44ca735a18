"""CLIP on PyTorch: the ModifiedResNet and ViT image towers and the text
transformer (counterpart of ``bcosification_tpu/clip/model.py``).

The image tower is built from layer factories, so that one architecture
serves as the frozen fp32 teacher (plain convs, centered eval BN, the
standard attention pool) and as the B-cosified student (BcosifyConv2d with
b=2, uncentered BN, ``BcosAttentionPool2d``; ``bcosify/clip_import.py``).
Activations are NHWC and pooling goes through ``ops/pooling.py``, as in
``models/resnet.py``. Every 1x1 conv of the anti-aliased bottleneck has
stride 1 (the stride sits in an avg-pool), so in the student each one runs
conv -> norm -> act with the conv on the B-cos matmul kernel (K3), as the
JAX module sends it to its Pallas kernel; the hand-scheduled explanation
pass (``explain/fast_clip.py``) folds the norms into K1/K2 instead.

The ViT tower (``CLIPVisionTransformer``) takes the same kind of factories:
the teacher's plain patchify conv, linears and QuickGELU, or the student's
b=2 BcosifyConv2d patchify conv on the 6 AddInverse channels, BcosifyLinears
(out_proj, c_fc, c_proj: K3) and the gate-detaching QuickGELU; the combined
q/k/v projection stays a plain linear in both, with q and k detached in
explanation mode. ``explain/fast_clip_vit.py`` is its autograd-free
explanation pass.

Module names follow the JAX scopes (conv1..3, bn1..3, layer{s}_{j} with
conv1..3, bn1..3, downsample_conv, downsample_norm, attnpool; resblocks_{i}
with attn_in_proj, attn_out_proj, ln_1, ln_2, mlp_c_fc, mlp_c_proj; the
ViT's conv1, class_embedding, positional_embedding, ln_pre, ln_post and
proj), so the JAX variables load with ``bcosify/from_jax.py``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from bcosification_tpu_torch.modules import PlainLinear, PlainReLU
from bcosification_tpu_torch.modules.bcos_layers import _ConvBase
from bcosification_tpu_torch.modules.bcosattnpool import (
    AttentionPool2d,
    BcosAttentionPool2d,
    _heads,
)
from bcosification_tpu_torch.ops import bcos as ops
from bcosification_tpu_torch.ops import pooling

__all__ = [
    "QuickGELU",
    "CLIPLayerNorm",
    "PlainConv2d",
    "EvalBatchNorm",
    "CLIPBottleneck",
    "ModifiedResNet",
    "ResidualAttentionBlock",
    "CLIPVisionTransformer",
    "TextTransformer",
    "CLIP",
    "clip_rn50_config",
    "clip_vit_config",
    "config_from_state_dict",
]


class QuickGELU(nn.Module):
    """CLIP's x * sigmoid(1.702 x). With ``detach_gate`` (the B-cosified ViT
    student) the gate is detached in explanation mode, which makes the
    activation dynamic-linear; the teacher and the text tower keep it
    plain."""

    def __init__(self, detach_gate: bool = False):
        super().__init__()
        self.detach_gate = detach_gate

    def gate(self, x):
        return torch.sigmoid(1.702 * x)

    def forward(self, x, *, train: bool = False, explain: bool = False):
        gate = self.gate(x)
        if self.detach_gate and explain:
            gate = gate.detach()
        return x * gate


class CLIPLayerNorm(nn.Module):
    """LayerNorm over the last axis computed in f32 (biased variance, which
    explanation mode detaches), cast back to x's dtype."""

    def __init__(self, features: int, eps: float = 1e-5, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def normalize(self, x, *, explain: bool = False):
        """(the output, the f32 std sqrt(var + eps) it divided by)."""
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        if explain:
            var = var.detach()
        std = torch.sqrt(var + self.eps)
        return ((xf - mean) / std * self.weight + self.bias).to(x.dtype), std

    def forward(self, x, *, train: bool = False, explain: bool = False):
        return self.normalize(x, explain=explain)[0]


class PlainConv2d(_ConvBase):
    """nn.Conv2d on NHWC activations, OIHW weight; quantized by
    BCOS_INT8 on a served forward (``ops.bcos.int8_route``)."""

    def __init__(self, in_channels: int, features: int, kernel_size=1, *, stride=1,
                 padding=0, **kwargs):
        super().__init__(in_channels, features, kernel_size, stride, padding, **kwargs)

    def forward(self, x, *, train: bool = False, explain: bool = False):
        return ops.conv2d(x, self.weight, self.stride, self.padding, self.dilation, self.groups,
                          allow_int8=not explain and not train)


class EvalBatchNorm(nn.Module):
    """The frozen teacher's centered BN, with its running statistics."""

    def __init__(self, features: int, eps: float = 1e-5, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x, *, train: bool = False, explain: bool = False):
        scale = self.weight / torch.sqrt(self.running_var + self.eps)
        return x * scale.to(x.dtype) + (self.bias - self.running_mean * scale).to(x.dtype)


class CLIPBottleneck(nn.Module):
    """The anti-aliased bottleneck: every conv at stride 1, an avg-pool after
    conv2 when the block downsamples, the downsample an avg-pool and a 1x1
    conv."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, *, conv_layer: Callable,
                 norm_layer: Callable, act_layer: Callable, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.has_downsample = stride, has_downsample
        kw = dict(device=device, generator=generator)
        out = planes * self.expansion
        self.conv1 = conv_layer(inplanes, planes, 1, **kw)
        self.bn1, self.relu1 = norm_layer(planes, device=device), act_layer()
        self.conv2 = conv_layer(planes, planes, 3, padding=1, **kw)
        self.bn2, self.relu2 = norm_layer(planes, device=device), act_layer()
        self.conv3, self.bn3 = conv_layer(planes, out, 1, **kw), norm_layer(out, device=device)
        if has_downsample:
            self.downsample_conv = conv_layer(inplanes, out, 1, **kw)
            self.downsample_norm = norm_layer(out, device=device)
        self.relu3 = act_layer()

    def forward(self, x, *, train: bool = False, explain: bool = False):
        f = dict(train=train, explain=explain)
        out = self.relu1(self.bn1(self.conv1(x, **f), **f), **f)
        out = self.relu2(self.bn2(self.conv2(out, **f), **f), **f)
        if self.stride > 1:
            out = pooling.avg_pool2d(out, self.stride, self.stride)
        out = self.bn3(self.conv3(out, **f), **f)
        identity = x
        if self.has_downsample:
            if self.stride > 1:
                identity = pooling.avg_pool2d(identity, self.stride, self.stride)
            identity = self.downsample_norm(self.downsample_conv(identity, **f), **f)
        return self.relu3(out + identity, **f)


class ModifiedResNet(nn.Module):
    """CLIP's ModifiedResNet: a three-conv stem (3x3/s2, 3x3, 3x3) and a 2x2
    avg-pool, four stages of anti-aliased bottlenecks, an attention pool.

    ``attnpool``: "standard" (the teacher), "bcos" or "bcos_unpool" (the
    student), or None (the feature map)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), output_dim: int = 1024,
                 heads: int = 32, input_resolution: int = 224, width: int = 64, *,
                 in_channels: int = 3, conv_layer: Callable = PlainConv2d,
                 norm_layer: Callable = EvalBatchNorm, act_layer: Callable = PlainReLU,
                 attnpool: Optional[str] = "standard",
                 attnpool_linear_layer: Callable = PlainLinear,
                 attnpool_c_proj_layer: Callable = PlainLinear, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers, self.width, self.heads = tuple(layers), width, heads
        self.input_resolution, self.attnpool_kind = input_resolution, attnpool
        kw = dict(device=device, generator=generator)
        stem = [(in_channels, width // 2, 2), (width // 2, width // 2, 1), (width // 2, width, 1)]
        for i, (cin, cout, stride) in enumerate(stem, start=1):
            setattr(self, f"conv{i}", conv_layer(cin, cout, 3, stride=stride, padding=1, **kw))
            setattr(self, f"bn{i}", norm_layer(cout, device=device))
            setattr(self, f"relu{i}", act_layer())
        for stage, j, planes, stride, has_ds in self.block_cfgs():
            setattr(self, f"layer{stage + 1}_{j}", CLIPBottleneck(
                self.block_in(stage, j), planes, stride, has_ds, conv_layer=conv_layer,
                norm_layer=norm_layer, act_layer=act_layer, **kw))
        embed_dim = width * 32
        if attnpool == "standard":
            self.attnpool = AttentionPool2d(embed_dim, heads, output_dim,
                                            spacial_dim=input_resolution // 32, **kw)
        elif attnpool in ("bcos", "bcos_unpool"):
            self.attnpool = BcosAttentionPool2d(
                embed_dim, heads, output_dim, attn_unpool=attnpool == "bcos_unpool",
                linear_layer=attnpool_linear_layer, c_proj_layer=attnpool_c_proj_layer, **kw)
        elif attnpool is not None:
            raise ValueError(f"unknown attnpool {attnpool!r}")

    def block_in(self, stage: int, j: int) -> int:
        """Input channels of block j of a stage."""
        if stage == 0 and j == 0:
            return self.width
        return self.width * 2 ** (stage + 1) * (2 if j else 1)

    def block_cfgs(self):
        """Per-block (stage, j, planes, stride, has_downsample)."""
        cfgs = []
        for stage, n_blocks in enumerate(self.layers):
            planes = self.width * 2 ** stage
            for j in range(n_blocks):
                stride = 2 if (stage > 0 and j == 0) else 1
                has_ds = stride > 1 or self.block_in(stage, j) != planes * 4
                cfgs.append((stage, j, planes, stride, has_ds))
        return cfgs

    def blocks(self):
        return [getattr(self, f"layer{s + 1}_{j}") for s, j, *_ in self.block_cfgs()]

    def stem(self):
        """[(conv, bn, act, stride)] of the three stem segments."""
        return [(getattr(self, f"conv{i}"), getattr(self, f"bn{i}"), getattr(self, f"relu{i}"),
                 2 if i == 1 else 1) for i in (1, 2, 3)]

    def forward(self, x, *, train: bool = False, explain: bool = False):
        f = dict(train=train, explain=explain)
        for conv, bn, act, _ in self.stem():
            x = act(bn(conv(x, **f), **f), **f)
        x = pooling.avg_pool2d(x, 2, 2)
        for blk in self.blocks():
            x = blk(x, **f)
        if self.attnpool_kind is None:
            return x
        return self.attnpool(x, **f)


class ResidualAttentionBlock(nn.Module):
    """Pre-norm transformer block with the combined q/k/v projection
    ``attn_in_proj`` (always a plain linear), optionally causal (the text
    tower's). ``linear_layer`` (default PlainLinear) builds out_proj, c_fc
    and c_proj and ``act_layer`` (default QuickGELU) the activation: the
    B-cosified ViT student injects BcosifyLinear and the gate-detaching
    QuickGELU."""

    def __init__(self, d_model: int, n_head: int, causal: bool = False, *,
                 linear_layer: Optional[Callable] = None, act_layer: Optional[Callable] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_head, self.causal = n_head, causal
        kw = dict(device=device, generator=generator)
        linear = linear_layer or PlainLinear
        self.attn_in_proj = PlainLinear(d_model, 3 * d_model, **kw)
        self.attn_out_proj = linear(d_model, d_model, **kw)
        self.ln_1 = CLIPLayerNorm(d_model, device=device)
        self.ln_2 = CLIPLayerNorm(d_model, device=device)
        self.mlp_c_fc = linear(d_model, 4 * d_model, **kw)
        self.mlp_gelu = (act_layer or QuickGELU)()
        self.mlp_c_proj = linear(4 * d_model, d_model, **kw)

    def attend(self, q, k):
        """The attention weights [B, heads, N, N] of q and k [B, N, d]."""
        n, d = q.shape[1:]
        dots = torch.einsum("bhnd,bhmd->bhnm", _heads(q, self.n_head), _heads(k, self.n_head))
        dots = dots / (d // self.n_head) ** 0.5
        if self.causal:
            dots = dots + torch.full((n, n), float("-inf"), dtype=q.dtype,
                                     device=q.device).triu(1)
        return torch.softmax(dots, dim=-1)

    def mix(self, attn, v):
        """The heads' attention-weighted v, merged back to [B, N, d]."""
        b, n, d = v.shape
        out = torch.einsum("bhnm,bhmd->bhnd", attn, _heads(v, self.n_head))
        return out.transpose(1, 2).reshape(b, n, d)

    def attention(self, t, f):
        q, k, v = self.attn_in_proj(t).split(t.shape[-1], dim=-1)
        if f["explain"]:
            q, k = q.detach(), k.detach()
        return self.attn_out_proj(self.mix(self.attend(q, k), v), **f)

    def forward(self, x, *, train: bool = False, explain: bool = False):
        f = dict(train=train, explain=explain)
        x = x + self.attention(self.ln_1(x, **f), f)
        h = self.mlp_c_fc(self.ln_2(x, **f), **f)
        return x + self.mlp_c_proj(self.mlp_gelu(h, **f), **f)


def _normal(shape, std, generator, device) -> nn.Parameter:
    return nn.Parameter((torch.randn(shape, generator=generator) * std).to(device))


class TextTransformer(nn.Module):
    """The CLIP text tower: token ids [B, L] -> features [B, embed_dim], read
    at each sequence's end-of-text token (its highest id)."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77, width: int = 512,
                 heads: int = 8, layers: int = 12, embed_dim: int = 1024, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.context_length, self.num_layers = context_length, layers

        self.token_embedding = _normal((vocab_size, width), 0.02, generator, device)
        self.positional_embedding = _normal((context_length, width), 0.01, generator, device)
        for i in range(layers):
            setattr(self, f"resblocks_{i}", ResidualAttentionBlock(
                width, heads, causal=True, device=device, generator=generator))
        self.ln_final = CLIPLayerNorm(width, device=device)
        self.text_projection = _normal((width, embed_dim), width ** -0.5, generator, device)

    def forward(self, text, *, train: bool = False, explain: bool = False):
        f = dict(train=train, explain=explain)
        text = torch.as_tensor(text, device=self.token_embedding.device).long()
        x = self.token_embedding[text] + self.positional_embedding[None, :text.shape[1]]
        for i in range(self.num_layers):
            x = getattr(self, f"resblocks_{i}")(x, **f)
        x = self.ln_final(x, **f)
        x = x[torch.arange(x.shape[0], device=x.device), text.argmax(dim=-1)]
        return x @ self.text_projection


class CLIPVisionTransformer(nn.Module):
    """The CLIP ViT image tower: the patchify conv (kernel = stride = patch,
    no bias), the class token prepended, the positional embedding added in
    x's dtype, ln_pre, the residual blocks, then the pooled head (ln_post of
    the class token @ proj) or, with ``unpool``, the per-token head (ln_post
    of tokens 1: @ proj, divided by its L2 norm, which explanation mode
    detaches): [B, D] or [B, HW, D].

    ``conv_layer``, ``linear_layer`` and ``act_layer`` are the layer
    factories (the defaults build the plain teacher); the student's 6-channel
    patchify conv takes ``in_channels=6``."""

    def __init__(self, input_resolution: int = 224, patch_size: int = 32, width: int = 768,
                 layers: int = 12, heads: int = 12, output_dim: int = 512, *,
                 in_channels: int = 3, conv_layer: Optional[Callable] = None,
                 linear_layer: Optional[Callable] = None, act_layer: Optional[Callable] = None,
                 unpool: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_resolution, self.patch_size = input_resolution, patch_size
        self.width, self.num_layers, self.unpool = width, layers, unpool
        kw = dict(device=device, generator=generator)
        conv = conv_layer or PlainConv2d
        self.conv1 = conv(in_channels, width, patch_size, stride=patch_size, **kw)
        grid = input_resolution // patch_size
        self.class_embedding = _normal((width,), width ** -0.5, generator, device)
        self.positional_embedding = _normal((grid * grid + 1, width), width ** -0.5,
                                            generator, device)
        self.ln_pre = CLIPLayerNorm(width, device=device)
        for i in range(layers):
            setattr(self, f"resblocks_{i}", ResidualAttentionBlock(
                width, heads, linear_layer=linear_layer, act_layer=act_layer, **kw))
        self.proj = _normal((width, output_dim), width ** -0.5, generator, device)
        self.ln_post = CLIPLayerNorm(width, device=device)

    # the raw (width, ...) parameters hold their output units on the last
    # axis, as the linears' (in, out) weights (training/agc.py)
    param_unit_axes = {"positional_embedding": -1, "proj": -1}

    def blocks(self):
        return [getattr(self, f"resblocks_{i}") for i in range(self.num_layers)]

    def tokens(self, x, *, train: bool = False, explain: bool = False):
        """The patch tokens after ln_pre: [B, 1 + HW, width], the class token
        first."""
        x = self.conv1(x, train=train, explain=explain)
        b, h, w, c = x.shape
        x = x.reshape(b, h * w, c)
        cls = self.class_embedding.to(x.dtype).expand(b, 1, c)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)
        return self.ln_pre(x, train=train, explain=explain)

    def head(self, x, *, train: bool = False, explain: bool = False):
        """The pooled or unpooled features of the blocks' output x."""
        proj = self.proj
        if self.unpool:
            tok = self.ln_post(x[:, 1:], train=train, explain=explain)
            out = _promoted(tok, proj) @ proj
            norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
            if explain:
                norm = norm.detach()
            return out / norm
        cls = self.ln_post(x[:, :1], train=train, explain=explain)[:, 0]
        return _promoted(cls, proj) @ proj

    def forward(self, x, *, train: bool = False, explain: bool = False):
        f = dict(train=train, explain=explain)
        x = self.tokens(x, **f)
        for blk in self.blocks():
            x = blk(x, **f)
        return self.head(x, **f)


def _promoted(x, w):
    """x in the dtype of x @ w under JAX's promotion (bf16 @ f32 -> f32)."""
    return x.to(torch.promote_types(x.dtype, w.dtype))


class CLIP(nn.Module):
    """An image tower and the text tower with CLIP's learned logit scale."""

    def __init__(self, visual: nn.Module, text: nn.Module, *, device=None):
        super().__init__()
        self.visual, self.text = visual, text
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07), device=device))

    def encode_image(self, image, *, train: bool = False, explain: bool = False):
        return self.visual(image, train=train, explain=explain)

    def encode_text(self, text, *, train: bool = False, explain: bool = False):
        return self.text(text, train=train, explain=explain)

    def forward(self, image, text, *, train: bool = False, explain: bool = False):
        img = self.encode_image(image, train=train, explain=explain)
        txt = self.encode_text(text, train=train, explain=explain)
        img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
        txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
        logits_per_image = self.logit_scale.exp() * img @ txt.t()
        return logits_per_image, logits_per_image.t()


def clip_rn50_config() -> dict:
    return dict(
        embed_dim=1024,
        image_resolution=224,
        vision_layers=(3, 4, 6, 3),
        vision_width=64,
        vision_patch_size=None,
        context_length=77,
        vocab_size=49408,
        transformer_width=512,
        transformer_heads=8,
        transformer_layers=12,
    )


def clip_vit_config(name: str = "ViT-B/32") -> dict:
    """The published OpenAI CLIP ViT architectures, for towers built without
    a checkpoint."""
    width, layers, patch, embed = {
        "ViT-B/32": (768, 12, 32, 512),
        "ViT-B/16": (768, 12, 16, 512),
        "ViT-L/14": (1024, 24, 14, 768),
    }[name]
    return dict(
        embed_dim=embed,
        image_resolution=224,
        vision_layers=layers,
        vision_width=width,
        vision_patch_size=patch,
        context_length=77,
        vocab_size=49408,
        transformer_width=512 if "B/" in name else 768,
        transformer_heads=8 if "B/" in name else 12,
        transformer_layers=12,
    )


def config_from_state_dict(sd) -> dict:
    """The CLIP architecture of an OpenAI checkpoint (its keys and shapes):
    ``vision_layers`` an int for a ViT tower, a 4-tuple for a ModifiedResNet."""
    if "visual.proj" in sd:
        vision_width, _, _, vision_patch_size = sd["visual.conv1.weight"].shape
        vision_layers = len([k for k in sd if k.startswith("visual.")
                             and k.endswith(".attn.in_proj_weight")])
        grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
        image_resolution = vision_patch_size * grid
    else:
        vision_layers = tuple(len({k.split(".")[2] for k in sd
                                   if k.startswith(f"visual.layer{b}.")}) for b in (1, 2, 3, 4))
        vision_width = sd["visual.layer1.0.conv1.weight"].shape[0]
        out_width = round((sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
        vision_patch_size, image_resolution = None, out_width * 32
    return dict(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=image_resolution,
        vision_layers=vision_layers,
        vision_width=vision_width,
        vision_patch_size=vision_patch_size,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=sd["ln_final.weight"].shape[0],
        transformer_heads=sd["ln_final.weight"].shape[0] // 64,
        transformer_layers=len({k.split(".")[2] for k in sd
                                if k.startswith("transformer.resblocks")}),
    )
