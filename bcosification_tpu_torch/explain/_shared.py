"""What the hand-scheduled explanation passes share
(``explain/fast_resnet.py``, ``fast_densenet.py``, ``fast_vgg.py``,
``fast_convnext.py``, ``fast_vit.py``, ``fast_clip.py``): finding a model's
parts and the layers a pass is written for, the explanation-mode forward
and the explicit linear transpose of each layer (B-cos convs, eval BNs,
position norms, pools), and the input normalisation and the selected
class's cotangent."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bcosification_tpu_torch.modules import DetachablePositionNorm2d, PlainReLU, ReLU
from bcosification_tpu_torch.ops import bcos as ops
from bcosification_tpu_torch.ops.cuda.bcos_conv1x1 import conv1x1_bwd_explain
from bcosification_tpu_torch.ops.cuda.bcos_matmul import bcos_matmul_fwd


def parts(net):
    """(the backbone, the BcosifyNetwork around it or None)."""
    from bcosification_tpu_torch.models.bcosify_net import BcosifyNetwork

    if isinstance(net, BcosifyNetwork):
        return net.model, net
    return net, None


def logit_layers(net):
    """The logit layers after the classifier, in forward order."""
    m, wrapper = parts(net)
    return [owner.logit_layer for owner in (m, wrapper)
            if owner is not None and owner.with_logit_layer]


def _b2_convs(m):
    """``m``'s convs if they are all B-cos convs of one type (BcosConv2d or
    BcosifyConv2d), b=2, max_out 1, undilated and bias-free; else None."""
    from bcosification_tpu_torch.modules import BcosConv2d, BcosifyConv2d
    from bcosification_tpu_torch.modules.bcos_layers import _ConvBase

    convs = [mod for mod in m.modules() if isinstance(mod, _ConvBase)]
    if len({type(c) for c in convs}) != 1 or type(convs[0]) not in (BcosConv2d, BcosifyConv2d):
        return None
    if any(c.b != 2 or c.max_out != 1 or c.bias is not None or c.dilation != (1, 1)
           for c in convs):
        return None
    return convs


def plain_b2_layers(m):
    """The number of uncentered BNs of ``m`` minus that of its B-cos convs,
    or None unless every conv is of one type, b=2, max_out 1, ungrouped,
    undilated and bias-free, and every activation is of one type (ReLU, the
    CLIP towers' PlainReLU or Identity): the layers the hand-scheduled
    passes are written for."""
    from bcosification_tpu_torch.modules import BatchNormUncentered2d, Identity

    convs = _b2_convs(m)
    if convs is None or any(c.groups != 1 for c in convs):
        return None
    acts = [mod for mod in m.modules() if isinstance(mod, (ReLU, PlainReLU, Identity))]
    if len({type(a) for a in acts}) != 1:
        return None
    norms = [mod for mod in m.modules() if isinstance(mod, BatchNormUncentered2d)]
    return len(norms) - len(convs)


def position_norm_layers(m) -> bool:
    """True if ``m`` is a net of the from-scratch zoo's layers: b=2 B-cos
    convs (``_b2_convs``), DetachablePositionNorm2d its only norm and
    Identity its only activation."""
    from bcosification_tpu_torch.modules import (
        BatchNormUncentered2d,
        DetachableGELU,
        DetachableLayerNorm,
        Identity,
    )
    from bcosification_tpu_torch.modules.norms import DetachableGroupNorm2d

    if _b2_convs(m) is None:
        return False
    mods = list(m.modules())
    norms = [mod for mod in mods if isinstance(
        mod, (BatchNormUncentered2d, DetachableLayerNorm, DetachableGroupNorm2d))]
    acts = [mod for mod in mods if isinstance(mod, (ReLU, PlainReLU, DetachableGELU, Identity))]
    return (bool(norms) and all(type(n) is DetachablePositionNorm2d for n in norms)
            and all(type(a) is Identity for a in acts))


def zoo_layers(m) -> bool:
    """True if ``m``'s convs are b=2 B-cos convs (``_b2_convs``) and every
    other leaf module is DetachablePositionNorm2d, BatchNormUncentered2d,
    StochasticDepth or a LogitLayer: the layers of the zoo's VGG and
    ConvNeXt nets, which ``_Conv`` and ``_Norm`` transpose."""
    from bcosification_tpu_torch.modules import (
        BatchNormUncentered2d,
        BcosConv2d,
        BcosifyConv2d,
        LogitLayer,
    )
    from bcosification_tpu_torch.modules.stochastic_depth import StochasticDepth

    allowed = (BcosConv2d, BcosifyConv2d, DetachablePositionNorm2d, BatchNormUncentered2d,
               StochasticDepth, LogitLayer)
    leaves = [mod for mod in m.modules() if not any(True for _ in mod.children())]
    return _b2_convs(m) is not None and all(type(mod) in allowed for mod in leaves)


def _weight(conv, dtype) -> torch.Tensor:
    return conv.effective_weight().to(dtype)


def _wt(conv, dtype) -> torch.Tensor:
    """A 1x1 conv's weight as the kernels' wt [Cout, Cin]."""
    w = _weight(conv, dtype)
    return w.reshape(w.shape[0], w.shape[1]).contiguous()


class _BN:
    """One eval BN's terms: std, gamma, beta, the folded mult = gamma/std and
    the backward factor sm = sign(m) sqrt|m|."""

    def __init__(self, bn):
        self.std = bn.std()
        self.gamma, self.beta = bn.weight, bn.bias
        self.mult = (self.gamma / self.std if self.gamma is not None else 1.0 / self.std)
        self.mult = self.mult.float().contiguous()
        self.add = None if self.beta is None else self.beta.float().contiguous()
        self.sm = torch.sign(self.mult) * torch.sqrt(self.mult.abs())


def _seg_fwd(u, n, bn: _BN, relu: bool):
    """Value path op for op like the modules: dynamic scale and the divide
    by std in u's dtype, the affine in f32, one cast."""
    r = ((u.abs() / n) * u) / bn.std.to(u.dtype)
    if bn.gamma is not None:
        r = r * bn.gamma
    if bn.beta is not None:
        r = r + bn.beta
    z = r.to(u.dtype)
    return torch.relu(z) if relu else z


def _seg_bwd(ct, z, n, bn: _BN, relu: bool, identity=None):
    """ct_u from the segment output z (minus the skip branch, if any), the
    scale rebuilt from it."""
    if relu:
        ct = torch.where(z > 0, ct, torch.zeros_like(ct))
    zz = z if identity is None else z - identity
    if bn.beta is not None:
        zz = (zz.float() - bn.beta).to(z.dtype)
    return ct * bn.sm.to(z.dtype) * torch.sqrt(zz.abs() / n)


def _conv_t(ct, w, x_shape, stride: int, padding: int, groups: int = 1):
    """Transpose of a conv (NHWC ct, OIHW w) back to an input of x_shape."""
    kh, kw = w.shape[2], w.shape[3]
    hc, wc = ct.shape[1], ct.shape[2]
    out_pad = (x_shape[1] - ((hc - 1) * stride - 2 * padding + kh),
               x_shape[2] - ((wc - 1) * stride - 2 * padding + kw))
    y = F.conv_transpose2d(ops.nchw(ct), w, stride=stride, padding=padding,
                           output_padding=out_pad, groups=groups)
    return ops.nhwc(y)


def _pool_t(ct, shape, k: int, s: int, p: int):
    """Transpose of avg_pool2d(k, s, p) (count_include_pad) back to ``shape``."""
    c = ct.shape[-1]
    w = torch.full((c, 1, k, k), 1.0 / (k * k), dtype=ct.dtype, device=ct.device)
    return _conv_t(ct, w, shape, s, p, groups=c)


def _bn_act(a, bn: _BN, relu: bool):
    """An eval BN and the activation, op for op as the modules compute them."""
    r = a / bn.std.to(a.dtype)
    if bn.gamma is not None:
        r = r * bn.gamma
    if bn.beta is not None:
        r = r + bn.beta
    r = r.to(a.dtype)
    return torch.relu(r) if relu else r


def _bn_act_bwd(ct, out, bn: _BN, relu: bool):
    """Cotangent of a BN + activation's input from that of its output ``out``."""
    if relu:
        ct = torch.where(out > 0, ct, torch.zeros_like(ct))
    return ct * bn.mult.to(ct.dtype)


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1]).contiguous()


def _norm_bwd(ct, norm, std, dtype):
    """A LayerNorm's (or position norm's) input cotangent, its variance
    detached: c - mean(c) over the last axis with c = ct * weight / std, in
    f32, cast to the input's dtype."""
    c = ct.float()
    if norm.weight is not None:
        c = c * norm.weight
    c = c / std
    return (c - c.mean(-1, keepdim=True)).to(dtype)


class _Conv:
    """One B-cos conv's explanation-mode forward and the transpose of its
    map. A stride-1 1x1 conv runs K3 forward and K2 backward (the bare
    cotangent), recomputing u; any other keeps its detached dynamic scale
    and is transposed by ``_conv_t``."""

    def __init__(self, conv, x: torch.Tensor):
        self.x, self.dtype = x, x.dtype
        self.w = _weight(conv, x.dtype)
        self.stride, self.padding, self.groups = conv.stride[0], conv.padding[0], conv.groups
        self.matmul = (conv.kernel_size == (1, 1) and conv.stride == (1, 1)
                       and conv.padding == (0, 0) and conv.groups == 1)
        if self.matmul:
            self.wt = self.w.reshape(self.w.shape[0], self.w.shape[1]).contiguous()

    def forward(self) -> torch.Tensor:
        """The output in x's dtype, as ``ops.bcos_conv2d`` gives it."""
        x = self.x
        if self.matmul:
            y = bcos_matmul_fwd(_flat(x), self.wt, eps=ops.CONV_NORM_EPS, eps_outside=False)
            return y.view(x.shape[:3] + (-1,)).to(self.dtype)
        u = ops.conv2d(x, self.w, self.stride, self.padding, 1, self.groups)
        n = ops.patch_norms(x, self.w.shape[2:], stride=self.stride, padding=self.padding,
                            groups=self.groups).to(u.dtype)
        if self.groups > 1:  # each group's norm over its output channels
            g = ops._per_group(u, self.groups)
            self.scale = (g.abs() / n[..., None]).reshape(u.shape)
        else:
            self.scale = u.abs() / n
        return self.scale * u

    def backward(self, ct: torch.Tensor) -> torch.Tensor:
        """The input's cotangent from the output's ``ct``."""
        if self.matmul:
            dx = conv1x1_bwd_explain(_flat(self.x), self.wt, _flat(ct.to(self.dtype)), None,
                                     None, relu=False)
            return dx.view(self.x.shape)
        return _conv_t(ct * self.scale, self.w, self.x.shape, self.stride, self.padding,
                       self.groups)


class _Norm:
    """One norm of a zoo net in explanation mode, forward and transpose: the
    position norm (its variance detached: ``_norm_bwd``) or an eval
    uncentered BN (a per-channel affine)."""

    def __init__(self, norm, x: torch.Tensor):
        self.norm, self.dtype = norm, x.dtype
        if isinstance(norm, DetachablePositionNorm2d):
            self.bn = None
            self.out, self.std = norm.normalize(x, explain=True)
        else:
            self.bn = _BN(norm)
            self.out = _bn_act(x, self.bn, False)

    def backward(self, ct: torch.Tensor) -> torch.Tensor:
        if self.bn is None:
            return _norm_bwd(ct, self.norm, self.std, self.dtype)
        # op for op as the module's autograd: the affine in f32, the divide
        # by the std in the input's dtype
        if self.bn.gamma is not None:
            ct = (ct.float() * self.bn.gamma).to(self.dtype)
        return ct / self.bn.std.to(self.dtype)


class _ConvNorm:
    """conv -> norm (Identity activation): forward and transpose."""

    def __init__(self, conv, norm, x: torch.Tensor):
        self.conv = _Conv(conv, x)
        self.norm = _Norm(norm, self.conv.forward())
        self.out = self.norm.out

    def backward(self, ct: torch.Tensor) -> torch.Tensor:
        return self.conv.backward(self.norm.backward(ct))


def _normalize(wrapper, x):
    """(the BcosifyNetwork's Normalize of x, its std), or (x, None) bare."""
    if wrapper is None:
        return x, None
    mean = torch.tensor(wrapper.mean, dtype=x.dtype, device=x.device)
    std_in = torch.tensor(wrapper.std, dtype=x.dtype, device=x.device)
    return (x - mean) / std_in, std_in


def _selected_cotangent(net, logits, idx):
    """(selected class per image, the one-hot cotangent of the classifier's
    pooled output: through the logit layers' temperatures)."""
    if idx is None:
        sel = logits.argmax(dim=1)
    else:
        sel = torch.as_tensor(idx, device=logits.device).expand(logits.shape[0])
    ct = F.one_hot(sel, logits.shape[-1]).to(logits.dtype)
    for layer in logit_layers(net):
        if layer.logit_temperature is not None:
            ct = ct / layer.logit_temperature
    return sel, ct
