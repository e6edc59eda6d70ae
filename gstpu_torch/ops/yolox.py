"""YOLOX forward pass in torch: the port of gstpu/ops/yolox.py.

The full architecture of the reference burn-yoloxinference: Focus stem
-> CSPDarknet (dark2..dark5 with SPP) -> PAFPN neck -> decoupled YOLOX
head, as an nn.Module tree whose `state_dict()` keys are gstpu's
parameter names, the official YOLOX state-dict names
("backbone.backbone.dark2.0.conv.weight", "head.cls_preds.0.bias", ...).
So a Megvii .pth loads with a strict `load_state_dict`, and a
checkpoint the port saves loads through gstpu's `load_torch_checkpoint`.
The BN statistics are buffers.

gstpu keeps its parameters as numpy in HWIO (`init_params`,
`load_params`/`save_params`, an `.npz` with a `__meta__` entry);
`params_from_gstpu` turns such a dict into this module's OIHW state
dict.

The model computes in NCHW: the convolutions are F.conv2d with explicit
(k-1)//2 padding, BN is gstpu's formula `(x - mean) * rsqrt(var + 1e-3)
* gamma + beta`, then SiLU. Each head level is permuted to NHWC before
its rows are flattened, so the output (A, 5 + C) has gstpu's row layout
`(reg4 | obj1 | cls C)`, levels at strides 8/16/32, row-major per level,
matching detection.yolox_grids. The forward runs with TF32 off
(`core.device.tf32_off`, counted across threads), so f32 convolutions on
the card compute what the CPU computes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gstpu_torch.core.device import default_device, tf32_off

# (depth, width, depthwise) per model size, reference darknet.rs /
# official YOLOX exps
PRESETS = {
    "nano": (0.33, 0.25, True),
    "tiny": (0.33, 0.375, False),
    "s": (0.33, 0.50, False),
    "m": (0.67, 0.75, False),
    "l": (1.0, 1.0, False),
    "x": (1.33, 1.25, False),
}

BN_EPS = 1e-3  # YOLOX BaseConv uses BatchNorm2d(eps=1e-3)


def _expand(ch: int, width: float) -> int:
    return int(ch * width)


def _base_depth(depth: float) -> int:
    return max(round(depth * 3), 1)


# ---------------------------------------------------------------------------
# parameter-tree construction (official state-dict names), as in gstpu
# ---------------------------------------------------------------------------

class _Shapes:
    """Collects (name -> HWIO shape) for every parameter in the graph."""

    def __init__(self):
        self.shapes: dict[str, tuple] = {}

    def base_conv(self, p: str, cin: int, cout: int, k: int,
                  groups: int = 1):
        self.shapes[f"{p}.conv.weight"] = (k, k, cin // groups, cout)
        for s in ("weight", "bias", "running_mean", "running_var"):
            self.shapes[f"{p}.bn.{s}"] = (cout,)

    def conv(self, p: str, cin: int, cout: int, k: int,
             depthwise: bool):
        if depthwise:
            self.base_conv(f"{p}.dconv", cin, cin, k, groups=cin)
            self.base_conv(f"{p}.pconv", cin, cout, 1)
        else:
            self.base_conv(p, cin, cout, k)

    def plain_conv(self, p: str, cin: int, cout: int, k: int):
        self.shapes[f"{p}.weight"] = (k, k, cin, cout)
        self.shapes[f"{p}.bias"] = (cout,)

    def csp_layer(self, p: str, cin: int, cout: int, n: int,
                  expansion: float, depthwise: bool):
        hidden = int(cout * expansion)
        self.base_conv(f"{p}.conv1", cin, hidden, 1)
        self.base_conv(f"{p}.conv2", cin, hidden, 1)
        self.base_conv(f"{p}.conv3", 2 * hidden, cout, 1)
        for i in range(n):
            self.base_conv(f"{p}.m.{i}.conv1", hidden, hidden, 1)
            self.conv(f"{p}.m.{i}.conv2", hidden, hidden, 3, depthwise)

    def spp(self, p: str, cin: int, cout: int):
        hidden = cin // 2
        self.base_conv(f"{p}.conv1", cin, hidden, 1)
        self.base_conv(f"{p}.conv2", hidden * 4, cout, 1)


def _build_shapes(num_classes: int, depth: float, width: float,
                  depthwise: bool) -> dict[str, tuple]:
    s = _Shapes()
    c = _expand(64, width)
    d = _base_depth(depth)
    bb = "backbone.backbone"
    # Focus stem: conv over 12 channels (4x space-to-depth of RGB)
    s.base_conv(f"{bb}.stem.conv", 12, c, 3)
    # dark2..dark5 (darknet.rs CspBlock: conv s2 [+ spp] + csp)
    s.conv(f"{bb}.dark2.0", c, c * 2, 3, depthwise)
    s.csp_layer(f"{bb}.dark2.1", c * 2, c * 2, d, 0.5, depthwise)
    s.conv(f"{bb}.dark3.0", c * 2, c * 4, 3, depthwise)
    s.csp_layer(f"{bb}.dark3.1", c * 4, c * 4, d * 3, 0.5, depthwise)
    s.conv(f"{bb}.dark4.0", c * 4, c * 8, 3, depthwise)
    s.csp_layer(f"{bb}.dark4.1", c * 8, c * 8, d * 3, 0.5, depthwise)
    s.conv(f"{bb}.dark5.0", c * 8, c * 16, 3, depthwise)
    s.spp(f"{bb}.dark5.1", c * 16, c * 16)
    s.csp_layer(f"{bb}.dark5.2", c * 16, c * 16, d, 0.5, depthwise)
    # PAFPN (pafpn.rs / official YOLOPAFPN)
    nk = "backbone"
    s.base_conv(f"{nk}.lateral_conv0", c * 16, c * 8, 1)
    s.csp_layer(f"{nk}.C3_p4", c * 16, c * 8, d, 0.5, depthwise)
    s.base_conv(f"{nk}.reduce_conv1", c * 8, c * 4, 1)
    s.csp_layer(f"{nk}.C3_p3", c * 8, c * 4, d, 0.5, depthwise)
    s.conv(f"{nk}.bu_conv2", c * 4, c * 4, 3, depthwise)
    s.csp_layer(f"{nk}.C3_n3", c * 8, c * 8, d, 0.5, depthwise)
    s.conv(f"{nk}.bu_conv1", c * 8, c * 8, 3, depthwise)
    s.csp_layer(f"{nk}.C3_n4", c * 16, c * 16, d, 0.5, depthwise)
    # decoupled head (head.rs / official YOLOXHead), 256*width stems
    hc = _expand(256, width)
    for i, cin in enumerate((c * 4, c * 8, c * 16)):
        s.base_conv(f"head.stems.{i}", cin, hc, 1)
        for j in range(2):
            s.conv(f"head.cls_convs.{i}.{j}", hc, hc, 3, depthwise)
            s.conv(f"head.reg_convs.{i}.{j}", hc, hc, 3, depthwise)
        s.plain_conv(f"head.cls_preds.{i}", hc, num_classes, 1)
        s.plain_conv(f"head.reg_preds.{i}", hc, 4, 1)
        s.plain_conv(f"head.obj_preds.{i}", hc, 1, 1)
    return s.shapes


def _meta(num_classes: int, size: str) -> np.ndarray:
    return np.array(
        [num_classes, {k: i for i, k in enumerate(PRESETS)}[size]],
        np.int32)


def init_params(num_classes: int = 80, seed: int = 0,
                size: str = "tiny") -> dict:
    """Deterministic random parameters in gstpu's HWIO numpy form (for
    tests / no-weights mode): the same values as gstpu's init_params."""
    depth, width, depthwise = PRESETS[size]
    rng = np.random.default_rng(seed)
    params = {}
    for name, shape in _build_shapes(num_classes, depth, width,
                                     depthwise).items():
        if name.endswith(("running_var", "bn.weight")):
            params[name] = np.ones(shape, np.float32)
        elif len(shape) == 1:
            params[name] = np.zeros(shape, np.float32)
        else:
            fan_in = shape[0] * shape[1] * shape[2]
            params[name] = rng.normal(
                0, (2.0 / fan_in) ** 0.5, shape).astype(np.float32)
    params["__meta__"] = _meta(num_classes, size)
    return params


def save_params(path: str, params: dict) -> None:
    np.savez(path, **params)


def load_params(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def params_meta(params: dict) -> tuple[int, str]:
    meta = params.get("__meta__")
    if meta is None:
        return 80, "tiny"
    sizes = list(PRESETS)
    return int(meta[0]), sizes[int(meta[1])]


def params_from_gstpu(params: dict) -> dict[str, torch.Tensor]:
    """gstpu's parameter dict (HWIO numpy, `__meta__`) -> this model's
    state dict: conv weights HWIO -> OIHW, a depthwise (k, k, 1, C)
    becoming (C, 1, k, k); vectors as they are."""
    out = {}
    for name, a in params.items():
        if name == "__meta__":
            continue
        a = np.asarray(a, np.float32)
        if a.ndim == 4:
            a = np.transpose(a, (3, 2, 0, 1))
        out[name] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def load_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """An official YOLOX .pth checkpoint (Megvii format: a dict with a
    'model' state dict, conv weights OIHW) as this model's state dict,
    OIHW as it is. BatchNorm's `num_batches_tracked` counters are
    dropped (inference reads only the running statistics); `build_model`
    loads the rest strictly, so every other entry must match the
    model's names and shapes."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt.get("model", ckpt)
    return {k: v.detach().to(torch.float32) for k, v in state.items()
            if not k.endswith("num_batches_tracked")}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class _BN(nn.Module):
    """BatchNorm2d(eps=1e-3) in inference form, with gstpu's formula."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        shape = (-1, 1, 1)
        return (x - self.running_mean.view(shape)) \
            * torch.rsqrt(self.running_var.view(shape) + BN_EPS) \
            * self.weight.view(shape) + self.bias.view(shape)


class BaseConv(nn.Module):
    """conv (bias-free, explicit (k-1)//2 padding) -> BN -> SiLU."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, (k - 1) // 2,
                              groups=groups, bias=False)
        self.bn = _BN(cout)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class DWConv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.dconv = BaseConv(cin, cin, k, stride, groups=cin)
        self.pconv = BaseConv(cin, cout, 1)

    def forward(self, x):
        return self.pconv(self.dconv(x))


def _conv(cin, cout, k, stride, depthwise) -> nn.Module:
    return DWConv(cin, cout, k, stride) if depthwise \
        else BaseConv(cin, cout, k, stride)


class Bottleneck(nn.Module):
    def __init__(self, c: int, shortcut: bool, depthwise: bool):
        super().__init__()
        self.conv1 = BaseConv(c, c, 1)
        self.conv2 = _conv(c, c, 3, 1, depthwise)
        self.shortcut = shortcut

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return y + x if self.shortcut else y


class CSPLayer(nn.Module):
    def __init__(self, cin: int, cout: int, n: int, shortcut: bool,
                 depthwise: bool):
        super().__init__()
        hidden = int(cout * 0.5)
        self.conv1 = BaseConv(cin, hidden, 1)
        self.conv2 = BaseConv(cin, hidden, 1)
        self.conv3 = BaseConv(2 * hidden, cout, 1)
        self.m = nn.Sequential(*[Bottleneck(hidden, shortcut, depthwise)
                                 for _ in range(n)])

    def forward(self, x):
        return self.conv3(torch.cat([self.m(self.conv1(x)),
                                     self.conv2(x)], 1))


class SPP(nn.Module):
    """Stride-1 max pools 5/9/13 padded by k//2 (F.max_pool2d pads with
    -inf, as gstpu's reduce_window does)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        hidden = cin // 2
        self.conv1 = BaseConv(cin, hidden, 1)
        self.conv2 = BaseConv(hidden * 4, cout, 1)

    def forward(self, x):
        x = self.conv1(x)
        return self.conv2(torch.cat(
            [x] + [F.max_pool2d(x, k, 1, k // 2) for k in (5, 9, 13)], 1))


class Focus(nn.Module):
    """Space-to-depth stem; patch order tl, bl, tr, br (official YOLOX)."""

    def __init__(self, cout: int):
        super().__init__()
        self.conv = BaseConv(12, cout, 3)

    def forward(self, x):
        return self.conv(torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2],
                                    x[..., ::2, 1::2], x[..., 1::2, 1::2]],
                                   1))


class CSPDarknet(nn.Module):
    def __init__(self, c: int, d: int, dw: bool):
        super().__init__()
        self.stem = Focus(c)
        self.dark2 = nn.Sequential(_conv(c, c * 2, 3, 2, dw),
                                   CSPLayer(c * 2, c * 2, d, True, dw))
        self.dark3 = nn.Sequential(_conv(c * 2, c * 4, 3, 2, dw),
                                   CSPLayer(c * 4, c * 4, d * 3, True, dw))
        self.dark4 = nn.Sequential(_conv(c * 4, c * 8, 3, 2, dw),
                                   CSPLayer(c * 8, c * 8, d * 3, True, dw))
        self.dark5 = nn.Sequential(_conv(c * 8, c * 16, 3, 2, dw),
                                   SPP(c * 16, c * 16),
                                   CSPLayer(c * 16, c * 16, d, False, dw))

    def forward(self, x):
        f1 = self.dark3(self.dark2(self.stem(x)))
        f2 = self.dark4(f1)
        return f1, f2, self.dark5(f2)


def _upsample2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class PAFPN(nn.Module):
    def __init__(self, c: int, d: int, dw: bool):
        super().__init__()
        self.backbone = CSPDarknet(c, d, dw)
        self.lateral_conv0 = BaseConv(c * 16, c * 8, 1)
        self.C3_p4 = CSPLayer(c * 16, c * 8, d, False, dw)
        self.reduce_conv1 = BaseConv(c * 8, c * 4, 1)
        self.C3_p3 = CSPLayer(c * 8, c * 4, d, False, dw)
        self.bu_conv2 = _conv(c * 4, c * 4, 3, 2, dw)
        self.C3_n3 = CSPLayer(c * 8, c * 8, d, False, dw)
        self.bu_conv1 = _conv(c * 8, c * 8, 3, 2, dw)
        self.C3_n4 = CSPLayer(c * 16, c * 16, d, False, dw)

    def forward(self, x):
        f1, f2, f3 = self.backbone(x)
        fpn_out0 = self.lateral_conv0(f3)
        f_out0 = self.C3_p4(torch.cat([_upsample2(fpn_out0), f2], 1))
        fpn_out1 = self.reduce_conv1(f_out0)
        pan_out2 = self.C3_p3(torch.cat([_upsample2(fpn_out1), f1], 1))
        pan_out1 = self.C3_n3(torch.cat([self.bu_conv2(pan_out2),
                                         fpn_out1], 1))
        pan_out0 = self.C3_n4(torch.cat([self.bu_conv1(pan_out1),
                                         fpn_out0], 1))
        return pan_out2, pan_out1, pan_out0


class Head(nn.Module):
    """Decoupled head: per level (reg4 | obj1 | cls C) raw logits."""

    def __init__(self, c: int, hc: int, num_classes: int, dw: bool):
        super().__init__()
        chans = (c * 4, c * 8, c * 16)
        self.stems = nn.ModuleList([BaseConv(ci, hc, 1) for ci in chans])
        self.cls_convs = nn.ModuleList(
            [nn.Sequential(_conv(hc, hc, 3, 1, dw), _conv(hc, hc, 3, 1, dw))
             for _ in chans])
        self.reg_convs = nn.ModuleList(
            [nn.Sequential(_conv(hc, hc, 3, 1, dw), _conv(hc, hc, 3, 1, dw))
             for _ in chans])
        self.cls_preds = nn.ModuleList(
            [nn.Conv2d(hc, num_classes, 1) for _ in chans])
        self.reg_preds = nn.ModuleList([nn.Conv2d(hc, 4, 1) for _ in chans])
        self.obj_preds = nn.ModuleList([nn.Conv2d(hc, 1, 1) for _ in chans])

    def forward(self, feats):
        outs = []
        for i, f in enumerate(feats):
            s = self.stems[i](f)
            cls = self.cls_convs[i](s)
            reg = self.reg_convs[i](s)
            y = torch.cat([self.reg_preds[i](reg), self.obj_preds[i](reg),
                           self.cls_preds[i](cls)], 1)
            # NHWC before the rows are flattened: gstpu's row order
            outs.append(y.permute(0, 2, 3, 1).reshape(y.shape[0], -1,
                                                      y.shape[1]))
        return torch.cat(outs, 1)


class YoloX(nn.Module):
    """The YOLOX model of one preset; `forward` takes (N, 3, H, W) f32
    and returns (N, A, 5 + C) raw logits."""

    def __init__(self, num_classes: int = 80, size: str = "tiny"):
        super().__init__()
        depth, width, dw = PRESETS[size]
        c, d = _expand(64, width), _base_depth(depth)
        self.num_classes, self.size = num_classes, size
        self.backbone = PAFPN(c, d, dw)
        self.head = Head(c, _expand(256, width), num_classes, dw)
        self.requires_grad_(False)          # inference only

    def forward(self, x):
        return self.head(self.backbone(x))


def build_model(params: dict, device=None,
                num_classes: int | None = None,
                size: str | None = None) -> YoloX:
    """A YoloX on `device` (the default device if None) from gstpu's
    parameter dict (HWIO, `__meta__` giving the preset) or from a state
    dict in this model's OIHW form (then `num_classes` and `size` name
    the preset), loaded strictly."""
    if "__meta__" in params:
        num_classes, size = params_meta(params)
        state = params_from_gstpu(params)
    else:
        state = params
    model = YoloX(num_classes or 80, size or "tiny")
    model.load_state_dict(state, strict=True)
    return model.to(default_device() if device is None else device).eval()


def forward(model: YoloX, img: torch.Tensor) -> torch.Tensor:
    """img: (H, W, 3) or (N, H, W, 3) f32 on the model's device ->
    (A, 5 + C) or (N, A, 5 + C) raw logits."""
    x = img[None] if img.dim() == 3 else img
    with torch.inference_mode(), tf32_off():
        out = model(x.permute(0, 3, 1, 2).contiguous())
    return out[0] if img.dim() == 3 else out


def yolox_forward(params: dict, img, size: str | None = None) -> torch.Tensor:
    """gstpu's yolox_forward: img (H, W, 3) float32 -> (A, 5 + C) raw
    logits, for gstpu's parameter dict, on img's device (a numpy image
    is uploaded to the default device). `size` overrides the preset in
    `__meta__`."""
    if not isinstance(img, torch.Tensor):
        img = torch.as_tensor(np.asarray(img, np.float32),
                              device=default_device())
    num_classes, psize = params_meta(params)
    return forward(build_model(params_from_gstpu(params), img.device,
                               num_classes, size or psize), img)
