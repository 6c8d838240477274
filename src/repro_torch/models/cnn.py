"""The paper's four experiment networks (paper section 4): LeNet-5 (MNIST)
and AlexNet / VGG16 / ResNet-32 (CIFAR-10), at the paper's full widths.
Port of ``repro.models.cnn``; layer-wise parameter counts match the
paper's Tables A1-A4 exactly:

  lenet5:   conv1 500, conv2 25,000, fc1 400,000, fc2 5,000   (total 430,500)
  alexnet:  grouped convs (groups=2 on conv2/4/5) -> 7,558,176 weights
  vgg16:    13 convs + fc 512->1024->1024->10      -> 16,293,568 weights
  resnet32: 16/32/64 stages, 1x1 projections        ->    464,432 weights

Init / apply pairs on nested dicts of tensors; weights-only counts
(biases excluded from compression, as in the paper).

Layout: every leaf keeps the reference's shape and name (HWIO filters,
(in, out) fc weights), so masks, metrics, pruning, MM and the optimizer
see the same leaves, and ``checkpoint.bridge.params_from_numpy`` carries
weights across unchanged. ``apply`` takes NHWC images, as
``data.synthetic.image_batch`` makes them, goes to NCHW once at the net's
entry and back to NHWC before a flatten, so fc1's rows are in the
reference's (h, w, c) order. ``conv`` takes NCHW activations and an HWIO
filter, which it permutes to OIHW per call. JAX's SAME padding is
asymmetric where the stride does not divide evenly (ResNet-32's stride-2
3x3 convs pad (0, 1)); ``conv`` pads as ``lax.padtype_to_pads`` does.

The convolutions run through ``F.conv2d`` (cuDNN on the card): the JAX
package has no Pallas kernel on this path. ``exact_f32`` turns TF32 off
for cuDNN and for matmul; the CNN entry points (``train.cnn``,
``launch.paper_cnn``) call it, so the f32 nets compute in f32 as the
reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core.tree import flatten_with_path, keystr
from repro_torch.models.layers import truncated_normal_init

Tensor = torch.Tensor


def exact_f32() -> None:
    """TF32 off for cuDNN's convolutions and for matmul (cuDNN allows it
    by default)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def conv_init(kh, kw, cin, cout, groups=1, generator=None, device=None):
    """HWIO filter, He init (the paper uses He et al. 2015)."""
    return truncated_normal_init((kh, kw, cin // groups, cout), 2.0,
                                 generator, device)


def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """(low, high) SAME padding of one spatial axis, as
    ``lax.padtype_to_pads``: the output has ceil(n / s) positions and the
    extra padding goes to the high side."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv(x: Tensor, w: Tensor, stride: int = 1, padding: str = "SAME",
         groups: int = 1) -> Tensor:
    """x NCHW, w HWIO (I = C_in / groups) -> NCHW."""
    kh, kw = w.shape[0], w.shape[1]
    pad = 0
    if padding == "SAME":
        (t, b), (l, r) = (_same_pads(x.shape[2], kh, stride),
                          _same_pads(x.shape[3], kw, stride))
        if (t, l) == (b, r):
            pad = (t, l)
        else:
            x = F.pad(x, (l, r, t, b))
    elif padding != "VALID":
        raise ValueError(f"padding {padding!r}: SAME or VALID")
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride, padding=pad,
                    groups=groups)


def maxpool(x: Tensor, k: int = 2, s: int = 2) -> Tensor:
    """VALID max pooling (``reduce_window`` with a -inf init)."""
    return F.max_pool2d(x, k, s)


def avgpool_global(x: Tensor) -> Tensor:
    """NCHW -> (N, C)."""
    return x.mean(dim=(2, 3))


def _nchw(x: Tensor) -> Tensor:
    return x.permute(0, 3, 1, 2)


def _flatten_hwc(x: Tensor) -> Tensor:
    """NCHW -> (N, H*W*C) in the reference's NHWC order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def _fc(p: dict, x: Tensor) -> Tensor:
    return x @ p["w"] + p["bias"]


def _fc_init(fan_in, fan_out, generator, device) -> dict:
    return {"w": truncated_normal_init((fan_in, fan_out), 2.0, generator,
                                       device),
            "bias": torch.zeros((fan_out,), device=device)}


@dataclasses.dataclass(frozen=True)
class CNNModel:
    name: str
    input_shape: tuple          # (H, W, C)
    n_classes: int
    # (generator=None, device=None) -> f32 params on ``device`` (default
    # cuda); the generator lives on that device
    init: Callable
    apply: Callable             # (params, x NHWC) -> logits (N, n_classes)


# ---------------------------------------------------------------------------
# LeNet-5 (Caffe variant; paper Table A1)
# ---------------------------------------------------------------------------

def _lenet_init(generator=None, device=None):
    g, d = generator, resolve_device(device)
    return {
        "conv1": {"w": conv_init(5, 5, 1, 20, generator=g, device=d)},   # 500
        "conv2": {"w": conv_init(5, 5, 20, 50, generator=g, device=d)},  # 25,000
        "fc1": _fc_init(800, 500, g, d),                                 # 400,000
        "fc2": _fc_init(500, 10, g, d),                                  # 5,000
    }


def _lenet_apply(p, x):
    x = _nchw(x)
    x = maxpool(conv(x, p["conv1"]["w"], padding="VALID"))  # 28->24->12
    x = maxpool(conv(x, p["conv2"]["w"], padding="VALID"))  # 12->8->4
    x = _flatten_hwc(x)                                      # 4*4*50 = 800
    x = F.relu(_fc(p["fc1"], x))
    return _fc(p["fc2"], x)


# ---------------------------------------------------------------------------
# AlexNet-CIFAR (grouped convs; paper Table A2)
# ---------------------------------------------------------------------------

_ALEX = [  # (k, cin, cout, groups, pool)
    (5, 3, 96, 1, True),       # conv1   7,200
    (5, 96, 256, 2, True),     # conv2 307,200
    (3, 256, 384, 1, False),   # conv3 884,736
    (3, 384, 384, 2, False),   # conv4 663,552
    (3, 384, 256, 2, True),    # conv5 442,368
]


def _alex_init(generator=None, device=None):
    device = resolve_device(device)
    p = {f"conv{i + 1}": {"w": conv_init(k, k, cin, cout, g, generator,
                                         device)}
         for i, (k, cin, cout, g, _) in enumerate(_ALEX)}
    p["fc1"] = _fc_init(4096, 1024, generator, device)   # 4,194,304
    p["fc2"] = _fc_init(1024, 1024, generator, device)   # 1,048,576
    p["fc3"] = _fc_init(1024, 10, generator, device)     # 10,240
    return p


def _alex_apply(p, x):
    x = _nchw(x)
    for i, (_, _, _, g, pool) in enumerate(_ALEX):
        x = F.relu(conv(x, p[f"conv{i + 1}"]["w"], groups=g))
        if pool:
            x = maxpool(x)                               # 32->16->8->4
    x = _flatten_hwc(x)                                  # 4*4*256 = 4096
    x = F.relu(_fc(p["fc1"], x))
    x = F.relu(_fc(p["fc2"], x))
    return _fc(p["fc3"], x)


# ---------------------------------------------------------------------------
# VGG16-CIFAR (paper Table A3)
# ---------------------------------------------------------------------------

_VGG = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]


def _vgg_init(generator=None, device=None):
    device = resolve_device(device)
    p = {}
    cin = 3
    for bi, (cout, reps) in enumerate(_VGG):
        for ri in range(reps):
            p[f"conv{bi + 1}-{ri + 1}"] = {"w": conv_init(
                3, 3, cin, cout, generator=generator, device=device)}
            cin = cout
    p["fc1"] = _fc_init(512, 1024, generator, device)    # 524,288
    p["fc2"] = _fc_init(1024, 1024, generator, device)   # 1,048,576
    p["fc3"] = _fc_init(1024, 10, generator, device)
    return p


def _vgg_apply(p, x):
    x = _nchw(x)
    for bi, (_, reps) in enumerate(_VGG):
        for ri in range(reps):
            x = F.relu(conv(x, p[f"conv{bi + 1}-{ri + 1}"]["w"]))
        x = maxpool(x)                                   # 32->16->8->4->2->1
    x = _flatten_hwc(x)                                  # 512
    x = F.relu(_fc(p["fc1"], x))
    x = F.relu(_fc(p["fc2"], x))
    return _fc(p["fc3"], x)


# ---------------------------------------------------------------------------
# ResNet-32 (CIFAR; paper Table A4: 5 blocks per stage, 16/32/64)
# ---------------------------------------------------------------------------

_RES_STAGES, _RES_BLOCKS = (16, 32, 64), 5


def _res_init(generator=None, device=None):
    g, d = generator, resolve_device(device)
    p = {"conv1": {"w": conv_init(3, 3, 3, 16, generator=g, device=d)}}  # 432
    cin = 16
    for si, cout in enumerate(_RES_STAGES):
        for bi in range(_RES_BLOCKS):
            blk = {"c1": {"w": conv_init(3, 3, cin, cout, generator=g,
                                         device=d)},
                   "c2": {"w": conv_init(3, 3, cout, cout, generator=g,
                                         device=d)}}
            if si > 0 and bi == 0:
                blk["proj"] = {"w": conv_init(1, 1, cin, cout, generator=g,
                                              device=d)}
            p[f"conv{si + 1}-{bi + 1}"] = blk
            cin = cout
    p["fc1"] = _fc_init(64, 10, g, d)                                     # 640
    return p


def _res_apply(p, x):
    x = F.relu(conv(_nchw(x), p["conv1"]["w"]))
    for si in range(len(_RES_STAGES)):
        for bi in range(_RES_BLOCKS):
            blk = p[f"conv{si + 1}-{bi + 1}"]
            stride = 2 if (si > 0 and bi == 0) else 1
            h = F.relu(conv(x, blk["c1"]["w"], stride=stride))
            h = conv(h, blk["c2"]["w"])
            if "proj" in blk:
                x = conv(x, blk["proj"]["w"], stride=stride)
            x = F.relu(x + h)
    return _fc(p["fc1"], avgpool_global(x))


CNN_ZOO = {
    "lenet5": CNNModel("lenet5", (28, 28, 1), 10, _lenet_init, _lenet_apply),
    "alexnet-cifar": CNNModel("alexnet-cifar", (32, 32, 3), 10,
                              _alex_init, _alex_apply),
    "vgg16-cifar": CNNModel("vgg16-cifar", (32, 32, 3), 10,
                            _vgg_init, _vgg_apply),
    "resnet32-cifar": CNNModel("resnet32-cifar", (32, 32, 3), 10,
                               _res_init, _res_apply),
}


def weight_count(params) -> int:
    """Weights-only count (the paper excludes biases from its totals)."""
    return sum(leaf.numel() for keys, leaf in flatten_with_path(params)
               if "bias" not in keystr(keys))
