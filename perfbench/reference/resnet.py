"""Plain ResNet v1.5 with bottleneck blocks, in float32 PyTorch functions.

He et al. 2015 ("Deep Residual Learning", arXiv:1512.03385), v1.5 as in
torchvision's ``resnet50`` and NVIDIA's DeepLearningExamples: the stride of
a stage's first block on its 3×3 convolution.  It follows what the
configuration states and what the program it judges does where that
departs from torchvision (each listed in the configuration's
``departures``):

* a strided 3×3 pads "SAME" as TensorFlow and flax do (nothing before,
  one row and column after an even input), where torchvision pads one on
  each side;
* BatchNorm in training normalises by the batch's biased variance and
  moves its running statistics as ``running = 0.9 · running + 0.1 ·
  batch``, with the biased variance (torch moves ``running_var`` by the
  unbiased one).

The parameters are a dict under the program's state-dict names;
:func:`torchvision_name` maps each to torchvision's.  Each block is
recomputed in the backward (``torch.utils.checkpoint``) so that batch 384
fits in float32; BatchNorm's statistics are outputs of the block, and the
caller moves the running ones once a step.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

EPS = 1e-5
MOMENTUM = 0.9


def blocks(config: Dict) -> List[Tuple[str, int, int, int]]:
    """``(name, c_in, filters, stride)`` of every bottleneck block."""
    out, c_in = [], config["num_filters"]
    for i, n in enumerate(config["stage_sizes"]):
        f = config["num_filters"] * 2 ** i
        for j in range(n):
            out.append((f"BottleneckBlock_{len(out)}", c_in, f,
                        2 if i > 0 and j == 0 else 1))
            c_in = 4 * f
    return out


def _has_proj(c_in, f, stride):
    return stride != 1 or c_in != 4 * f


def layout(config: Dict) -> Dict[str, Tuple[str, tuple]]:
    """Every tensor: name -> (kind, shape); kinds ``conv``, ``bn_w``,
    ``bn_b``, ``mean``, ``var``, ``fc_w``, ``fc_b``."""
    out = {}

    def bn(name, c):
        out.update({f"{name}.weight": ("bn_w", (c,)),
                    f"{name}.bias": ("bn_b", (c,)),
                    f"{name}.running_mean": ("mean", (c,)),
                    f"{name}.running_var": ("var", (c,))})

    f0 = config["num_filters"]
    out["conv_init.weight"] = ("conv", (f0, 3, 7, 7))
    bn("bn_init", f0)
    for name, c_in, f, s in blocks(config):
        out[f"{name}.Conv_0.weight"] = ("conv", (f, c_in, 1, 1))
        bn(f"{name}.BatchNorm_0", f)
        out[f"{name}.Conv_1.weight"] = ("conv", (f, f, 3, 3))
        bn(f"{name}.BatchNorm_1", f)
        out[f"{name}.Conv_2.weight"] = ("conv", (4 * f, f, 1, 1))
        bn(f"{name}.BatchNorm_2", 4 * f)
        if _has_proj(c_in, f, s):
            out[f"{name}.conv_proj.weight"] = ("conv", (4 * f, c_in, 1, 1))
            bn(f"{name}.norm_proj", 4 * f)
    width = 4 * f0 * 2 ** (len(config["stage_sizes"]) - 1)
    out["head.weight"] = ("fc_w", (config["num_classes"], width))
    out["head.bias"] = ("fc_b", (config["num_classes"],))
    return out


def torchvision_name(name: str, config: Dict) -> str:
    """The program's state-dict name -> torchvision ``resnet50``'s."""
    top = {"conv_init": "conv1", "bn_init": "bn1", "head": "fc"}
    head, _, rest = name.partition(".")
    if head in top:
        return f"{top[head]}.{rest}"
    k = int(head.split("_")[1])
    for i, n in enumerate(config["stage_sizes"]):
        if k < n:
            break
        k -= n
    sub, _, leaf = rest.partition(".")
    part = {"Conv_0": "conv1", "BatchNorm_0": "bn1", "Conv_1": "conv2",
            "BatchNorm_1": "bn2", "Conv_2": "conv3", "BatchNorm_2": "bn3",
            "conv_proj": "downsample.0", "norm_proj": "downsample.1"}[sub]
    return f"layer{i + 1}.{k}.{part}.{leaf}"


def _same(n: int, k: int, s: int) -> Tuple[int, int]:
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride, prec, pads=None):
    k = w.shape[-1]
    if pads is None:
        (t, b), (l, r) = _same(x.shape[2], k, stride), _same(x.shape[3], k,
                                                               stride)
    else:
        t = b = l = r = pads
    x = F.pad(prec.operand(x), (l, r, t, b)) if t or b or l or r \
        else prec.operand(x)
    return prec.result(F.conv2d(x, prec.operand(w), stride=stride))


def _bn(x, w, b, prec):
    mean = x.mean((0, 2, 3))
    var = (x - mean[None, :, None, None]).square().mean((0, 2, 3))
    y = (x - mean[None, :, None, None]) * torch.rsqrt(
        var + EPS)[None, :, None, None]
    return (prec.act(y * w[None, :, None, None] + b[None, :, None, None]),
            mean.detach(), var.detach())


def _block(prec, stride, proj, x, *t):
    c0, g0, b0, c1, g1, b1, c2, g2, b2 = t[:9]
    y, m0, v0 = _bn(_conv(x, c0, 1, prec), g0, b0, prec)
    y, m1, v1 = _bn(_conv(torch.relu(y), c1, stride, prec), g1, b1, prec)
    y, m2, v2 = _bn(_conv(torch.relu(y), c2, 1, prec), g2, b2, prec)
    stats = [m0, v0, m1, v1, m2, v2]
    if proj:
        r, mp, vp = _bn(_conv(x, t[9], stride, prec), t[10], t[11], prec)
        stats += [mp, vp]
    else:
        r = x
    return (torch.relu(prec.act(r + y)), *stats)


def forward(p: Dict[str, torch.Tensor], images: torch.Tensor, config: Dict,
            prec, recompute: bool = True):
    """``(logits, batch statistics)``: f32 logits of ``images``
    ``(B, 3, H, W)`` in training mode, and each BatchNorm's ``(mean,
    biased var)`` under its name."""
    stats = {}
    x = _conv(images.float(), p["conv_init.weight"], 2, prec, pads=3)
    x, stats["bn_init.m"], stats["bn_init.v"] = _bn(
        x, p["bn_init.weight"], p["bn_init.bias"], prec)
    x = F.max_pool2d(torch.relu(x), 3, 2, 1)
    for name, c_in, f, s in blocks(config):
        proj = _has_proj(c_in, f, s)
        subs = ["Conv_0", "BatchNorm_0", "Conv_1", "BatchNorm_1", "Conv_2",
                "BatchNorm_2"] + (["conv_proj", "norm_proj"] if proj else [])
        ts = []
        for sub in subs:
            if sub.startswith(("Conv", "conv")):
                ts.append(p[f"{name}.{sub}.weight"])
            else:
                ts += [p[f"{name}.{sub}.weight"], p[f"{name}.{sub}.bias"]]
        if recompute:
            out = checkpoint(_block, prec, s, proj, x, *ts,
                             use_reentrant=False)
        else:
            out = _block(prec, s, proj, x, *ts)
        x = out[0]
        norms = [n for n in subs if not n.startswith(("Conv", "conv"))]
        for k, n in enumerate(norms):
            stats[f"{name}.{n}.m"], stats[f"{name}.{n}.v"] = out[1 + 2 * k:
                                                                 3 + 2 * k]
    h = prec.act(x.mean((2, 3)))
    logits = prec.result(prec.operand(h) @ prec.operand(
        p["head.weight"]).t()) + p["head.bias"]
    return logits, stats


@torch.no_grad()
def move_running(buffers: Dict[str, torch.Tensor], stats: Dict) -> None:
    """``running = 0.9 · running + 0.1 · batch`` for every BatchNorm."""
    for key, t in stats.items():
        name, kind = key.rsplit(".", 1)
        buf = buffers[f"{name}.running_{'mean' if kind == 'm' else 'var'}"]
        buf.mul_(MOMENTUM).add_(t, alpha=1 - MOMENTUM)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over rows of ``logsumexp(row) − row[label]``."""
    gold = logits.gather(1, labels[:, None].long())[:, 0]
    return (torch.logsumexp(logits, dim=1) - gold).mean()
