"""ResNet-18 (CIFAR variant) — the port's counterpart of
``torchft_tpu/models/resnet.py``, the conv model family.

Params and running batch-norm stats are two trees of the JAX package's
structure, ``(params, batch_stats)``, float32. Convolutions run NCHW, so a
conv weight is OIHW where the JAX tree's is HWIO: :func:`params_from_jax`
transposes them. The images come in NHWC, as in the JAX package; on the
card the permute to NCHW is a ``channels_last`` view and every
convolution runs in that memory format (the layout cuDNN's tensor-core
convolutions take); on the CPU activations are made contiguous NCHW
(PyTorch's CPU backward of a strided 1x1 convolution in ``channels_last``
aborts).

Batch norm is computed as JAX computes it: the batch's mean and biased
variance in float32 on the compute-dtype activations, and running stats
``momentum * running + (1 - momentum) * batch`` (``F.batch_norm`` would
update the running variance with the unbiased variance, under the
opposite momentum convention). ``"SAME"`` padding follows
``lax.padtype_to_pads``: a stride-2 3x3 conv on an even input pads one
pixel at the high end only. The global average pool and the classifier
run in float32.

CIFAR stem: 3x3 conv stride 1, no max-pool; stages [2,2,2,2] x channels
[64,128,256,512].
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from torchft_tpu_torch.utils.platform import resolve_device
from torchft_tpu_torch.utils.tree import tree_map

__all__ = ["ResNetConfig", "init", "params_from_jax", "apply", "loss_fn"]


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 10
    channels: Tuple[int, ...] = (64, 128, 256, 512)
    blocks_per_stage: Tuple[int, ...] = (2, 2, 2, 2)  # resnet-18
    bn_momentum: float = 0.9  # running = m*running + (1-m)*batch
    bn_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16  # compute dtype; stats/params stay f32


def init(
    generator: torch.Generator, cfg: ResNetConfig = ResNetConfig(), device: str = "cuda"
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Random ``(params, batch_stats)`` with the JAX trees' structure (conv
    weights OIHW) and its scaling: He normal (fan_out) convs, the residual's
    last BN scale at zero, a normal * fan_in^-0.5 classifier. The numbers
    differ from ``jax.random``'s; use :func:`params_from_jax` to match the
    JAX package."""
    dev = resolve_device(device)

    def conv(kh, kw, cin, cout):
        std = (2.0 / (kh * kw * cout)) ** 0.5
        return (torch.randn(cout, cin, kh, kw, generator=generator) * std).to(dev)

    def bn(c, scale=1.0):
        return {"scale": torch.full((c,), scale, device=dev),
                "bias": torch.zeros(c, device=dev)}

    def bn_state(c):
        return {"mean": torch.zeros(c, device=dev), "var": torch.ones(c, device=dev)}

    c0 = cfg.channels[0]
    params: Dict[str, Any] = {"stem": {"conv": conv(3, 3, 3, c0), "bn": bn(c0)}}
    stats: Dict[str, Any] = {"stem": {"bn": bn_state(c0)}}
    cin = c0
    for s, (cout, n_blocks) in enumerate(zip(cfg.channels, cfg.blocks_per_stage)):
        blocks, blocks_stats = [], []
        for b in range(n_blocks):
            stride = 2 if (s > 0 and b == 0) else 1
            blk = {"conv1": conv(3, 3, cin, cout), "bn1": bn(cout),
                   "conv2": conv(3, 3, cout, cout), "bn2": bn(cout, scale=0.0)}
            st = {"bn1": bn_state(cout), "bn2": bn_state(cout)}
            if stride != 1 or cin != cout:
                blk["down_conv"] = conv(1, 1, cin, cout)
                blk["down_bn"] = bn(cout)
                st["down_bn"] = bn_state(cout)
            blocks.append(blk)
            blocks_stats.append(st)
            cin = cout
        params[f"stage{s}"] = blocks
        stats[f"stage{s}"] = blocks_stats
    c = cfg.channels[-1]
    params["fc"] = {
        "w": (torch.randn(c, cfg.num_classes, generator=generator) * c**-0.5).to(dev),
        "b": torch.zeros(cfg.num_classes, device=dev),
    }
    return params, stats


def params_from_jax(
    params: Dict[str, Any], stats: Dict[str, Any], device: str = "cuda"
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The JAX package's ``(params, batch_stats)`` (trees with numpy
    leaves) as the port's: the same trees of float32 tensors on ``device``,
    each conv weight transposed from HWIO to OIHW."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.array(a, dtype=np.float32)
        if a.ndim == 4:
            a = np.ascontiguousarray(a.transpose(3, 2, 0, 1))
        return torch.from_numpy(a).to(dev)

    return tree_map(leaf, params), tree_map(leaf, stats)


def _memory_format(x: torch.Tensor) -> torch.memory_format:
    return torch.channels_last if x.is_cuda else torch.contiguous_format


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """``lax.conv_general_dilated(..., "SAME")`` in NCHW: the padding of
    each spatial dim is split as ``lax.padtype_to_pads`` splits it, the
    odd pixel at the high end."""
    kh, kw = w.shape[2:]
    pads = []
    for size, k in ((x.shape[2], kh), (x.shape[3], kw)):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads.append((total // 2, total - total // 2))
    (top, bottom), (left, right) = pads
    w = w.to(dtype=x.dtype, memory_format=_memory_format(x))
    if top == bottom and left == right:
        return F.conv2d(x, w, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)


def _batch_norm(x, p, st, cfg: ResNetConfig, train: bool):
    """Returns (normalized x, new state); stats in float32 whatever the
    activations' dtype."""
    xf = x.float()
    if train:
        mean = xf.mean(dim=(0, 2, 3))
        var = (xf - mean[:, None, None]).square().mean(dim=(0, 2, 3))
        m = cfg.bn_momentum
        with torch.no_grad():
            new_st = {"mean": m * st["mean"] + (1.0 - m) * mean,
                      "var": m * st["var"] + (1.0 - m) * var}
    else:
        mean, var = st["mean"], st["var"]
        new_st = st
    inv = torch.rsqrt(var + cfg.bn_eps) * p["scale"]
    out = (xf - mean[:, None, None]) * inv[:, None, None] + p["bias"][:, None, None]
    return out.to(x.dtype), new_st


def _block(x, blk, st, cfg: ResNetConfig, stride: int, train: bool):
    new_st = dict(st)
    y = _conv(x, blk["conv1"], stride)
    y, new_st["bn1"] = _batch_norm(y, blk["bn1"], st["bn1"], cfg, train)
    y = F.relu(y)
    y = _conv(y, blk["conv2"], 1)
    y, new_st["bn2"] = _batch_norm(y, blk["bn2"], st["bn2"], cfg, train)
    if "down_conv" in blk:
        x = _conv(x, blk["down_conv"], stride)
        x, new_st["down_bn"] = _batch_norm(x, blk["down_bn"], st["down_bn"], cfg, train)
    return F.relu(y + x), new_st


def apply(
    params: Dict[str, Any],
    stats: Dict[str, Any],
    images: torch.Tensor,
    cfg: ResNetConfig = ResNetConfig(),
    train: bool = True,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """``images`` [B, 32, 32, 3] (NHWC, any float dtype) -> (logits float32,
    new batch_stats). Pass ``train=False`` to use the running stats."""
    x = images.to(cfg.dtype).permute(0, 3, 1, 2)  # NCHW view of channels_last memory
    x = x.contiguous(memory_format=_memory_format(x))
    new_stats: Dict[str, Any] = {"stem": {}}
    x = _conv(x, params["stem"]["conv"], 1)
    x, new_stats["stem"]["bn"] = _batch_norm(
        x, params["stem"]["bn"], stats["stem"]["bn"], cfg, train
    )
    x = F.relu(x)
    for s in range(len(cfg.channels)):
        new_blocks = []
        for b, blk in enumerate(params[f"stage{s}"]):
            stride = 2 if (s > 0 and b == 0) else 1
            x, st = _block(x, blk, stats[f"stage{s}"][b], cfg, stride, train)
            new_blocks.append(st)
        new_stats[f"stage{s}"] = new_blocks
    x = x.float().mean(dim=(2, 3))  # global average pool
    logits = x @ params["fc"]["w"] + params["fc"]["b"]
    return logits, new_stats


def loss_fn(
    params: Dict[str, Any],
    stats: Dict[str, Any],
    images: torch.Tensor,
    labels: torch.Tensor,
    cfg: ResNetConfig = ResNetConfig(),
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Mean cross-entropy; returns ``(loss, new_batch_stats)``."""
    logits, new_stats = apply(params, stats, images, cfg, train=True)
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    return nll.mean(), new_stats
