"""Small residual CNN, the paper-faithful CNN subject of Tables 1, 2 and 5
(the port of ``repro.models.convnet``).

A ResNet-20-shaped network (three stages of ``n_blocks`` residual blocks,
widths w, 2w, 4w, global average pool, one linear head) trained on a
synthetic class-template image task: Gaussian class prototypes, blurred,
shifted and noised (``make_synthetic_images``, a numpy copy, bitwise the
reference's).

Parameters stay in the reference's HWIO layout (``[H, W, Cin, Cout]``), so
``interop.params_from_numpy`` carries a reference tree across unchanged,
and OCS on a convolution (paper §3.2) is a row split of the ``[Cin,
H*W*Cout]`` matricization (:func:`conv_w_to_2d`), the same
``split_weights`` the linear layers use. Activations are NHWC at the API,
as in the reference; each convolution runs ``F.conv2d`` on NCHW/OIHW views.

XLA's ``"SAME"`` padding puts the odd pixel of the padding at the bottom
and right: a 3x3 stride-2 convolution of an even size pads (0, 1), where
``F.conv2d(padding=1)`` would pad (1, 1) and shift every output by one
pixel. :func:`_conv` pads explicitly with ``F.pad`` and convolves with
``padding=0``.

The first layer (the stem) is never quantized (paper §5). The activation
quantization sites of the reference's ``_qconv`` come with activation PTQ;
here every convolution but the stem's and the projections tags its input
with ``core.tap`` under the reference's site names.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import tap
from ..core.apply import map_with_path
from ..device import resolve_device

__all__ = [
    "ConvNetConfig",
    "convnet_params_shape",
    "init_convnet",
    "convnet_forward",
    "convnet_loss",
    "make_synthetic_images",
    "conv_w_to_2d",
    "conv_w_from_2d",
]


class ConvNetConfig:
    def __init__(self, n_classes: int = 10, width: int = 16, n_blocks: int = 3,
                 img: int = 16):
        self.n_classes = n_classes
        self.width = width
        self.n_blocks = n_blocks  # residual blocks per stage (3 stages)
        self.img = img

    @property
    def stage_widths(self) -> List[int]:
        return [self.width, 2 * self.width, 4 * self.width]


def _conv_shape(cin: int, cout: int, k: int = 3) -> Tuple[int, ...]:
    return (k, k, cin, cout)  # HWIO


def convnet_params_shape(cfg: ConvNetConfig) -> Dict:
    shapes: Dict = {"stem": {"conv_w": _conv_shape(3, cfg.width)}}
    cin = cfg.width
    for s, w in enumerate(cfg.stage_widths):
        for b in range(cfg.n_blocks):
            blk = {
                "conv1_w": _conv_shape(cin if b == 0 else w, w),
                "conv2_w": _conv_shape(w, w),
            }
            if b == 0 and cin != w:
                blk["proj_w"] = _conv_shape(cin, w, 1)
            shapes[f"s{s}b{b}"] = blk
        cin = w
    shapes["head"] = {"fc_w": (cin, cfg.n_classes)}
    return shapes


def init_convnet(cfg: ConvNetConfig, generator: Optional[torch.Generator] = None, *,
                 seed: int = 0, device=None) -> Dict:
    """He-normal weights, ``N(0, 2 / fan_in)`` (fan_in: every dim but the
    last), drawn from ``generator`` (default: seeded with ``seed`` on the
    device) in the tree's order."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)

    def init_one(_path, shape):
        fan_in = int(np.prod(shape[:-1]))
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        return w * math.sqrt(2.0 / fan_in)

    return map_with_path(init_one, convnet_params_shape(cfg),
                         is_leaf=lambda s: isinstance(s, tuple))


def _same_pad(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: ``(lo, hi)``, the odd
    pixel at the high end."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """``"SAME"`` convolution. x: NCHW; w: HWIO."""
    kh, kw = w.shape[0], w.shape[1]
    top, bottom = _same_pad(x.shape[2], kh, stride)
    left, right = _same_pad(x.shape[3], kw, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)


def _qconv(x: torch.Tensor, w: torch.Tensor, name: str, stride: int = 1) -> torch.Tensor:
    """A quantizable convolution: its input tagged at site ``name`` (NHWC,
    as the reference tags it), then :func:`_conv`."""
    tap.tag(name, x.permute(0, 2, 3, 1))
    return _conv(x, w, stride)


def convnet_forward(params: Dict, x: torch.Tensor, cfg: ConvNetConfig) -> torch.Tensor:
    """x: [B, H, W, 3] -> logits [B, n_classes]."""
    h = F.relu(_conv(x.permute(0, 3, 1, 2), params["stem"]["conv_w"]))
    for s, _w in enumerate(cfg.stage_widths):
        for b in range(cfg.n_blocks):
            p = params[f"s{s}b{b}"]
            stride = 2 if (b == 0 and s > 0) else 1
            y = F.relu(_qconv(h, p["conv1_w"], f"s{s}b{b}_c1", stride))
            y = _qconv(y, p["conv2_w"], f"s{s}b{b}_c2")
            sc = h if "proj_w" not in p else _conv(h, p["proj_w"], stride)
            if sc.shape != y.shape:  # stride-only mismatch (same width)
                sc = sc[:, :, ::stride, ::stride]
            h = F.relu(y + sc)
    h = torch.mean(h, dim=(2, 3))  # global average pool
    tap.tag("fc", h)
    return h @ params["head"]["fc_w"]


def convnet_loss(params, batch, cfg: ConvNetConfig) -> torch.Tensor:
    logits = convnet_forward(params, batch["images"], cfg).to(torch.float32)
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    return torch.mean(logz - gold)


def make_synthetic_images(
    n: int, cfg: ConvNetConfig, seed: int = 0
) -> Dict[str, np.ndarray]:
    """Class-template images: prototype + shift + noise (deterministic)."""
    root = np.random.RandomState(1234)  # fixed prototypes across splits
    protos = root.randn(cfg.n_classes, cfg.img, cfg.img, 3).astype(np.float32)
    # Low-pass the prototypes (3x box blur) so classes are spatial structure,
    # not pixel noise — shift augmentation then actually makes the task convy.
    for _ in range(3):
        protos = (
            protos
            + np.roll(protos, 1, axis=1) + np.roll(protos, -1, axis=1)
            + np.roll(protos, 1, axis=2) + np.roll(protos, -1, axis=2)
        ) / 5.0
    protos *= 3.0 / max(protos.std(), 1e-6)
    rng = np.random.RandomState(seed)
    labels = rng.randint(cfg.n_classes, size=n)
    imgs = protos[labels].copy()
    shifts = rng.randint(-2, 3, size=(n, 2))
    for i in range(n):
        imgs[i] = np.roll(imgs[i], shifts[i], axis=(0, 1))
    imgs += 2.0 * rng.randn(*imgs.shape).astype(np.float32)
    return {"images": imgs.astype(np.float32), "labels": labels.astype(np.int32)}


# ---------------------------------------------------------------------------
# OCS matricization helpers (HWIO conv weight <-> [Cin, H*W*Cout]); numpy
# arrays or torch tensors (on their device), pure data movement.


def conv_w_to_2d(w):
    """HWIO [H, W, Cin, Cout] -> [Cin, H*W*Cout] (input-channel rows)."""
    h, ww, cin, cout = w.shape
    if isinstance(w, torch.Tensor):
        return w.permute(2, 0, 1, 3).reshape(cin, h * ww * cout)
    return np.transpose(w, (2, 0, 1, 3)).reshape(cin, h * ww * cout)


def conv_w_from_2d(w2d, hw_shape: Tuple[int, int], cout: int):
    """[Cin', H*W*Cout] -> HWIO [H, W, Cin', Cout]."""
    h, ww = hw_shape
    cin = w2d.shape[0]
    if isinstance(w2d, torch.Tensor):
        return w2d.reshape(cin, h, ww, cout).permute(1, 2, 0, 3).contiguous()
    return np.transpose(w2d.reshape(cin, h, ww, cout), (1, 2, 0, 3))
