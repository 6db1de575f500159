"""RetinaFace-ResNet50 face and landmark detector (inference).

Counterpart of ``tair_tpu/utils/retinaface.py``: the network of
biubug6/Pytorch_Retinaface that facexlib ships (torchvision's ResNet-50 through
layer4, taps C3/C4/C5, a three-level FPN, SSH context modules, class / box /
landmark heads over two anchors a cell), decoded against SSD priors (variances
0.1 and 0.2) and filtered by confidence and NMS on the host.

The network runs NCHW inside, float32 with autocast and TF32 off. What the JAX
module does, done here too:

- the max pool pads with -inf;
- the FPN's upsample is ``jax.image.resize(..., "nearest")``: source index
  ``floor((i + 0.5) * in / out)`` in float32 (torch's ``"nearest"`` takes
  ``floor(i * in / out)``); it matters off multiples of 32;
- each head is flattened from NHWC ``[B, h, w, anchors * k]``, so the anchors
  come cell-major, then by anchor, in the order of the priors.

``RetinaFaceDetector.detect`` pads to the coarsest stride, flips to BGR and
subtracts ``BGR_MEAN`` on the detector's device, runs the network there, copies
its three outputs to the host once, and decodes and suppresses in numpy. The
weights are facexlib's ``detection_Resnet50_Final.pth``
(``RetinaFaceDetector.from_torch``); they are not in the repo.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Any, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .clipiqa import BNInfer
from .iqa import load_module, resolve_device, scoring

# facexlib's preprocessing: BGR, 0-255, mean-subtracted
BGR_MEAN = (104.0, 117.0, 123.0)


def _conv(cin: int, cout: int, k: int, stride: int = 1, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=bias)


class TorchBottleneck(nn.Module):
    """torchvision's Bottleneck: the stride on conv2, a strided 1 x 1
    convolution as the downsample."""

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, planes, 1), BNInfer(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3, stride), BNInfer(planes)
        self.conv3, self.bn3 = _conv(planes, planes * 4, 1), BNInfer(planes * 4)
        self.down = stride != 1 or cin != planes * 4
        if self.down:
            self.down_conv = nn.Conv2d(cin, planes * 4, 1, stride, bias=False)
            self.down_bn = BNInfer(planes * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = self.down_bn(self.down_conv(x)) if self.down else x
        return F.relu(out + identity)


class ResNet50Backbone(nn.Module):
    """torchvision's ResNet-50 through layer4: (C3, C4, C5)."""

    def __init__(self, layers: Tuple[int, ...] = (3, 4, 6, 3)):
        super().__init__()
        self.layers = layers
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BNInfer(64)
        cin = 64
        for stage, n_blocks in enumerate(layers):
            planes = 64 * 2 ** stage
            for blk in range(n_blocks):
                stride = 2 if stage > 0 and blk == 0 else 1
                setattr(self, f"layer{stage + 1}_{blk}", TorchBottleneck(cin, planes, stride))
                cin = planes * 4

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)  # pads with -inf
        taps = []
        for stage, n_blocks in enumerate(self.layers):
            for blk in range(n_blocks):
                x = getattr(self, f"layer{stage + 1}_{blk}")(x)
            if stage >= 1:
                taps.append(x)
        return tuple(taps)  # C3 (512), C4 (1024), C5 (2048)


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, relu: bool = True):
        super().__init__()
        self.relu = relu
        self.conv = _conv(cin, cout, kernel, stride)
        self.bn = BNInfer(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        # facexlib's LeakyReLU(0) for out_channels > 64: a plain relu
        return F.relu(x) if self.relu else x


class SSH(nn.Module):
    """SSH context module: a 3 x 3 and stacked 3 x 3s (5 x 5 and 7 x 7 fields)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        f = features
        self.conv3x3 = ConvBN(cin, f // 2, relu=False)
        self.conv5x5_1 = ConvBN(cin, f // 4)
        self.conv5x5_2 = ConvBN(f // 4, f // 4, relu=False)
        self.conv7x7_2 = ConvBN(f // 4, f // 4)
        self.conv7x7_3 = ConvBN(f // 4, f // 4, relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c5_1 = self.conv5x5_1(x)
        c7_1 = self.conv7x7_2(c5_1)
        return F.relu(torch.cat(
            [self.conv3x3(x), self.conv5x5_2(c5_1), self.conv7x7_3(c7_1)], dim=1))


@dataclass(frozen=True)
class RetinaFaceConfig:
    out_channels: int = 256
    num_anchors: int = 2
    min_sizes: Tuple[Tuple[int, ...], ...] = ((16, 32), (64, 128), (256, 512))
    steps: Tuple[int, ...] = (8, 16, 32)
    variances: Tuple[float, float] = (0.1, 0.2)


@lru_cache(maxsize=64)
def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """``jax.image.resize(..., "nearest")``'s source index of each output."""
    f32 = np.float32
    return np.floor((np.arange(n_out, dtype=f32) + f32(0.5)) * f32(n_in) / f32(n_out)).astype(
        np.int64)


def upsample_nearest(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """NCHW `x` resized to `hw` by ``jax.image.resize``'s nearest rule."""
    for dim, n_out in ((2, hw[0]), (3, hw[1])):
        n_in = x.shape[dim]
        if n_in != n_out:
            index = torch.from_numpy(_nearest_index(n_in, n_out))
            x = x.index_select(dim, index.to(x.device, non_blocking=True))
    return x


class RetinaFace(nn.Module):
    def __init__(self, cfg: RetinaFaceConfig = RetinaFaceConfig(),
                 layers: Tuple[int, ...] = (3, 4, 6, 3)):
        super().__init__()
        self.cfg = cfg
        f = cfg.out_channels
        self.body = ResNet50Backbone(layers)
        self.fpn_output1 = ConvBN(512, f, kernel=1)
        self.fpn_output2 = ConvBN(1024, f, kernel=1)
        self.fpn_output3 = ConvBN(2048, f, kernel=1)
        self.fpn_merge1 = ConvBN(f, f)
        self.fpn_merge2 = ConvBN(f, f)
        na = cfg.num_anchors
        for i in range(3):
            setattr(self, f"ssh{i + 1}", SSH(f, f))
            setattr(self, f"class_head{i}", _conv(f, na * 2, 1, bias=True))
            setattr(self, f"bbox_head{i}", _conv(f, na * 4, 1, bias=True))
            setattr(self, f"ldm_head{i}", _conv(f, na * 10, 1, bias=True))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x ``[B, 3, H, W]`` BGR, mean-subtracted -> (scores ``[B, N, 2]``
        softmaxed, boxes ``[B, N, 4]``, landmarks ``[B, N, 10]``) over all anchors."""
        c3, c4, c5 = self.body(x)
        o3 = self.fpn_output3(c5)
        o2 = self.fpn_output2(c4)
        o2 = self.fpn_merge2(o2 + upsample_nearest(o3, o2.shape[2:]))
        o1 = self.fpn_output1(c3)
        o1 = self.fpn_merge1(o1 + upsample_nearest(o2, o1.shape[2:]))
        cls, box, ldm = [], [], []
        for i, o in enumerate((o1, o2, o3)):
            feat = getattr(self, f"ssh{i + 1}")(o)
            b = feat.shape[0]
            for outs, head, k in ((cls, "class_head", 2), (box, "bbox_head", 4),
                                  (ldm, "ldm_head", 10)):
                y = getattr(self, f"{head}{i}")(feat).permute(0, 2, 3, 1)  # NHWC, as JAX
                outs.append(y.reshape(b, -1, k))
        scores = torch.softmax(torch.cat(cls, dim=1), dim=-1)
        return scores, torch.cat(box, dim=1), torch.cat(ldm, dim=1)


# --------------------------------------------------------------------------
# priors / decode / NMS: host numpy, biubug6's prior_box and decode
# --------------------------------------------------------------------------


@lru_cache(maxsize=16)
def _priors_cached(height: int, width: int, cfg: RetinaFaceConfig) -> np.ndarray:
    out = []
    for k, step in enumerate(cfg.steps):
        fh = int(np.ceil(height / step))
        fw = int(np.ceil(width / step))
        ii, jj = np.meshgrid(np.arange(fh), np.arange(fw), indexing="ij")
        for ms in cfg.min_sizes[k]:
            grid = np.stack(
                [
                    (jj + 0.5) * step / width, (ii + 0.5) * step / height,
                    np.full_like(jj, ms / width, np.float64),
                    np.full_like(ii, ms / height, np.float64),
                ],
                axis=-1,
            ).reshape(-1, 4)
            out.append(grid)
        # the min sizes interleaved per cell: cell-major, then anchor
        per_cell = np.stack(out[-len(cfg.min_sizes[k]):], axis=1)
        out = out[: -len(cfg.min_sizes[k])] + [per_cell.reshape(-1, 4)]
    return np.concatenate(out, axis=0).astype(np.float32)


def priors_for(height: int, width: int, cfg: RetinaFaceConfig) -> np.ndarray:
    """SSD priors ``[N, 4]`` (cx, cy, w, h) in [0, 1], cached per (H, W)."""
    return _priors_cached(height, width, cfg)


def decode_boxes(deltas: np.ndarray, priors: np.ndarray, variances) -> np.ndarray:
    """``[N, 4]`` SSD decode -> ``[N, 4]`` (x0, y0, x1, y1) in [0, 1]."""
    cxy = priors[:, :2] + deltas[:, :2] * variances[0] * priors[:, 2:]
    wh = priors[:, 2:] * np.exp(deltas[:, 2:] * variances[1])
    return np.concatenate([cxy - wh / 2, cxy + wh / 2], axis=1)


def decode_landmarks(deltas: np.ndarray, priors: np.ndarray, variances) -> np.ndarray:
    """``[N, 10]`` -> ``[N, 10]`` in [0, 1] (5 x/y pairs)."""
    out = [
        priors[:, :2] + deltas[:, 2 * i : 2 * i + 2] * variances[0] * priors[:, 2:]
        for i in range(5)
    ]
    return np.concatenate(out, axis=1)


def nms(boxes: np.ndarray, scores: np.ndarray, thresh: float) -> List[int]:
    """Plain IoU NMS (py_cpu_nms's rule)."""
    x0, y0, x1, y1 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = (x1 - x0) * (y1 - y0)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx0 = np.maximum(x0[i], x0[order[1:]])
        yy0 = np.maximum(y0[i], y0[order[1:]])
        xx1 = np.minimum(x1[i], x1[order[1:]])
        yy1 = np.minimum(y1[i], y1[order[1:]])
        inter = np.maximum(xx1 - xx0, 0) * np.maximum(yy1 - yy0, 0)
        iou = inter / np.maximum(areas[i] + areas[order[1:]] - inter, 1e-12)
        order = order[1:][iou <= thresh]
    return keep


class RetinaFaceDetector:
    """``detect(img [H, W, 3] RGB float in [0, 1])`` -> ``[K, 15]`` rows (x0, y0,
    x1, y1, score, 5 landmark x/y pairs) in pixels: facexlib's ``detect_faces``
    contract. The network runs on `device` (``cuda`` unless the caller asks
    for the CPU); the image may be a numpy array or a tensor."""

    def __init__(self, params: Mapping[str, Any], cfg: RetinaFaceConfig = RetinaFaceConfig(),
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.net = load_module(lambda: RetinaFace(cfg), params, self.device)

    def forward(self, img) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The network's (scores, boxes, landmarks) on the detector's device for
        one image, padded to the coarsest stride and preprocessed as facexlib does."""
        x = torch.as_tensor(img).to(device=self.device, dtype=torch.float32)
        h, w, _ = x.shape
        step = self.cfg.steps[-1]
        mean = torch.tensor(BGR_MEAN, dtype=torch.float32).to(self.device, non_blocking=True)
        x = x.flip(-1) * 255.0 - mean
        x = F.pad(x.permute(2, 0, 1), (0, (-w) % step, 0, (-h) % step))[None]
        with scoring(self.device):
            return self.net(x)

    def detect(self, img, conf_threshold: float = 0.8,
               nms_threshold: float = 0.4) -> np.ndarray:
        h, w = img.shape[:2]
        step = self.cfg.steps[-1]
        ph, pw = (-h) % step, (-w) % step
        scores, boxes, ldms = (t.cpu().numpy() for t in self.forward(img))
        conf = scores[0, :, 1]
        priors = priors_for(h + ph, w + pw, self.cfg)
        keep = conf > conf_threshold
        if not keep.any():
            return np.zeros((0, 15), np.float32)
        scale = np.asarray([w + pw, h + ph], np.float32)
        bxs = decode_boxes(boxes[0, keep], priors[keep], self.cfg.variances)
        bxs = bxs * np.tile(scale, 2)
        lms = decode_landmarks(ldms[0, keep], priors[keep], self.cfg.variances)
        lms = lms * np.tile(scale, 5)
        cf = conf[keep]
        kept = nms(bxs, cf, nms_threshold)
        return np.concatenate([bxs[kept], cf[kept, None], lms[kept]], axis=1).astype(np.float32)

    def as_landmark_detector(self, conf_threshold: float = 0.8):
        """``FaceRestoreHelper.detector``: img -> a list of ``[5, 2]`` landmarks."""

        def fn(img) -> List[np.ndarray]:
            rows = self.detect(img, conf_threshold)
            return [r[5:15].reshape(5, 2) for r in rows]

        return fn

    @classmethod
    def from_torch(cls, path: str, **kw) -> "RetinaFaceDetector":
        """facexlib's ``detection_Resnet50_Final.pth`` (``module.`` or not)."""
        from ..weights.convert import _strip_module, load_torch_file

        return cls.from_state_dict(_strip_module(load_torch_file(path)), **kw)

    @classmethod
    def from_state_dict(cls, sd: Mapping[str, Any], **kw) -> "RetinaFaceDetector":
        from ..weights.convert import _to_numpy, convert_retinaface

        return cls(convert_retinaface({k: _to_numpy(v) for k, v in sd.items()}), **kw)
