"""Host-side result structures (detectron2.structures counterpart).

Counterpart of ``tair_tpu/utils/structures.py``, numpy as there (the port
keeps its own copy): ``Instances``, the thin per-image container for
evaluation and visualisation code that wants the ragged view of the dense,
keep-masked spotter output, and the box-format conversions of detectron2's
``BoxMode``. `instances_from_spotter` takes ``spotter_inference``'s dict,
whose tensors it brings to the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np


@dataclass
class Instances:
    """Per-image prediction container: named fields with equal first dim."""

    image_size: Tuple[int, int]
    fields: Dict[str, np.ndarray] = field(default_factory=dict)

    def __len__(self) -> int:
        for v in self.fields.values():
            return len(v)
        return 0

    def __getattr__(self, name: str):
        try:
            return self.__dict__["fields"][name]
        except KeyError:
            raise AttributeError(name)

    def set(self, name: str, value) -> None:
        value = np.asarray(value)
        if self.fields:
            assert len(value) == len(self), f"length mismatch for {name}"
        self.fields[name] = value

    def __getitem__(self, sel) -> "Instances":
        return Instances(
            self.image_size, {k: v[sel] for k, v in self.fields.items()}
        )


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def instances_from_spotter(result: Dict[str, np.ndarray], image_size: int,
                           batch_index: int = 0) -> Instances:
    """Dense spotter_inference output (tensors or arrays) -> ragged Instances
    (keep-masked)."""
    keep = _host(result["keep"][batch_index])
    inst = Instances((image_size, image_size))
    for name in ("scores", "polygons", "recs", "rec_scores"):
        inst.set(name, _host(result[name][batch_index])[keep])
    return inst


# ---- BoxMode conversions (detectron2.structures.BoxMode counterpart) ----

def xyxy_to_xywh(b: np.ndarray) -> np.ndarray:
    b = np.asarray(b, np.float32)
    return np.stack(
        [b[..., 0], b[..., 1], b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]], -1
    )


def xywh_to_xyxy(b: np.ndarray) -> np.ndarray:
    b = np.asarray(b, np.float32)
    return np.stack(
        [b[..., 0], b[..., 1], b[..., 0] + b[..., 2], b[..., 1] + b[..., 3]], -1
    )


def xyxy_to_cxcywh(b: np.ndarray) -> np.ndarray:
    b = np.asarray(b, np.float32)
    return np.stack(
        [
            (b[..., 0] + b[..., 2]) / 2,
            (b[..., 1] + b[..., 3]) / 2,
            b[..., 2] - b[..., 0],
            b[..., 3] - b[..., 1],
        ],
        -1,
    )


def cxcywh_to_xyxy(b: np.ndarray) -> np.ndarray:
    b = np.asarray(b, np.float32)
    return np.stack(
        [
            b[..., 0] - b[..., 2] / 2,
            b[..., 1] - b[..., 3] / 2,
            b[..., 0] + b[..., 2] / 2,
            b[..., 1] + b[..., 3] / 2,
        ],
        -1,
    )
