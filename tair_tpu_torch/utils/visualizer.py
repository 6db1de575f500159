"""Text-spotting visualization (polygons + transcriptions) and text panels.

The port's copy of ``tair_tpu/utils/visualizer.py``: ``TextVisualizer``
draws the spotter's polygons with their transcriptions and scores (the
``pred_texts_{stem}.png`` overlay the ``val`` entry point writes), and
``text_panel`` lists strings on a white canvas. PIL-based, imported where it
draws; host-side; inputs are numpy images in [0,1].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

_PALETTE = [
    (31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
    (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
    (188, 189, 34), (23, 190, 207),
]


def _to_pil(image: np.ndarray):
    from PIL import Image

    arr = (np.clip(np.asarray(image), 0.0, 1.0) * 255).astype(np.uint8)
    return Image.fromarray(arr)


def text_panel(
    texts: Sequence[str], size=(512, 512), font_size: int = 16
) -> np.ndarray:
    """Render lines of text on a white canvas (log_txt_as_img semantics:
    one panel listing the strings, wrapped to the panel width)."""
    from PIL import ImageDraw

    panel = _to_pil(np.ones(size + (3,), np.float32))
    drw = ImageDraw.Draw(panel)
    # ~2 chars per font_size px; crude wrap like the reference's nc=int(40*(wh[0]/256))
    per_line = max(1, int(size[1] / (font_size * 0.6)))
    y = 4
    for t in texts:
        for start in range(0, max(len(t), 1), per_line):
            drw.text((4, y), t[start : start + per_line], fill=(0, 0, 0))
            y += font_size
        if y > size[0] - font_size:
            break
    return np.asarray(panel, np.float32) / 255.0


@dataclass
class TextVisualizer:
    """Draw spotter predictions on an image.

    draw_instances(image, polys [N,P,2] (pixel coords), texts, scores) ->
    [H,W,3] float image with closed polygon outlines (cycled palette),
    filled score-tinted vertices, and transcription labels on a
    contrasting background box.
    """

    line_width: int = 2
    with_labels: bool = True

    def draw_instances(
        self,
        image: np.ndarray,
        polys: np.ndarray,
        texts: Optional[Sequence[str]] = None,
        scores: Optional[Sequence[float]] = None,
    ) -> np.ndarray:
        from PIL import ImageDraw

        img = _to_pil(image)
        drw = ImageDraw.Draw(img, "RGBA")
        for i, poly in enumerate(np.asarray(polys)):
            color = _PALETTE[i % len(_PALETTE)]
            pts = [tuple(map(float, p)) for p in poly.reshape(-1, 2)]
            if len(pts) < 2:
                continue
            drw.polygon(pts, outline=color + (255,), width=self.line_width)
            if self.with_labels and texts is not None and i < len(texts):
                label = texts[i]
                if scores is not None and i < len(scores):
                    label = f"{label} {float(scores[i]):.2f}"
                x = min(p[0] for p in pts)
                y = max(0.0, min(p[1] for p in pts) - 12)
                tw = max(8, int(len(label) * 6))
                drw.rectangle([x, y, x + tw, y + 11], fill=color + (180,))
                drw.text((x + 1, y), label, fill=(255, 255, 255, 255))
        return np.asarray(img, np.float32) / 255.0

    def draw_spotter_output(
        self, image: np.ndarray, result: Dict, image_size: Optional[int] = None
    ) -> np.ndarray:
        """Convenience over the val-loop result dict ({pred_texts,
        pred_polys[, scores]}); polys already in pixel coordinates."""
        return self.draw_instances(
            image,
            np.asarray(result.get("pred_polys", np.zeros((0, 16, 2)))),
            result.get("pred_texts"),
            result.get("scores"),
        )
