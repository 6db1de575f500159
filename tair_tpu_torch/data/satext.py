"""SA-Text dataset: annotation parsing, per-item synthesis, static collate.

The port's own copy of ``tair_tpu/data/satext.py``: JSON parsing, ASCII
filtering, the 10:1 train/val split by sorted key, CAPTION prompts, the VAL
subsample of two images, HQ loading with retry and random-index substitution,
per-item degradation-kernel sampling, empty-prompt dropout, and the synthetic
stand-in with readable 5x7 glyphs. Pure numpy with the same random calls in
the same order, so items and batches equal the JAX package's bit for bit.

Collate turns the ragged per-image instance lists into fixed [B, MAX_INST]
arrays + inst_mask and tokenizes the prompts to [B, 77] on the host. PIL is
imported only where an image file is decoded.
"""

from __future__ import annotations

import io
import json
import os
import random
import threading
import time
import queue as queue_mod
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..models.tokenizer import tokenize
from ..spotter.charset import MAX_WORD_LEN, PAD_ID, encode_text, is_encodable
from .kernels import sample_degradation_kernels

MAX_INSTANCES = 32


def make_caption(texts: List[str]) -> str:
    quoted = [f'"{t}"' for t in texts]
    return (
        f"A realistic scene where the texts {', '.join(quoted)} appear clearly "
        "on signs, boards, buildings, or other objects."
    )


def make_tag_prompt(texts: List[str]) -> str:
    return ", ".join(f'"{t}"' for t in texts)


def load_satext_file_list(
    image_root: str,
    ann_path: str,
    mode: str = "TRAIN",
    model_img_size: int = 512,
    val_sample: Optional[int] = 2,
    seed: Optional[int] = None,
) -> List[Dict]:
    """Parse restoration_dataset.json -> list of per-image records."""
    with open(ann_path) as f:
        data = sorted(json.load(f).items())
    split = int(len(data) * 10 / 11)
    data = dict(data[:split] if mode == "TRAIN" else data[split:])

    files = []
    for img in sorted(os.listdir(image_root)):
        img_id = img.split(".")[0]
        if img_id not in data:
            continue
        texts, text_encs, boxes, polys = [], [], [], []
        for ann in data[img_id]["0"]["text_instances"]:
            text = ann["text"]
            if not (is_encodable(text) and len(text) < 26 and len(text) > 0):
                continue
            if not all(32 <= ord(c) < 127 for c in text):
                continue
            texts.append(text)
            text_encs.append(encode_text(text))
            x1, y1, x2, y2 = [v / model_img_size for v in ann["bbox"]]
            boxes.append([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1])
            poly = np.asarray(ann["polygon"], np.float32) / model_img_size
            polys.append(poly)
        if not boxes:
            continue
        files.append(
            dict(
                image_path=os.path.join(image_root, img),
                prompt=make_caption(texts),
                text=texts,
                bbox=np.asarray(boxes, np.float32),
                poly=np.stack(polys),
                text_enc=np.stack(text_encs),
                img_name=img_id,
            )
        )
    if mode == "VAL" and val_sample is not None:
        rng = random.Random(seed)
        files = rng.sample(files, min(val_sample, len(files)))
    return files


@dataclass
class SATextDataset:
    """Per-item HQ image + degradation kernels + padded text annotations."""

    records: List[Dict]
    out_size: int = 512
    p_empty_prompt: float = 0.2
    seed: int = 0
    backend: object = None  # file_backend.BaseBackend; None -> disk

    def __len__(self) -> int:
        return len(self.records)

    def _load_image(self, path: str) -> Optional[np.ndarray]:
        from PIL import Image

        from .file_backend import HardDiskBackend

        if self.backend is None:
            self.backend = HardDiskBackend()
        try:
            img = Image.open(io.BytesIO(self.backend.get(path))).convert("RGB")
        except Exception:
            return None
        if img.height != self.out_size or img.width != self.out_size:
            img = img.resize((self.out_size, self.out_size), Image.BICUBIC)
        return np.asarray(img, np.uint8)

    def __getitem__(self, index: int) -> Dict:
        rng = np.random.RandomState((self.seed * 1_000_003 + index) % (2**31))
        rec = self.records[index]
        img = self._load_image(rec["image_path"])
        retries = 0
        while img is None and retries < 5:
            index = rng.randint(0, len(self.records))
            rec = self.records[index]
            img = self._load_image(rec["image_path"])
            retries += 1
        if img is None:
            raise RuntimeError(f"failed to load any image near {rec['image_path']}")

        k1, k2, sinc = sample_degradation_kernels(rng)
        prompt = rec["prompt"] if rng.uniform() >= self.p_empty_prompt else ""
        return dict(
            hq=(img / 255.0).astype(np.float32),
            kernel1=k1,
            kernel2=k2,
            sinc_kernel=sinc,
            prompt=prompt,
            text=rec["text"],
            bbox=rec["bbox"],
            poly=rec["poly"],
            text_enc=rec["text_enc"],
            img_name=rec["img_name"],
        )


def collate(items: List[Dict], max_inst: int = MAX_INSTANCES) -> Dict[str, np.ndarray]:
    """Stack items into a static-shape numpy batch (device-ready)."""
    b = len(items)
    n_pts = items[0]["poly"].shape[1]
    batch = dict(
        hq=np.stack([it["hq"] for it in items]),
        kernel1=np.stack([it["kernel1"] for it in items]),
        kernel2=np.stack([it["kernel2"] for it in items]),
        sinc_kernel=np.stack([it["sinc_kernel"] for it in items]),
        tokens=tokenize([it["prompt"] for it in items]),
        inst_mask=np.zeros((b, max_inst), bool),
        boxes=np.zeros((b, max_inst, 4), np.float32),
        ctrl_points=np.zeros((b, max_inst, n_pts, 2), np.float32),
        texts=np.full((b, max_inst, MAX_WORD_LEN), PAD_ID, np.int32),
        img_names=[it["img_name"] for it in items],
        raw_texts=[it["text"] for it in items],
    )
    for i, it in enumerate(items):
        n = min(len(it["bbox"]), max_inst)
        batch["inst_mask"][i, :n] = True
        batch["boxes"][i, :n] = it["bbox"][:n]
        batch["ctrl_points"][i, :n] = it["poly"][:n]
        batch["texts"][i, :n] = it["text_enc"][:n]
    return batch


# 5x7 bitmap font, A-Z: 7 rows of 5 bits each (MSB = leftmost column).
# Rendered into the synthetic signs so the TRANSCRIPTION of each instance is
# recoverable from pixels: random strokes would make the recognition loss
# unlearnable noise.
_FONT5X7 = {
    "A": (0x0E, 0x11, 0x11, 0x1F, 0x11, 0x11, 0x11),
    "B": (0x1E, 0x11, 0x11, 0x1E, 0x11, 0x11, 0x1E),
    "C": (0x0E, 0x11, 0x10, 0x10, 0x10, 0x11, 0x0E),
    "D": (0x1E, 0x11, 0x11, 0x11, 0x11, 0x11, 0x1E),
    "E": (0x1F, 0x10, 0x10, 0x1E, 0x10, 0x10, 0x1F),
    "F": (0x1F, 0x10, 0x10, 0x1E, 0x10, 0x10, 0x10),
    "G": (0x0E, 0x11, 0x10, 0x17, 0x11, 0x11, 0x0F),
    "H": (0x11, 0x11, 0x11, 0x1F, 0x11, 0x11, 0x11),
    "I": (0x0E, 0x04, 0x04, 0x04, 0x04, 0x04, 0x0E),
    "J": (0x07, 0x02, 0x02, 0x02, 0x02, 0x12, 0x0C),
    "K": (0x11, 0x12, 0x14, 0x18, 0x14, 0x12, 0x11),
    "L": (0x10, 0x10, 0x10, 0x10, 0x10, 0x10, 0x1F),
    "M": (0x11, 0x1B, 0x15, 0x15, 0x11, 0x11, 0x11),
    "N": (0x11, 0x19, 0x15, 0x13, 0x11, 0x11, 0x11),
    "O": (0x0E, 0x11, 0x11, 0x11, 0x11, 0x11, 0x0E),
    "P": (0x1E, 0x11, 0x11, 0x1E, 0x10, 0x10, 0x10),
    "Q": (0x0E, 0x11, 0x11, 0x11, 0x15, 0x12, 0x0D),
    "R": (0x1E, 0x11, 0x11, 0x1E, 0x14, 0x12, 0x11),
    "S": (0x0F, 0x10, 0x10, 0x0E, 0x01, 0x01, 0x1E),
    "T": (0x1F, 0x04, 0x04, 0x04, 0x04, 0x04, 0x04),
    "U": (0x11, 0x11, 0x11, 0x11, 0x11, 0x11, 0x0E),
    "V": (0x11, 0x11, 0x11, 0x11, 0x11, 0x0A, 0x04),
    "W": (0x11, 0x11, 0x11, 0x15, 0x15, 0x1B, 0x11),
    "X": (0x11, 0x11, 0x0A, 0x04, 0x0A, 0x11, 0x11),
    "Y": (0x11, 0x11, 0x0A, 0x04, 0x04, 0x04, 0x04),
    "Z": (0x1F, 0x01, 0x02, 0x04, 0x08, 0x10, 0x1F),
}


def _glyph_mask(word: str) -> np.ndarray:
    """[7, 6*len(word)] binary mask (1 px inter-letter spacing)."""
    cols = []
    for ch in word:
        rows = _FONT5X7[ch]
        g = np.array(
            [[(r >> (4 - c)) & 1 for c in range(5)] for r in rows], np.float32
        )
        cols.append(np.pad(g, ((0, 0), (0, 1))))
    return np.concatenate(cols, axis=1)


class SyntheticSAText:
    """Synthetic stand-in for SA-Text (smoke tests / environments without the
    dataset): random textured images with high-contrast rectangle 'signs',
    random ASCII words RENDERED AS READABLE 5x7 GLYPHS (so detection AND
    recognition are learnable), boxes and polygons consistent with the
    layout."""

    def __init__(self, size: int = 512, length: int = 64, seed: int = 0):
        self.size = size
        self.length = length
        self.seed = seed

    def __len__(self):
        return self.length

    def __getitem__(self, index: int) -> Dict:
        rng = np.random.RandomState((self.seed * 7_777_777 + index) % (2**31))
        s = self.size
        img = rng.uniform(0.2, 0.8, (s, s, 3)).astype(np.float32)
        # smooth background
        for _ in range(2):
            img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3.0

        n = rng.randint(1, 4)
        texts, boxes, polys, encs = [], [], [], []
        for _ in range(n):
            w = rng.randint(s // 8, s // 3)
            h = rng.randint(s // 16, s // 6)
            x = rng.randint(0, s - w)
            y = rng.randint(0, s - h)
            img[y : y + h, x : x + w] = rng.uniform(0.85, 1.0)
            # largest glyph scale the sign height allows (big text survives
            # degradation), word length bounded by width at that scale
            k = max(1, (h - 4) // 7)
            while k > 1 and (w - 4) // (6 * k) < 2:
                k -= 1
            max_len = max(2, min(8, (w - 4) // (6 * k)))
            word = "".join(
                chr(rng.randint(65, 91))
                for _ in range(rng.randint(2, max_len + 1))
            )
            mask = np.kron(
                _glyph_mask(word), np.ones((k, k), np.float32)
            )
            mh, mw = mask.shape
            gy = y + (h - mh) // 2
            gx = x + (w - mw) // 2
            ink = rng.uniform(0.0, 0.15)
            # clip the paste to image bounds (tiny test sizes can make the
            # minimum 2-letter word wider than the sign)
            gy0, gx0 = max(0, gy), max(0, gx)
            gy1, gx1 = min(s, gy + mh), min(s, gx + mw)
            sub = mask[gy0 - gy : gy1 - gy, gx0 - gx : gx1 - gx][..., None]
            img[gy0:gy1, gx0:gx1] = (
                img[gy0:gy1, gx0:gx1] * (1 - sub) + ink * sub
            )
            texts.append(word)
            encs.append(encode_text(word))
            x1, y1, x2, y2 = x / s, y / s, (x + w) / s, (y + h) / s
            boxes.append([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1])
            top = np.stack(
                [np.linspace(x1, x2, 8), np.full(8, y1)], -1
            )
            bot = np.stack(
                [np.linspace(x2, x1, 8), np.full(8, y2)], -1
            )
            polys.append(np.concatenate([top, bot]).astype(np.float32))

        k1, k2, sinc = sample_degradation_kernels(rng)
        return dict(
            hq=img,
            kernel1=k1,
            kernel2=k2,
            sinc_kernel=sinc,
            prompt=make_caption(texts),
            text=texts,
            bbox=np.asarray(boxes, np.float32),
            poly=np.stack(polys),
            text_enc=np.stack(encs),
            img_name=f"synthetic_{index:05d}",
        )


def data_iterator(
    dataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    max_inst: int = MAX_INSTANCES,
    prefetch: int = 2,
    process_index: int = 0,
    process_count: int = 1,
    batch_seconds: Optional[List[float]] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite host-side batch iterator with background-thread prefetch.

    Multi-host: each process consumes a disjoint shard of the dataset
    (records strided by process index). `batch_seconds`, when given, gets the
    host seconds of each batch's synthesis, collate and tokenization appended
    as the batch is made. An exception in the background thread is raised by
    the iterator.
    """
    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        try:
            rng = random.Random(seed)
            order = list(range(process_index, len(dataset), process_count))
            while not stop.is_set():
                if shuffle:
                    rng.shuffle(order)
                for i in range(0, len(order) - batch_size + 1, batch_size):
                    if stop.is_set():
                        return
                    t0 = time.perf_counter()
                    items = [dataset[j] for j in order[i : i + batch_size]]
                    batch = collate(items, max_inst)
                    if batch_seconds is not None:
                        batch_seconds.append(time.perf_counter() - t0)
                    q.put(batch)
        except BaseException as exc:  # handed to the consumer, which raises it
            q.put(exc)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
