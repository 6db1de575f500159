"""Captioners: empty, LLaVA (HF transformers) and RAM++ (the port's graph).

Counterpart of ``tair_tpu/utils/caption.py``: DiffBIR's captioning options,
outside the TAIR serving path (which prompts from its own spotter). LLaVA-1.5
runs through HF ``transformers``, imported when a checkpoint is loaded; it needs
a local ``llava-hf/llava-1.5-7b-hf``-layout directory. RAM++ is
``models/ram.RAMTagger`` on the card, from ``ram_plus_swin_large_14m.pth`` and
``ram_tag_list.txt``. None of these weights is in the repo.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

_REGISTRY: Dict[str, Callable[..., "Captioner"]] = {}


class Captioner:
    def __call__(self, image) -> str:  # [H, W, 3] in [0, 1]
        raise NotImplementedError


class EmptyCaptioner(Captioner):
    def __call__(self, image) -> str:
        return ""


class LLaVACaptioner(Captioner):
    """A short description by LLaVA-1.5 (the reference's question prompt,
    greedy decoding).

    model_path: a local directory in the HF ``llava-hf/llava-1.5-*-hf`` layout.
    model and processor may be passed directly instead."""

    QUESTION = "Please give me a very short description of this image."

    def __init__(
        self,
        model_path: str | None = None,
        max_new_tokens: int = 512,
        model=None,
        processor=None,
    ):
        if model is None or processor is None:
            if not model_path:
                raise ValueError(
                    "LLaVACaptioner needs a local checkpoint directory "
                    "(llava-hf/llava-1.5-7b-hf layout) and the transformers package"
                )
            from transformers import AutoProcessor, LlavaForConditionalGeneration

            processor = AutoProcessor.from_pretrained(model_path)
            model = LlavaForConditionalGeneration.from_pretrained(model_path)
        self.processor = processor
        self.model = model.eval()
        self.max_new_tokens = max_new_tokens
        # llava_v1's conversation template
        self.prompt = f"USER: <image>\n{self.QUESTION} ASSISTANT:"

    def __call__(self, image: np.ndarray) -> str:
        import torch
        from PIL import Image

        img = Image.fromarray((np.clip(image, 0.0, 1.0) * 255).astype(np.uint8))
        inputs = self.processor(images=img, text=self.prompt, return_tensors="pt")
        # some processor versions emit token_type_ids, which generate rejects
        inputs.pop("token_type_ids", None)
        with torch.no_grad():
            out = self.model.generate(
                **inputs, do_sample=False, max_new_tokens=self.max_new_tokens
            )
        n_in = inputs["input_ids"].shape[1]
        text = self.processor.batch_decode(out[:, n_in:], skip_special_tokens=True)[0]
        return text.strip()


class RAMCaptioner(Captioner):
    """The tags of RAM++ joined by ``", "`` (the image resized to 384 first).

    checkpoint, tag_list_path, threshold_path: RAM++'s files (models/ram.py);
    a built `tagger` may be passed instead. The tagger runs on `device`
    (``cuda`` unless the caller asks for the CPU)."""

    def __init__(
        self,
        checkpoint: str | None = None,
        tag_list_path: str | None = None,
        threshold_path: str | None = None,
        tagger=None,
        device="cuda",
    ):
        from ..models.ram import RAMTagger

        if tagger is None:
            if not checkpoint:
                raise ValueError(
                    "RAMCaptioner needs the ram_plus_swin_large_14m.pth "
                    "checkpoint (and ram_tag_list.txt); the graph is the port's, "
                    "only the weights are external (models/ram.py)"
                )
            tagger = RAMTagger.from_torch(
                checkpoint, tag_list_path=tag_list_path,
                threshold_path=threshold_path, device=device,
            )
        self.tagger = tagger

    def __call__(self, image) -> str:
        import torch

        from ..models.ram import preprocess

        x = torch.as_tensor(image).to(device=self.tagger.device, dtype=torch.float32)
        x = preprocess(x.clamp(0.0, 1.0), self.tagger.cfg.swin.img_size)
        return ", ".join(self.tagger(x)[0])


def register_captioner(name: str, factory: Callable[..., Captioner]) -> None:
    _REGISTRY[name] = factory


def build_captioner(name: str, **kwargs) -> Captioner:
    if name in ("none", "empty", "", None):
        return EmptyCaptioner()
    if name not in _REGISTRY:
        raise ValueError(
            f"captioner {name!r} not registered; register a factory via "
            "register_captioner"
        )
    return _REGISTRY[name](**kwargs)


register_captioner("empty", EmptyCaptioner)
register_captioner("llava", LLaVACaptioner)
register_captioner("ram", RAMCaptioner)
