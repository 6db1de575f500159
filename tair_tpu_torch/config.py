"""Single-headed YAML config system.

Counterpart of ``tair_tpu/config.py``: YAML -> dataclasses, model geometry from
named presets ("default" = production geometry, "tiny" = test geometry) with
optional spotter overrides, and the dataset the config names.

The port reads YAML without PyYAML, through `parse_yaml`, a reader for the
subset that ``configs/*.yaml`` use: nested block mappings indented by spaces,
scalars (int, float with a dot such as ``1.0e-4``, bool, null, quoted and bare
strings) resolved as PyYAML resolves them, flow lists of scalars, and
comments. Anything outside that subset raises, so no file reads differently
here than through PyYAML.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from .data.batch_transform import DegradationConfig


@dataclass
class DatasetConfig:
    kind: str = "synthetic"          # "satext" | "synthetic"
    image_root: str = ""
    ann_path: str = ""
    out_size: int = 512
    p_empty_prompt: float = 0.2
    max_instances: int = 32
    synthetic_length: int = 256


@dataclass
class TrainConfig:
    stage: str = "stage1"            # stage1 | stage2 | stage3
    train_steps: int = 100_000
    batch_size: int = 3
    learning_rate: float = 1e-4
    # micro-batches averaged per optimizer update; train_steps counts
    # micro-steps, so updates = train_steps // grad_accum
    grad_accum: int = 1
    ckpt_every: int = 25_000
    # 0 = off. Periodic weight-only float16 .npz export (params only) to
    # exp_dir/params_step_N.npz, loadable as init_params by either package
    save_params_every: int = 0
    # False skips the end-of-training checkpoint of the whole train state
    final_checkpoint: bool = True
    log_loss_every: int = 50
    log_image_every: int = 500
    num_val_images: int = 2
    ocr_loss_weight: float = 0.0
    unet_feat_sampling_timestep: Tuple[int, ...] = (10, 20, 30, 40, 50)
    # 0 = off (uniform over the full schedule); else t ~ U(0, timestep_max)
    timestep_max: int = 0
    exp_dir: str = "./runs/exp"
    resume: Optional[str] = None
    # weight-only .npz (train/checkpoint.py save_params) merged into the
    # fresh init before training
    init_params: Optional[str] = None
    seed: int = 0
    n_data_devices: Optional[int] = None  # default: all devices
    log_tool: Optional[str] = None   # None/jsonl | tensorboard | wandb
    # "hungarian" (exact) | "hungarian_host" | "greedy"
    matcher: str = "hungarian"
    # sharding of params + optimizer moments over the data axis
    # (parallel/fsdp.py)
    fsdp: bool = False


@dataclass
class ValConfig:
    lq_dir: str = ""
    gt_dir: Optional[str] = None
    output_dir: str = "./results"
    steps: int = 50
    prompt_style: str = "CAPTION"    # CAPTION | TAG
    score_threshold: float = 0.5
    cfg_scale: float = 1.0
    seed: int = 231
    niqe_params: Optional[str] = None
    # full-reference perceptual metrics, each from external checkpoints
    # "backbone_path:head_path"
    lpips_weights: Optional[str] = None
    dists_weights: Optional[str] = None
    clipiqa_weights: Optional[str] = None
    maniqa_weights: Optional[str] = None
    musiq_weights: Optional[str] = None
    # tiled (val_patches) settings
    patch_size: int = 128
    overlap: int = 16
    out_scale: int = 4
    chunk: Optional[int] = None
    tiled_ocr_loop: bool = True


@dataclass
class ExperimentConfig:
    model_preset: str = "default"    # "default" | "tiny"
    # TESTRConfig field overrides
    testr_overrides: Dict[str, Any] = field(default_factory=dict)
    dtype: str = "bfloat16"
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    degradation: DegradationConfig = field(default_factory=DegradationConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    val: ValConfig = field(default_factory=ValConfig)
    weights: Dict[str, str] = field(default_factory=dict)  # torch ckpt paths


# ---- the YAML subset ----------------------------------------------------

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"^[-+]?(0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"^[-+]?[0-9]*\.[0-9]*([eE][-+][0-9]+)?$")
# a bare scalar that PyYAML could resolve to something other than the int,
# float or string this reader would make of it (hex, octal, underscores,
# sexagesimal, exponents without a dot, infinities, timestamps)
_NUMBER_LIKE = re.compile(r"^[-+.]?[0-9]|^[-+]?\.(inf|Inf|INF|nan|NaN|NAN)$")
_INDICATORS = tuple("{}&*!|>%@`-?,")


class YAMLSubsetError(ValueError):
    pass


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " [,:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _quoted(s: str, where: str) -> str:
    q = s[0]
    if len(s) < 2 or s[-1] != q:
        raise YAMLSubsetError(f"{where}: unterminated quoted string {s!r}")
    body = s[1:-1]
    if q == "'":
        if re.search(r"(?<!')'(?!')", body.replace("''", "")):
            raise YAMLSubsetError(f"{where}: stray quote in {s!r}")
        return body.replace("''", "'")
    if "\\" in body or '"' in body:
        raise YAMLSubsetError(f"{where}: escapes in double-quoted strings are outside the subset")
    return body


def _scalar(s: str, where: str):
    s = s.strip()
    if s[:1] in ("'", '"'):
        return _quoted(s, where)
    if s.startswith("["):
        if not s.endswith("]"):
            raise YAMLSubsetError(f"{where}: unterminated flow list {s!r}")
        inner = s[1:-1].strip()
        if not inner:
            return []
        if any(c in inner for c in "[]{}'\""):
            raise YAMLSubsetError(f"{where}: only flow lists of plain scalars are in the subset")
        return [_scalar(item, where) for item in inner.split(",")]
    if s in _NULL:
        return None
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    if _INT.match(s):
        return int(s)
    if _FLOAT.match(s) and any(c.isdigit() for c in s):
        return float(s)
    if _NUMBER_LIKE.match(s) or s.startswith(_INDICATORS) or ": " in s or s.endswith(":"):
        raise YAMLSubsetError(f"{where}: the scalar {s!r} is outside the subset")
    return s


def parse_yaml(text: str) -> Dict[str, Any]:
    """The mapping a YAML document of the subset holds (None for an empty one)."""
    lines: List[Tuple[int, str, int]] = []
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw:
            raise YAMLSubsetError(f"line {n}: tabs are outside the subset")
        body = _strip_comment(raw).rstrip()
        if not body.strip():
            continue
        if body.strip() in ("---", "...") or body.lstrip().startswith(("- ", "? ", "%")) \
                or body.strip() == "-":
            raise YAMLSubsetError(f"line {n}: {body.strip()!r} is outside the subset")
        lines.append((len(body) - len(body.lstrip(" ")), body.strip(), n))
    if not lines:
        return None
    value, i = _mapping(lines, 0, lines[0][0])
    if i != len(lines):
        raise YAMLSubsetError(f"line {lines[i][2]}: unexpected indentation")
    return value


def _mapping(lines, i: int, indent: int):
    out: Dict[str, Any] = {}
    while i < len(lines) and lines[i][0] == indent:
        _, body, n = lines[i]
        where = f"line {n}"
        m = re.match(r"^([A-Za-z_][A-Za-z0-9_.\-]*):(?:\s+(.*))?$", body)
        if m is None:
            raise YAMLSubsetError(f"{where}: {body!r} is not a 'key: value' line of the subset")
        key, rest = m.group(1), (m.group(2) or "")
        if key in out:
            raise YAMLSubsetError(f"{where}: duplicate key {key!r}")
        if rest:
            out[key] = _scalar(rest, where)
            i += 1
        elif i + 1 < len(lines) and lines[i + 1][0] > indent:
            out[key], i = _mapping(lines, i + 1, lines[i + 1][0])
        else:
            out[key] = None
            i += 1
    if i < len(lines) and lines[i][0] > indent:
        raise YAMLSubsetError(f"line {lines[i][2]}: unexpected indentation")
    return out, i


# ---- dataclasses --------------------------------------------------------

def _merge_dataclass(cls, data: Dict[str, Any]):
    """Build dataclass from dict, recursing into dataclass fields."""
    if data is None:
        return cls()
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if dataclasses.is_dataclass(f.type) or f.name in (
            "dataset", "degradation", "train", "val",
        ):
            sub = {
                "dataset": DatasetConfig,
                "degradation": DegradationConfig,
                "train": TrainConfig,
                "val": ValConfig,
            }.get(f.name)
            kwargs[f.name] = _merge_dataclass(sub, v) if sub else v
        elif isinstance(v, list):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def load_config(path: str) -> ExperimentConfig:
    with open(path) as f:
        data = parse_yaml(f.read()) or {}
    return _merge_dataclass(ExperimentConfig, data)


def compute_dtype(cfg: ExperimentConfig) -> torch.dtype:
    """The type the model computes in: the config's ``dtype``."""
    try:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]
    except KeyError:
        raise ValueError(f"unknown dtype {cfg.dtype!r}; choose float32 or bfloat16") from None


def build_model(cfg: ExperimentConfig, device="cuda", training: bool = True):
    """The config's model on `device`. For training, float32 master weights
    whatever ``dtype`` says: the train step computes in `compute_dtype(cfg)`
    under autocast, as the JAX package trains (float32 parameters, bfloat16
    compute). For serving (`training=False`) the weights take ``dtype``.
    Parameters are uninitialised until ``init_parameters`` or a load."""
    from .pipeline import build_default_model, build_tiny_model

    dtype = torch.float32 if training else compute_dtype(cfg)
    if cfg.model_preset == "default":
        return build_default_model(dtype=dtype, device=device, training=training,
                                   testr_overrides=cfg.testr_overrides or None)
    if cfg.model_preset == "tiny":
        return build_tiny_model(dtype=dtype, device=device, training=training,
                                testr_overrides=cfg.testr_overrides or None)
    raise ValueError(f"unknown model preset {cfg.model_preset!r}")


def build_dataset(cfg: ExperimentConfig, mode: str = "TRAIN"):
    from .data.satext import SATextDataset, SyntheticSAText, load_satext_file_list

    d = cfg.dataset
    if d.kind == "synthetic":
        return SyntheticSAText(size=d.out_size, length=d.synthetic_length,
                               seed=0 if mode == "TRAIN" else 1)
    records = load_satext_file_list(
        d.image_root, d.ann_path, mode, d.out_size,
        val_sample=2 if mode == "VAL" else None, seed=0,
    )
    return SATextDataset(records, d.out_size, d.p_empty_prompt)
