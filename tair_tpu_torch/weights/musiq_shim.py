"""Key-rename shim: published MUSIQ torch checkpoints -> utils/musiq's layout.

The port's own copy of ``tair_tpu/weights/musiq_shim.py`` (numpy only). The
JAX package's counterpart of pyiqa's ``create_metric('musiq')`` reads
``musiq_koniq_ckpt.pth``, a torch re-export of the official google-research
weights. Neither pyiqa nor that checkpoint was at hand, so the shim cannot be
pinned to one exact key listing; it is a ROLE-BASED renamer instead: every
parameter of the MUSIQ architecture has a fixed shape signature (root 7x7x3xW
convolution, one BiT pre-activation bottleneck, 16W^2/4 -> D patch embedding,
G^2 x D spatial hash embedding, (S+1) x D scale embedding, L transformer
blocks, class-token head), and the shim classifies a checkpoint's keys by
name-alias tables and shape checks, giving the layout that
``weights/convert.convert_musiq`` reads.

Naming families covered (first match wins; see _RULES):
  - utils/musiq's own layout (passed through);
  - BiT/timm-flavoured torch ports: conv_root/gn_root/block1.{gn,conv}N/
    downsample, blocks.N.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2};
  - separate-projection attention (attn.{q,k,v} / {query,key,value}) fused
    into qkv;
  - nn.Sequential MLPs (mlp.0 / mlp.3) and linear1/linear2;
  - common wrapper prefixes (module./net./model./musiq.) stripped.

Anything unclassified raises with the exact keys left over, so a real
checkpoint in a naming not seen yet fails loudly with an actionable message
instead of being mis-mapped in silence. After the first load of the real
pyiqa checkpoint, cross-check one image against pyiqa before trusting
absolute values.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

__all__ = ["shim_musiq_state_dict", "looks_like_repo_layout"]


def looks_like_repo_layout(sd: Dict) -> bool:
    return "patch_encoder.root.weight" in sd and "backbone.cls_token" in sd


_WRAPPERS = ("module.", "net.", "model.", "musiq.")

# (regex on the normalized key) -> repo key template. Normalization:
# '/'->'.', lowercase, torch param suffixes kept. Applied in order.
_RULES = [
    # ---- patch encoder: root ------------------------------------------------
    (r"^(?:conv_root|root\.conv|conv_first|conv_stem|stem\.conv|conv1)\.weight$",
     "patch_encoder.root.weight"),
    (r"^(?:gn_root|root\.gn|root_gn|gn_stem|stem\.norm|bn1|norm_root)\.(weight|bias)$",
     "patch_encoder.root_gn.{0}"),
    # ---- patch encoder: the single pre-act bottleneck ----------------------
    (r"^(?:block1|blocks?\.0|body\.block1|layer1\.0|resblock)\."
     r"(gn[123]|norm[123])\.(weight|bias)$",
     lambda m: f"patch_encoder.block1.gn{m.group(1)[-1]}.{m.group(2)}"),
    (r"^(?:block1|blocks?\.0|body\.block1|layer1\.0|resblock)\."
     r"(conv[123])\.weight$",
     lambda m: f"patch_encoder.block1.{m.group(1)}.weight"),
    (r"^(?:block1|blocks?\.0|body\.block1|layer1\.0|resblock)\."
     r"(?:downsample|proj|shortcut|conv_proj)(?:\.0)?\.weight$",
     "patch_encoder.block1.proj.weight"),
    # ---- patch encoder: output norm + embedding ----------------------------
    (r"^(?:gn_out|out_gn|gn2_out|norm_out|gn_final|postnorm)\.(weight|bias)$",
     "patch_encoder.out_gn.{0}"),
    (r"^(?:embedding|patch_embedding|fc_embed|embed|proj_embed)\.(weight|bias)$",
     "patch_encoder.embedding.{0}"),
    # ---- backbone: tokens / embeddings -------------------------------------
    (r"^(?:backbone\.)?(?:cls_token|class_token)$", "backbone.cls_token"),
    (r"^(?:backbone\.)?(?:spatial_embedding|pos_embed|position_embedding|"
     r"hse|hash_embedding)(?:\.weight)?$", "backbone.spatial_embedding"),
    (r"^(?:backbone\.)?(?:scale_embedding|scale_embed|sce)(?:\.weight)?$",
     "backbone.scale_embedding"),
    # ---- backbone: transformer blocks --------------------------------------
    # prefix variants: transformer.blocks.N / transformer.encoder.layers.N /
    # blocks.N / encoder.layer.N / transformer_encoder.layers.N
    (r"^(?:backbone\.|transformer(?:_encoder)?\.)?(?:encoder\.)?"
     r"(?:blocks?|layers?)\.(\d+)\."
     r"(?:norm1|ln_?1|attention_norm|layernorm_before)\.(weight|bias)$",
     lambda m: f"backbone.blocks.{m.group(1)}.norm1.{m.group(2)}"),
    (r"^(?:backbone\.|transformer(?:_encoder)?\.)?(?:encoder\.)?"
     r"(?:blocks?|layers?)\.(\d+)\."
     r"(?:norm2|ln_?2|ffn_norm|layernorm_after)\.(weight|bias)$",
     lambda m: f"backbone.blocks.{m.group(1)}.norm2.{m.group(2)}"),
    (r"^(?:backbone\.|transformer(?:_encoder)?\.)?(?:encoder\.)?"
     r"(?:blocks?|layers?)\.(\d+)\.(?:attn|attention|self_attn|mha)\."
     r"(?:qkv|in_proj)\.(weight|bias)$",
     lambda m: f"backbone.blocks.{m.group(1)}.attn.qkv.{m.group(2)}"),
    (r"^(?:backbone\.|transformer(?:_encoder)?\.)?(?:encoder\.)?"
     r"(?:blocks?|layers?)\.(\d+)\.(?:attn|attention|self_attn|mha)\."
     r"(q|k|v|query|key|value)\.(weight|bias)$",
     lambda m: f"__qkv__.{m.group(1)}.{m.group(2)[0]}.{m.group(3)}"),
    (r"^(?:backbone\.|transformer(?:_encoder)?\.)?(?:encoder\.)?"
     r"(?:blocks?|layers?)\.(\d+)\.(?:attn|attention|self_attn|mha)\."
     r"(?:proj|out|out_proj|output\.dense|dense_out)\.(weight|bias)$",
     lambda m: f"backbone.blocks.{m.group(1)}.attn.proj.{m.group(2)}"),
    (r"^(?:backbone\.|transformer(?:_encoder)?\.)?(?:encoder\.)?"
     r"(?:blocks?|layers?)\.(\d+)\.(?:mlp\.fc1|mlp\.0|linear1|ffn\.fc1|"
     r"intermediate\.dense)\.(weight|bias)$",
     lambda m: f"backbone.blocks.{m.group(1)}.mlp.fc1.{m.group(2)}"),
    (r"^(?:backbone\.|transformer(?:_encoder)?\.)?(?:encoder\.)?"
     r"(?:blocks?|layers?)\.(\d+)\.(?:mlp\.fc2|mlp\.3|linear2|ffn\.fc2|"
     r"output\.dense)\.(weight|bias)$",
     lambda m: f"backbone.blocks.{m.group(1)}.mlp.fc2.{m.group(2)}"),
    # ---- backbone: final norm + head ---------------------------------------
    (r"^(?:backbone\.|transformer(?:_encoder)?\.)?"
     r"(?:encoder_norm|norm|ln|ln_f|final_norm|layernorm)\.(weight|bias)$",
     "backbone.encoder_norm.{0}"),
    (r"^(?:backbone\.)?(?:head|fc_score|fc|classifier|score_head)(?:\.1)?"
     r"\.(weight|bias)$",
     "backbone.head.{0}"),
]


def _strip_wrappers(sd: Dict) -> Dict:
    keys = list(sd)
    for w in _WRAPPERS:
        if keys and all(k.startswith(w) for k in keys):
            sd = {k[len(w):]: v for k, v in sd.items()}
            keys = list(sd)
    return sd


def shim_musiq_state_dict(sd: Dict) -> Dict:
    """Rename a published MUSIQ torch state dict into the repo layout.

    Returns a dict that MUSIQMetric.from_state_dict and
    weights.convert.convert_musiq read. Raises ValueError listing every key it
    could not classify (and every required role left unfilled).
    """
    sd = {k: np.asarray(v.float().numpy() if hasattr(v, "numpy") else v)
          for k, v in sd.items()}
    sd = _strip_wrappers(sd)
    if looks_like_repo_layout(sd):
        return sd

    out: Dict[str, np.ndarray] = {}
    qkv_parts: Dict[str, Dict[str, np.ndarray]] = {}
    leftovers = []
    for key, val in sd.items():
        norm = key.replace("/", ".").lower()
        if norm.endswith(("num_batches_tracked", "running_mean", "running_var")):
            continue
        for pat, target in _RULES:
            m = re.match(pat, norm)
            if not m:
                continue
            dst = (target(m) if callable(target)
                   else target.format(*m.groups()))
            if dst.startswith("__qkv__."):
                _, blk, which, suffix = dst.split(".")
                qkv_parts.setdefault(f"{blk}.{suffix}", {})[which] = val
            else:
                out[dst] = val
            break
        else:
            leftovers.append(key)

    # fuse separate q/k/v projections into the repo's single qkv matrix
    for blk_suffix, parts in qkv_parts.items():
        blk, suffix = blk_suffix.split(".")
        if set(parts) != {"q", "k", "v"}:
            raise ValueError(
                f"MUSIQ shim: block {blk} has partial separate-qkv "
                f"{suffix}s {sorted(parts)}; expected all of q, k, v"
            )
        out[f"backbone.blocks.{blk}.attn.qkv.{suffix}"] = np.concatenate(
            [parts["q"], parts["k"], parts["v"]], axis=0
        )

    if leftovers:
        raise ValueError(
            "MUSIQ shim could not classify checkpoint keys "
            f"{sorted(leftovers)[:20]}{'...' if len(leftovers) > 20 else ''} "
            "— extend tair_tpu_torch/weights/musiq_shim._RULES with this layout "
            "(see module docstring)."
        )

    _check_roles(out)
    return out


def _check_roles(out: Dict[str, np.ndarray]) -> None:
    required = [
        "patch_encoder.root.weight",
        "patch_encoder.root_gn.weight",
        "patch_encoder.block1.gn1.weight",
        "patch_encoder.block1.conv1.weight",
        "patch_encoder.block1.conv2.weight",
        "patch_encoder.block1.conv3.weight",
        "patch_encoder.out_gn.weight",
        "patch_encoder.embedding.weight",
        "backbone.cls_token",
        "backbone.spatial_embedding",
        "backbone.scale_embedding",
        "backbone.blocks.0.norm1.weight",
        "backbone.blocks.0.attn.qkv.weight",
        "backbone.blocks.0.attn.proj.weight",
        "backbone.blocks.0.mlp.fc1.weight",
        "backbone.blocks.0.mlp.fc2.weight",
        "backbone.encoder_norm.weight",
        "backbone.head.weight",
    ]
    missing = [k for k in required if k not in out]
    if missing:
        raise ValueError(
            f"MUSIQ shim: classification left required roles unfilled: "
            f"{missing}"
        )
    # shape sanity: the architecture pins these signatures
    root = out["patch_encoder.root.weight"]
    if root.ndim != 4 or root.shape[1] != 3:
        raise ValueError(
            f"MUSIQ shim: root conv has shape {root.shape}, expected torch "
            "OIHW with 3 input channels"
        )
    d = out["backbone.cls_token"].reshape(-1).shape[0]
    for name in ("spatial_embedding", "scale_embedding"):
        e = out[f"backbone.{name}"]
        if e.ndim != 2 or e.shape[1] != d:
            raise ValueError(
                f"MUSIQ shim: backbone.{name} shape {e.shape} does not end "
                f"in hidden dim {d}"
            )
    qkv = out["backbone.blocks.0.attn.qkv.weight"]
    if qkv.shape != (3 * d, d):
        raise ValueError(
            f"MUSIQ shim: qkv weight {qkv.shape}, expected {(3 * d, d)}"
        )
