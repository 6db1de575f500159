"""The port stands alone: importing it pulls in neither jax, flax nor the JAX
package, and its entry points ask for a CUDA device unless told otherwise."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

MODULES = [
    "tair_tpu_torch",
    "tair_tpu_torch.pipeline",
    "tair_tpu_torch.ops.attention",
    "tair_tpu_torch.ops.flash_attention",
    "tair_tpu_torch.ops.msda_reduce",
    "tair_tpu_torch.ops.patchify",
    "tair_tpu_torch.ops.quant",
    "tair_tpu_torch.ops._build",
    "tair_tpu_torch.ops.launches",
    "tair_tpu_torch.probes",
    "tair_tpu_torch.probes.dyngather",
    "tair_tpu_torch.probes.stream",
    "tair_tpu_torch.probes.msda_lab",
    "tair_tpu_torch.diffusion.schedules",
    "tair_tpu_torch.diffusion.diffusion",
    "tair_tpu_torch.sampler.spaced",
    "tair_tpu_torch.models.layers",
    "tair_tpu_torch.models.attention",
    "tair_tpu_torch.models.unet",
    "tair_tpu_torch.models.vae",
    "tair_tpu_torch.models.clip",
    "tair_tpu_torch.models.swinir",
    "tair_tpu_torch.models.cldm",
    "tair_tpu_torch.models.prompt_splice",
    "tair_tpu_torch.spotter.charset",
    "tair_tpu_torch.spotter.ms_deform_attn",
    "tair_tpu_torch.spotter.transformer",
    "tair_tpu_torch.spotter.testr",
    "tair_tpu_torch.spotter.matcher",
    "tair_tpu_torch.spotter.losses",
    "tair_tpu_torch.train.stages",
    "tair_tpu_torch.train.step",
    "tair_tpu_torch.weights.convert",
    "tair_tpu_torch.models.tokenizer",
    "tair_tpu_torch.data.kernels",
    "tair_tpu_torch.data.file_backend",
    "tair_tpu_torch.data.satext",
    "tair_tpu_torch.data.resize",
    "tair_tpu_torch.data.degradation",
    "tair_tpu_torch.data.diffjpeg",
    "tair_tpu_torch.data.batch_transform",
    "tair_tpu_torch.utils.metrics",
    "tair_tpu_torch.utils.logging",
    "tair_tpu_torch.utils.png",
    "tair_tpu_torch.train.checkpoint",
    "tair_tpu_torch.train.__main__",
    "tair_tpu_torch.config",
    "tair_tpu_torch.tiling",
    "tair_tpu_torch.utils.image_io",
    "tair_tpu_torch.utils.visualizer",
    "tair_tpu_torch.utils.text_eval",
    "tair_tpu_torch.utils.submission",
    "tair_tpu_torch.utils.niqe",
    "tair_tpu_torch.val",
    "tair_tpu_torch.val_patches",
    "tair_tpu_torch.spotter_eval",
    "tair_tpu_torch.sampler.base",
    "tair_tpu_torch.sampler.ddim",
    "tair_tpu_torch.sampler.dpm",
    "tair_tpu_torch.sampler.edm",
    "tair_tpu_torch.models.cleaners",
    "tair_tpu_torch.utils.tilevae",
    "tair_tpu_torch.utils.guidance",
    "tair_tpu_torch.diffbir_pipeline",
    "tair_tpu_torch.weights.export",
    "tair_tpu_torch.convert_weights",
    "tair_tpu_torch.utils.iqa",
    "tair_tpu_torch.utils.lpips",
    "tair_tpu_torch.utils.dists",
    "tair_tpu_torch.utils.clipiqa",
    "tair_tpu_torch.utils.maniqa",
    "tair_tpu_torch.utils.musiq",
    "tair_tpu_torch.weights.musiq_shim",
    "tair_tpu_torch.native_ext",
    "tair_tpu_torch.data.augmentation",
    "tair_tpu_torch.data.cocotext",
]

ENTRY_POINTS = ["tair_tpu_torch.val", "tair_tpu_torch.val_patches", "tair_tpu_torch.spotter_eval"]


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )


def test_port_imports_no_jax_flax_or_jax_package():
    proc = _run(
        f"""
        import importlib, sys
        for name in {MODULES!r}:
            importlib.import_module(name)
        # nor regex, yaml, PIL or cv2 at import (PIL is imported where an image
        # file is decoded or drawn)
        bad = sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "flax", "tair_tpu", "regex", "yaml", "PIL",
                                   "cv2")
        )
        assert not bad, bad
        print("clean", len({MODULES!r}))
        """
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["clean", str(len(MODULES))]


def test_sources_do_not_name_jax_imports():
    offenders = []
    files = list((ROOT / "tair_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")) and any(
                tok in s.split()[1].split(".")[0] for tok in ("jax", "flax")
            ) or s.startswith(("import tair_tpu ", "from tair_tpu ", "from tair_tpu.", "import tair_tpu.")):
                offenders.append(f"{path.name}: {s}")
    assert not offenders, offenders


def test_sources_import_neither_regex_yaml_nor_pil_outside_the_image_loader():
    """PIL only where an image file is decoded (other than the PNGs the port
    reads itself) or drawn, lazily; cv2 nowhere."""
    offenders = []
    files = list((ROOT / "tair_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")) and s.split()[1].split(".")[0] in (
                "regex", "yaml", "PIL", "cv2"
            ):
                assert line != s, f"{path}: a top-level import of {s.split()[1]}"
                offenders.append(f"{path.relative_to(ROOT)}: {s}")
    assert sorted(offenders) == [
        "tair_tpu_torch/data/augmentation.py: from PIL import Image",
        "tair_tpu_torch/data/satext.py: from PIL import Image",
        "tair_tpu_torch/utils/image_io.py: from PIL import Image",
        "tair_tpu_torch/utils/visualizer.py: from PIL import Image",
        "tair_tpu_torch/utils/visualizer.py: from PIL import ImageDraw",
        "tair_tpu_torch/utils/visualizer.py: from PIL import ImageDraw",
    ]


@pytest.mark.parametrize("entry_point", ["build_default_model", "build_tiny_model"])
def test_entry_points_default_to_cuda_and_raise_without_it(entry_point):
    import torch

    from tair_tpu_torch import pipeline

    if torch.cuda.is_available():  # decided inside the test, never at import
        pytest.skip("a CUDA device is present: the default device works here")
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(pipeline, entry_point)()


@pytest.mark.parametrize("module", ENTRY_POINTS)
def test_entry_point_help_works_without_a_card(module):
    proc = subprocess.run([sys.executable, "-m", module, "--help"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout and "--config" in proc.stdout


@pytest.mark.parametrize("module", ENTRY_POINTS)
def test_entry_points_raise_without_a_card_unless_told_cpu(module):
    import torch

    if torch.cuda.is_available():  # decided inside the test, never at import
        pytest.skip("a CUDA device is present: the default device works here")
    config = "configs/train_smoke.yaml" if module.endswith("spotter_eval") else "configs/val_smoke.yaml"
    proc = subprocess.run([sys.executable, "-m", module, "--config", config], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "RuntimeError" in proc.stderr and "CUDA" in proc.stderr


def test_chip_smoke_refuses_to_run_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_kernel_wrappers_do_not_build_on_import():
    proc = _run(
        """
        import tair_tpu_torch.ops.flash_attention, tair_tpu_torch.ops.msda_reduce
        import tair_tpu_torch.ops.patchify, tair_tpu_torch.ops.quant, tair_tpu_torch.train.step
        import tair_tpu_torch.probes.dyngather, tair_tpu_torch.probes.stream
        import tair_tpu_torch.probes.msda_lab, tair_tpu_torch.spotter.matcher
        from tair_tpu_torch import native_ext
        from tair_tpu_torch.ops import _build
        assert not _build._LIBS and native_ext._LIB is None
        assert {p.name for p in _build.CSRC.glob("*.cu")} == {
            "flash_attention.cu", "flash_attention_bwd.cu", "flash_attention_tc.cu",
            "flash_attention_wide_tc.cu", "flash_attention_dq_tc.cu",
            "flash_attention_dkv_tc.cu", "msda_reduce.cu", "patchify.cu",
            "quant_act.cu", "int8_conv.cu", "jv_assign.cu",
            "probe_gather.cu", "probe_stream.cu", "probe_msda_lab.cu"}
        assert set(_build.KERNEL_SOURCES) == {p.stem for p in _build.CSRC.glob("*.cu")}
        print("ok")
        """
    )
    assert proc.returncode == 0, proc.stderr
