"""Tiled restoration of the port against the JAX package.

``split_with_overlap`` and ``fade_window`` bit-equal to JAX at three sizes,
one of them padded, and ``merge_with_overlap`` bit-equal to JAX's algorithm
(within 1e-6 of the JAX function, see its test); ``restore_tiled`` with a fixed,
deterministic per-patch function (unchunked, and chunked with a padded last
chunk, with the per-patch aux) within 1e-5 of JAX (the cubic x4 upscale's
float32 products are summed in another order); then ``python -m
tair_tpu_torch.val_patches`` in process on the CPU: the files and metric keys
of the JAX script (``val_patches.py:159-173``) and the ``--dump-dir`` bundle.
"""

import json
import zipfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import torch_single_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TILED_TOL = 1e-5

# (H, W, patch, overlap): even grid, padded on both axes, one row of patches
SIZES = [(64, 64, 16, 4), (70, 45, 16, 4), (24, 100, 24, 8)]


def _image(h, w, seed=0):
    return np.random.default_rng(seed).random((h, w, 3), dtype=np.float32)


@pytest.mark.parametrize("h,w,patch,overlap", SIZES)
def test_split_grid_and_split_with_overlap_bit_equal(h, w, patch, overlap):
    from tair_tpu import tiling as jt
    from tair_tpu_torch import tiling as tt

    assert tt.split_grid(h, w, patch, overlap) == jt.split_grid(h, w, patch, overlap)
    img = _image(h, w)
    want = np.asarray(jt.split_with_overlap(jnp.asarray(img), patch, overlap))
    got = tt.split_with_overlap(torch.from_numpy(img), patch, overlap).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("patch,overlap", [(512, 64), (64, 16), (16, 4)])
def test_fade_window_bit_equal(patch, overlap):
    from tair_tpu import tiling as jt
    from tair_tpu_torch import tiling as tt

    np.testing.assert_array_equal(tt.fade_window(patch, overlap), jt.fade_window(patch, overlap))


def _merge_plain(patches, h, w, patch, overlap, scale):
    """JAX's merge in numpy: float32, patch by patch in row-major order, each
    product rounded before its sum."""
    from tair_tpu import tiling as jt

    n_h, n_w, _, _ = jt.split_grid(h, w, patch, overlap)
    op, stride = patch * scale, (patch - overlap) * scale
    window = jt.fade_window(op, overlap * scale)[..., None]
    canvas = np.zeros(((n_h - 1) * stride + op, (n_w - 1) * stride + op, 3), np.float32)
    weights = np.zeros(canvas.shape[:2] + (1,), np.float32)
    for i, p in enumerate(patches):
        region = (slice(i // n_w * stride, i // n_w * stride + op),
                  slice(i % n_w * stride, i % n_w * stride + op))
        canvas[region] = canvas[region] + p * window
        weights[region] = weights[region] + window
    return (canvas / np.maximum(weights, np.float32(1e-8)))[: h * scale, : w * scale]


@pytest.mark.parametrize("h,w,patch,overlap", SIZES)
def test_merge_with_overlap_bit_equal(h, w, patch, overlap):
    """Bit-equal to JAX's algorithm (float32, in patch order). Against the
    JAX function itself within 1e-6: XLA's CPU compile contracts ``cur +
    p * window`` into a fused multiply-add for part of the channels, one
    rounding fewer per patch at an overlap (the values are at most 1)."""
    from tair_tpu import tiling as jt
    from tair_tpu_torch import tiling as tt

    n_h, n_w, _, _ = jt.split_grid(h, w, patch, overlap)
    scale = 4
    patches = np.random.default_rng(1).random(
        (n_h * n_w, patch * scale, patch * scale, 3), dtype=np.float32)
    got = tt.merge_with_overlap(
        torch.from_numpy(patches), (h, w), patch, overlap, patch * scale, overlap * scale).numpy()
    assert got.shape == (h * scale, w * scale, 3)
    np.testing.assert_array_equal(got, _merge_plain(patches, h, w, patch, overlap, scale))
    want = np.asarray(jt.merge_with_overlap(
        jnp.asarray(patches), (h, w), patch, overlap, patch * scale, overlap * scale))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _per_patch(x, reversed_channels):
    """A fixed per-patch function of the restore's shape: it depends on the
    patch's own pixels only, so chunking cannot change it."""
    return 0.5 * x + 0.25 * reversed_channels**2


@pytest.mark.parametrize("chunk", [None, 3, 4], ids=["one_batch", "chunk3_padded", "chunk4"])
def test_restore_tiled_matches_jax(chunk):
    """Patch 16, overlap 4: 70 x 45 in one batch of 6 x 4 = 24 patches; 58 x 45
    (5 x 4 = 20 patches) in chunks of 3 (the last padded by one zero patch)
    and of 4."""
    from tair_tpu import tiling as jt
    from tair_tpu_torch import tiling as tt

    h, w = (70, 45) if chunk is None else (58, 45)
    img = _image(h, w, seed=2)

    def jax_fn(p, rng):
        return _per_patch(p, p[..., ::-1]), {"mean": p.mean((1, 2, 3)), "first": p[:, 0, 0]}

    def torch_fn(p, generator):
        return _per_patch(p, p.flip(-1)), {"mean": p.mean((1, 2, 3)), "first": p[:, 0, 0]}

    import jax

    want, want_aux = jt.restore_tiled(
        jax_fn, jnp.asarray(img), jax.random.PRNGKey(0), patch=16, overlap=4, out_scale=4,
        chunk=chunk, return_aux=True)
    got, got_aux = tt.restore_tiled(
        torch_fn, torch.from_numpy(img), None, patch=16, overlap=4, out_scale=4,
        chunk=chunk, return_aux=True)
    assert tuple(got.shape) == (h * 4, w * 4, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TILED_TOL)
    n = jt.split_grid(h, w, 16, 4)[0] * jt.split_grid(h, w, 16, 4)[1]
    for k in ("mean", "first"):
        assert got_aux[k].shape[0] == n
        np.testing.assert_allclose(got_aux[k].numpy(), np.asarray(want_aux[k]), atol=TILED_TOL)


def test_restore_tiled_chunks_draw_from_the_generator_in_turn():
    """Each chunk's batch gets the generator after the chunks before it."""
    from tair_tpu_torch import tiling as tt

    seen = []

    def fn(p, generator):
        seen.append(torch.rand((), generator=generator).item())
        return p

    img = torch.from_numpy(_image(58, 45))
    tt.restore_tiled(fn, img, torch.Generator().manual_seed(3), 16, 4, 4, chunk=3)
    want = torch.rand((len(seen),), generator=torch.Generator().manual_seed(3)).tolist()
    assert len(seen) == 7 and seen == want


# ---- the entry point ------------------------------------------------------

# the keys val_patches.py:159-173 writes per image
PATCHES_KEYS = {"step", "time", "image", "out_hw", "psnr", "ssim"}


def _config(tmp_path: Path, **val_fields) -> Path:
    text = (ROOT / "configs" / "val_smoke.yaml").read_text()
    text = text.replace("./assets", str(ROOT / "assets"))
    text = text.replace("./results/smoke", str(tmp_path / "out"))
    for key, value in val_fields.items():
        text = "\n".join(l for l in text.splitlines() if not l.strip().startswith(f"{key}:"))
        text += f"\n  {key}: {value}\n"
    path = tmp_path / "val.yaml"
    path.write_text(text)
    return path


@pytest.mark.parametrize("ocr_loop", [False, True], ids=["fixed_prompt", "spotter_in_loop"])
def test_val_patches_entry_point_writes_the_jax_scripts_files(tmp_path, ocr_loop):
    from tair_tpu_torch.utils.image_io import load_image
    from tair_tpu_torch.val_patches import main

    cfg = _config(tmp_path, tiled_ocr_loop=str(ocr_loop).lower())
    dump = tmp_path / "dump"
    main(["--config", str(cfg), "--device", "cpu", "--steps", "1",
          *(["--dump-dir", str(dump)] if ocr_loop else [])])
    out = tmp_path / "out"
    assert sorted(p.name for p in out.iterdir()) == [
        "restored_demo0.png", "restored_demo1.png", "val_patches_metrics.jsonl"]
    # 64 x 64 LQ, patch 16, overlap 4, x4: a 256 x 256 image of 25 patches
    for s in ("demo0", "demo1"):
        img = load_image(str(out / f"restored_{s}.png"))
        assert img.shape == (256, 256, 3) and np.isfinite(img).all()
    records = [json.loads(line) for line in
               (out / "val_patches_metrics.jsonl").read_text().splitlines()]
    assert [r["image"] for r in records] == ["demo0.png", "demo1.png"]
    for r in records:
        assert set(r) == PATCHES_KEYS and r["out_hw"] == [256, 256]
        assert 0 < r["psnr"] < 100 and -1 <= r["ssim"] <= 1
    if ocr_loop:
        assert sorted(p.name for p in dump.iterdir()) == ["det.zip", "text_results.json"]
        preds = json.loads((dump / "text_results.json").read_text())
        assert {p["image_id"] for p in preds} <= {1, 2}
        assert all(set(p) == {"image_id", "category_id", "polys", "rec", "score"} for p in preds)
        with zipfile.ZipFile(dump / "det.zip") as z:
            assert set(z.namelist()) <= {"0000001.txt", "0000002.txt"}


def test_val_patches_dump_needs_the_spotter_in_the_loop(tmp_path):
    from tair_tpu_torch.val_patches import main

    with pytest.raises(SystemExit, match="tiled_ocr_loop"):
        main(["--config", str(_config(tmp_path)), "--device", "cpu",
              "--dump-dir", str(tmp_path / "dump")])


def test_spots_to_image_preds_matches_jax():
    """The patches' decodes in canvas coordinates, deduplicated by polygon
    IoU, equal to the JAX script's on seeded decodes with overlapping copies."""
    import importlib.util

    from tair_tpu_torch.val_patches import _spots_to_image_preds

    spec = importlib.util.spec_from_file_location("jax_val_patches", ROOT / "val_patches.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    jax_fn = script._spots_to_image_preds

    rng = np.random.default_rng(4)
    n_patches, k, pts = 4, 6, 16
    base = rng.uniform(8, 40, (n_patches, k, 1, 2)) + rng.uniform(0, 20, (n_patches, k, pts, 2))
    base[1, :3] = base[0, :3] - np.array([48.0, 0.0])  # the same words seen by the next patch
    spots = {
        "scores": rng.random((n_patches, k)).astype(np.float32),
        "keep": rng.random((n_patches, k)) < 0.8,
        "polygons": base.astype(np.float32),
        "recs": rng.integers(0, 97, (n_patches, k, 25)),
    }
    got = _spots_to_image_preds(spots, 2, 16, 4, 4, (112, 112))
    want = jax_fn(spots, 2, 16, 4, 4, (112, 112))
    assert len(got) == len(want) and 0 < len(got) < spots["keep"].sum()
    for g, w_ in zip(got, want):
        assert g.text == w_.text and g.score == w_.score
        np.testing.assert_array_equal(g.polygon, w_.polygon)
