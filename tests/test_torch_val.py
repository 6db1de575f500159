"""Serving entry points of the port against the JAX package, on the tiny model.

- ``restore_with_ocr_feedback`` (the host-feedback loop of ``val``'s default
  path) at batch 2, 3 steps, ``score_threshold=0.0`` so that words are kept
  and every prompt is real, for CAPTION and TAG prompts: every step's
  predicted texts and prompt equal, the tokens of each prompt equal, the
  polygons within 64e-3 pixels (the spotter's float32 control points times
  the 64-pixel image, as in test_torch_pipeline.py), the image within 1e-3.
- ``restore_fused_feedback`` at batch 2 (the patch batches of
  ``val_patches``): the same tolerances.
- ``python -m tair_tpu_torch.val`` in process on the CPU, both modes: the
  files and metric keys of the JAX script (``val.py:185-220``), each learned
  IQA metric scored from an exported checkpoint equal to the JAX metric on the
  same restored image, a weight export written by the JAX package's
  ``save_params`` loaded by ``--ckpt``, and the configs the port refuses.

x_T and the step noises of the parity tests are drawn from the JAX keys and
handed to the port.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import (  # noqa: F401
    compiling, iqa_checkpoints, jax_fast_compiles, t2n, tiny_pair, torch_single_thread,
)

ROOT = Path(__file__).resolve().parents[1]
STEPS = 3
BATCH = 2
POLY_ATOL = 64e-3
IMAGE_ATOL = 1e-3


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=71)


@pytest.fixture(scope="module")
def lq():
    return np.random.default_rng(72).random((BATCH, 64, 64, 3), dtype=np.float32)


def _jax_noises(rng, shape):
    k_noise, k_chain = jax.random.split(rng)
    x_T = np.array(jax.random.normal(k_noise, shape, jnp.float32))
    noises = [
        np.array(jax.random.normal(jax.random.fold_in(k_chain, i), shape, jnp.float32))
        for i in range(STEPS)
    ]
    return torch.from_numpy(x_T), [torch.from_numpy(n) for n in noises]


@pytest.fixture(scope="module")
def fused_program(pair, lq):
    """(its key, the JAX fused restore loop at batch two compiling in a
    thread): traced before the host-feedback loops run, and compiled while
    they do."""
    jm, params, _ = pair
    rng = jax.random.PRNGKey(75)
    lowered = jax.jit(
        lambda p, x, r: jm.restore_fused_feedback(
            p, x, r, steps=STEPS, score_threshold=0.0, return_spots=True
        )
    ).lower(params, lq, rng)
    return rng, compiling({"fused": lowered})["fused"]


@pytest.fixture(scope="module")
def feedback_runs(pair, lq, fused_program):
    """(JAX, port) results of the host-feedback loop for each prompt style."""
    jm, params, tm = pair
    rng = jax.random.PRNGKey(73)
    x_T, noises = _jax_noises(rng, (BATCH, 8, 8, 4))
    runs = {}
    for style in ("CAPTION", "TAG"):
        want = jm.restore_with_ocr_feedback(
            params, jnp.asarray(lq), rng, steps=STEPS, prompt_style=style, score_threshold=0.0
        )
        got = tm.restore_with_ocr_feedback(
            torch.from_numpy(lq), steps=STEPS, prompt_style=style, score_threshold=0.0,
            x_T=x_T, step_noises=noises,
        )
        runs[style] = (want, got)
    return runs


@pytest.mark.parametrize("style", ["CAPTION", "TAG"])
def test_feedback_loop_steps_match(feedback_runs, style):
    from tair_tpu.models.tokenizer import tokenize as jax_tokenize
    from tair_tpu_torch.models.tokenizer import tokenize

    (_, ts_j), (_, ts_t) = feedback_runs[style]
    assert len(ts_t) == len(ts_j) == STEPS
    words = 0
    for step_j, step_t in zip(ts_j, ts_t):
        assert len(step_t) == BATCH
        for info_j, info_t in zip(step_j, step_t):
            assert set(info_t) == {"timestep", "pred_texts", "pred_prompt", "pred_polys", "scores"}
            assert info_t["timestep"] == info_j["timestep"]
            assert info_t["pred_texts"] == info_j["pred_texts"]
            assert info_t["pred_prompt"] == info_j["pred_prompt"]
            np.testing.assert_array_equal(
                tokenize(info_t["pred_prompt"]), jax_tokenize(info_j["pred_prompt"]))
            assert info_t["pred_polys"].dtype == np.int32
            assert info_t["pred_polys"].shape == info_j["pred_polys"].shape
            np.testing.assert_array_equal(info_t["pred_polys"], info_j["pred_polys"])
            np.testing.assert_allclose(info_t["scores"], info_j["scores"], atol=1e-3)
            words += len(info_t["pred_texts"])
    # the prompts carried words: threshold 0 keeps every proposal
    assert words > 0


@pytest.mark.parametrize("style", ["CAPTION", "TAG"])
def test_feedback_loop_image_matches(feedback_runs, style):
    (img_j, _), (img_t, _) = feedback_runs[style]
    assert tuple(img_t.shape) == (BATCH, 64, 64, 3)
    assert 0.0 <= float(img_t.min()) and float(img_t.max()) <= 1.0
    np.testing.assert_allclose(t2n(img_t), np.asarray(img_j), atol=IMAGE_ATOL)


def test_feedback_polygons_before_truncation(pair, lq):
    """The float polygons of a spotter pass on the loop's features, held at
    64e-3 (the int32 pred_polys truncate them)."""
    from tair_tpu.spotter.testr import spotter_inference as jax_inference
    from tair_tpu_torch.spotter.testr import spotter_inference

    jm, params, tm = pair
    feats = [np.random.default_rng(74 + i).standard_normal((BATCH, s, s, c), dtype=np.float32)
             for i, (s, c) in enumerate(((2, 128), (4, 128), (8, 64), (8, 32)))]
    want = jax.jit(lambda p, f: jax_inference(jm.spotter_apply(p, f), 0.0, image_size=64))(
        params, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = spotter_inference(tm.spotter_apply([torch.from_numpy(f) for f in feats]), 0.0,
                                image_size=64)
    np.testing.assert_allclose(t2n(got["polygons"]), np.asarray(want["polygons"]), atol=POLY_ATOL)


@pytest.fixture(scope="module")
def fused_runs(pair, lq, fused_program):
    jm, params, tm = pair
    rng, program = fused_program
    want = program.result()(params, lq, rng)
    x_T, noises = _jax_noises(rng, (BATCH, 8, 8, 4))
    got = tm.restore_fused_feedback(
        torch.from_numpy(lq), steps=STEPS, score_threshold=0.0, return_spots=True,
        x_T=x_T, step_noises=noises,
    )
    return want, got


def test_fused_loop_at_batch_two_matches(fused_runs):
    (img_j, tok_j, sp_j), (img_t, tok_t, sp_t) = fused_runs
    assert tuple(img_t.shape) == (BATCH, 64, 64, 3)
    np.testing.assert_allclose(t2n(img_t), np.asarray(img_j), atol=IMAGE_ATOL)
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    assert int((tok_t != 0).sum()) > 2 * BATCH  # words were spliced into both prompts
    np.testing.assert_array_equal(sp_t["keep"].numpy(), np.asarray(sp_j["keep"]))
    np.testing.assert_array_equal(sp_t["recs"].numpy(), np.asarray(sp_j["recs"]))
    np.testing.assert_allclose(t2n(sp_t["scores"]), np.asarray(sp_j["scores"]), atol=1e-3)
    np.testing.assert_allclose(t2n(sp_t["polygons"]), np.asarray(sp_j["polygons"]), atol=POLY_ATOL)


def test_feedback_loop_draws_from_the_generator(pair, lq):
    _, _, tm = pair
    x = torch.from_numpy(lq[:1])
    runs = [
        tm.restore_with_ocr_feedback(x, torch.Generator().manual_seed(s), steps=2,
                                     prompt_style="TAG", score_threshold=0.0)[0]
        for s in (5, 5, 6)
    ]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    with pytest.raises(ValueError):
        tm.restore_with_ocr_feedback(x, prompt_style="PLAIN")


def test_long_captions_truncate_with_eot_last():
    """A caption of many words passes 77 tokens: both tokenizers cut it with
    the end token in the last slot."""
    from tair_tpu.data.satext import make_caption as jax_caption
    from tair_tpu.models.tokenizer import tokenize as jax_tokenize
    from tair_tpu_torch.data.satext import make_caption
    from tair_tpu_torch.models.tokenizer import tokenize

    words = ["~I*z}6~_II>~i~~~IvB*6e~Iy", "WORD", "3@BB$'~_IVBVx"] * 6
    caption = make_caption(words)
    assert caption == jax_caption(words)
    tok = tokenize(caption)
    np.testing.assert_array_equal(tok, jax_tokenize(caption))
    assert tok[0, -1] == 49407 and (tok[0] != 0).all()


def test_clip_encode_and_prepare_condition(pair):
    jm, params, tm = pair
    img = np.random.default_rng(76).random((1, 64, 64, 3), dtype=np.float32)
    want = jax.jit(lambda p, x: jm.cldm.prepare_condition(p, x, ["a sign"]))(
        params, jnp.asarray(img))
    with torch.no_grad():
        got = tm.cldm.prepare_condition(torch.from_numpy(img), ["a sign"])
    np.testing.assert_allclose(t2n(got["c_txt"]), np.asarray(want["c_txt"]), atol=1e-4)
    np.testing.assert_allclose(t2n(got["c_img"]), np.asarray(want["c_img"]), atol=1e-4)


# ---- the entry point ------------------------------------------------------

# the keys val.py:185-220 writes per image without learned-metric weights
VAL_KEYS = {"step", "time", "image", "pred_texts", "psnr", "ssim"}


def _config(tmp_path: Path, **val_fields) -> Path:
    """configs/val_smoke.yaml with absolute image paths and an output
    directory under tmp_path, plus `val_fields`."""
    text = (ROOT / "configs" / "val_smoke.yaml").read_text()
    text = text.replace("./assets", str(ROOT / "assets"))
    text = text.replace("./results/smoke", str(tmp_path / "out"))
    for key, value in val_fields.items():
        text += f"  {key}: {value}\n"
    path = tmp_path / "val.yaml"
    path.write_text(text)
    return path


@pytest.mark.parametrize("fused", [False, True], ids=["caption_feedback", "fused"])
def test_val_entry_point_writes_the_jax_scripts_files(tmp_path, fused):
    from tair_tpu_torch.utils.image_io import load_image
    from tair_tpu_torch.val import main

    cfg = _config(tmp_path)
    main(["--config", str(cfg), "--device", "cpu", "--steps", "2",
          "--image-size", "64", *(["--fused"] if fused else [])])
    out = tmp_path / "out"
    stems = ["demo0", "demo1"]
    assert sorted(p.name for p in out.iterdir()) == sorted(
        [f"restored_{s}.png" for s in stems] + [f"pred_texts_{s}.png" for s in stems]
        + ["val_metrics.jsonl"])
    for s in stems:
        for kind in ("restored", "pred_texts"):
            img = load_image(str(out / f"{kind}_{s}.png"))
            assert img.shape == (64, 64, 3) and np.isfinite(img).all()
    records = [json.loads(line) for line in (out / "val_metrics.jsonl").read_text().splitlines()]
    assert [r["image"] for r in records] == ["demo0.png", "demo1.png"]
    for r in records:
        assert set(r) == VAL_KEYS
        assert 0 < r["psnr"] < 100 and -1 <= r["ssim"] <= 1
        assert all(isinstance(t, str) for t in r["pred_texts"])


def test_val_loads_a_jax_weight_export(tmp_path, pair):
    """--ckpt reads an npz that the JAX package's save_params wrote: the
    model then holds the exported weights."""
    from tair_tpu.train.checkpoint import save_params as jax_save_params
    from tair_tpu_torch.config import load_config
    from tair_tpu_torch.val import load_model

    _, params, tm = pair
    path = tmp_path / "params.npz"
    jax_save_params(str(path), params)
    model = load_model(load_config(str(_config(tmp_path))), torch.device("cpu"), str(path))
    state, want = model.state_dict(), tm.state_dict()
    assert set(state) == set(want)
    for k in want:
        torch.testing.assert_close(state[k], want[k], rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="orbax"):
        load_model(load_config(str(_config(tmp_path))), torch.device("cpu"), str(tmp_path))


@pytest.fixture(scope="module")
def iqa_weights(tmp_path_factory):
    return iqa_checkpoints(tmp_path_factory.mktemp("iqa"))


def jax_metric(name: str, entry: str):
    """The JAX package's metric `name` read from its val.<name>_weights entry,
    as val.py:104-126 reads it."""
    from tair_tpu.utils import clipiqa, dists, lpips, maniqa, musiq

    cls = {"lpips": lpips.LPIPSMetric, "dists": dists.DISTSMetric,
           "clipiqa": clipiqa.CLIPIQAMetric, "maniqa": maniqa.MANIQAMetric,
           "musiq": musiq.MUSIQMetric}[name]
    return cls.from_torch(*entry.split(":"))


@pytest.mark.parametrize("metric", ["lpips", "dists", "clipiqa", "maniqa", "musiq"])
def test_val_scores_learned_metric(tmp_path, iqa_weights, metric, monkeypatch):
    """val.<metric>_weights (an exported checkpoint in the published layout;
    two joined by ':' for LPIPS and DISTS) adds the metric to each image's
    line under the JAX name: the port's score of the restored image (against
    the ground truth for LPIPS and DISTS), equal to the JAX metric's on the
    same arrays within 1e-5 + 1e-4 |score| (float32 on both sides; the seeded
    MANIQA, 10 ViT blocks and 8 Swin blocks deep, scores about 120, and the
    JAX package's own MANIQA parity test holds at rtol 1e-4)."""
    from tair_tpu_torch.utils import iqa
    from tair_tpu_torch.val import main

    seen, real = [], iqa.score

    def recording(m, name, restored, reference=None):
        seen.append((t2n(restored), None if reference is None else t2n(reference)))
        return real(m, name, restored, reference)

    monkeypatch.setattr(iqa, "score", recording)
    cfg = _config(tmp_path, **{f"{metric}_weights": iqa_weights[metric]})
    main(["--config", str(cfg), "--device", "cpu", "--steps", "1", "--image-size", "64", "--fused"])
    records = [json.loads(line) for line in
               (tmp_path / "out" / "val_metrics.jsonl").read_text().splitlines()]
    assert len(records) == len(seen) == 2
    assert all(set(r) == VAL_KEYS | {metric} for r in records)
    want_metric = jax_metric(metric, iqa_weights[metric])
    for r, (restored, reference) in zip(records, seen):
        assert restored.shape == (1, 64, 64, 3)
        args = (restored,) if reference is None else (restored, reference)
        want = float(want_metric(*(jnp.asarray(a) for a in args))[0])
        assert np.isfinite(r[metric]) and abs(r[metric] - want) <= 1e-5 + 1e-4 * abs(want), \
            (r[metric], want)


def test_val_learned_metric_weights_must_exist(tmp_path):
    """A weights file that is not there raises as JAX's torch.load does, before
    any image is restored."""
    from tair_tpu_torch.val import main

    cfg = _config(tmp_path, clipiqa_weights=str(tmp_path / "missing.pt"))
    with pytest.raises(FileNotFoundError, match="missing.pt"):
        main(["--config", str(cfg), "--device", "cpu"])
    assert not (tmp_path / "out" / "val_metrics.jsonl").exists() or \
        not (tmp_path / "out" / "val_metrics.jsonl").read_text()


def test_val_refuses_enc_topk(tmp_path):
    """A negative --enc-topk is refused (0 is the exact path, a positive value
    the sparse update: tests/test_torch_sparse_encoder.py serves with both)."""
    from tair_tpu_torch.val import main

    with pytest.raises(ValueError, match="enc_topk"):
        main(["--config", str(_config(tmp_path)), "--device", "cpu", "--enc-topk", "-64"])


def test_val_niqe_when_configured(tmp_path):
    """val.niqe_params adds NIQE to each image's metrics (parameters fitted
    here on two seeded images)."""
    from tair_tpu_torch.utils.niqe import fit_niqe_params
    from tair_tpu_torch.val import main

    rng = np.random.default_rng(77)
    params = fit_niqe_params([rng.random((96, 96)) * 255 for _ in range(2)], patch=32)
    path = tmp_path / "niqe.npz"
    params.save(str(path))
    cfg = _config(tmp_path, niqe_params=str(path))
    # NIQE's default 96-pixel patch needs a restored image of 96 pixels or more
    main(["--config", str(cfg), "--device", "cpu", "--steps", "1", "--image-size", "128", "--fused"])
    records = [json.loads(line) for line in
               (tmp_path / "out" / "val_metrics.jsonl").read_text().splitlines()]
    assert all(set(r) == VAL_KEYS | {"niqe"} and np.isfinite(r["niqe"]) for r in records)


# ---- image files and the overlay -------------------------------------------

def _png(pixels: np.ndarray, colour: int, filters) -> bytes:
    """An 8-bit PNG of `pixels` [H, W, C] whose row y uses filter
    filters[y % len(filters)]."""
    import struct
    import zlib

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    h, w, c = pixels.shape
    rows = pixels.reshape(h, w * c).astype(np.int64)
    raw = bytearray()
    for y in range(h):
        ftype = filters[y % len(filters)]
        cur, up = rows[y], rows[y - 1] if y else np.zeros(w * c, np.int64)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = up
        elif ftype == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        raw += bytes([ftype]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("colour,channels", [(0, 1), (2, 3), (4, 2), (6, 4)],
                         ids=["grey", "rgb", "grey_alpha", "rgba"])
def test_png_reader_decodes_every_filter_like_pil(tmp_path, colour, channels):
    import io

    from PIL import Image

    from tair_tpu_torch.utils.image_io import read_png

    pixels = np.random.default_rng(colour).integers(0, 256, (13, 11, channels), dtype=np.uint8)
    data = _png(pixels, colour, filters=(0, 1, 2, 3, 4))
    got = read_png(data)
    np.testing.assert_array_equal(got, pixels)
    want = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(got.reshape(want.shape), want)


def test_load_and_save_image_equal_the_jax_scripts(tmp_path):
    """load_image and save_image against val.py's PIL helpers: PNGs that PIL
    wrote (adaptive filters), a JPEG, and a resize to another size."""
    import importlib.util

    from PIL import Image

    from tair_tpu_torch.utils.image_io import list_images, load_image, save_image

    spec = importlib.util.spec_from_file_location("jax_val", ROOT / "val.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    rng = np.random.default_rng(78)
    smooth = np.cumsum(rng.integers(0, 3, (40, 30, 3)), axis=1).astype(np.uint8)
    Image.fromarray(smooth).save(tmp_path / "a.png")
    Image.fromarray(smooth).convert("RGBA").save(tmp_path / "b.png")
    Image.fromarray(smooth[..., 0]).save(tmp_path / "c.png")
    Image.fromarray(smooth).save(tmp_path / "d.jpg", quality=90)
    (tmp_path / "notes.txt").write_text("not an image")
    names = list_images(str(tmp_path))
    assert names == script.list_images(str(tmp_path)) == ["a.png", "b.png", "c.png", "d.jpg"]
    for name in names:
        for size in (None, 24):
            got = load_image(str(tmp_path / name), size)
            want = script.load_image(str(tmp_path / name), size)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    img = rng.random((20, 17, 3), dtype=np.float32) * 1.2 - 0.1
    save_image(str(tmp_path / "port.png"), img)
    script.save_image(str(tmp_path / "jax.png"), img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.png")),
                                  np.asarray(Image.open(tmp_path / "jax.png")))


def test_overlay_equals_jax_visualizer():
    from tair_tpu.utils.visualizer import TextVisualizer as JaxVisualizer
    from tair_tpu.utils.visualizer import text_panel as jax_panel
    from tair_tpu_torch.utils.visualizer import TextVisualizer, text_panel

    rng = np.random.default_rng(79)
    image = rng.random((64, 64, 3), dtype=np.float32)
    result = {
        "pred_texts": ["OPEN", "EXIT", ""],
        "pred_polys": rng.integers(0, 64, (3, 16, 2)).astype(np.int32),
        "scores": rng.random(3).astype(np.float32),
    }
    np.testing.assert_array_equal(TextVisualizer().draw_spotter_output(image, result),
                                  JaxVisualizer().draw_spotter_output(image, result))
    np.testing.assert_array_equal(text_panel(["a", "bc"], (32, 48)), jax_panel(["a", "bc"], (32, 48)))
