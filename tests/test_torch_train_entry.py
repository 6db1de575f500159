"""The port's trainer as a user starts it, on the CPU at the smoke config's
size, with a resume from its checkpoint; the sampler's feature capture against
the JAX sampler; the trainer's validation (NIQE and a learned metric against
the JAX trainer's ``_aux_val_metrics``) and its PNG panels."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tair_tpu.sampler.spaced import SpacedSampler as JaxSampler
from tair_tpu_torch.sampler.spaced import SpacedSampler
from test_torch_common import jax_fast_compiles, t2n, torch_single_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ROOT / "configs" / "train_smoke.yaml"


def _train(cwd, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "tair_tpu_torch.train", "--config", str(SMOKE), *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
    )


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_trainer_runs_checkpoints_and_resumes_on_the_cpu(tmp_path):
    first = _train(tmp_path, "--device", "cpu")
    assert first.returncode == 0, first.stderr[-3000:]
    exp = tmp_path / "runs" / "smoke"
    steps = _records(exp / "steps.jsonl")
    assert [r["step"] for r in steps] == [1, 2, 3]
    for r in steps:
        losses = [r[k] for k in ("loss_total", "loss_diffusion", "loss_ocr")]
        assert np.isfinite(losses).all()
        assert abs(r["loss_total"] - (r["loss_diffusion"] + 0.01 * r["loss_ocr"])) <= 1e-5 * abs(r["loss_total"])
        assert r["launches"] == {} and r["degrade_ms"] > 0  # no kernel runs on the CPU
    assert (exp / "checkpoints" / "step_00000003" / "state.pt").is_file()

    second = _train(tmp_path, "--device", "cpu", "--max-steps", "4")
    assert second.returncode == 0, second.stderr[-3000:]
    assert "at step 3" in second.stdout
    assert [r["step"] for r in _records(exp / "steps.jsonl")] == [1, 2, 3, 4]
    ckpt = [r for r in _records(exp / "metrics.jsonl") if any(k.startswith("checkpoint/") for k in r)]
    saved3 = next(r for r in ckpt if r["step"] == 3 and "checkpoint/write_seconds" in r)
    restored3 = next(r for r in ckpt if r["step"] == 3 and "checkpoint/read_seconds" in r)
    for key, value in saved3.items():
        if key.startswith("checkpoint/saved_"):
            assert restored3[key.replace("saved_", "restored_")] == value, key
    assert (exp / "checkpoints" / "step_00000004").is_dir()


def test_trainer_wants_a_card_unless_told_cpu():
    from tair_tpu_torch.train.__main__ import main

    if torch.cuda.is_available():  # decided inside the test, never at import
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--config", str(SMOKE)])


def _jax_stub(x, t, cond):
    s = t.astype(jnp.float32)[:, None, None, None] / 1000.0
    out = jnp.tanh(0.9 * x + cond["c"]) * (1.0 - s)
    return out, (x * 2.0 + s, jnp.mean(x, axis=(1, 2), keepdims=True) * s)


def _torch_stub(x, t, cond):
    s = t.float()[:, None, None, None] / 1000.0
    out = torch.tanh(0.9 * x + cond["c"]) * (1.0 - s)
    return out, (x * 2.0 + s, x.mean(dim=(1, 2), keepdim=True) * s)


def test_sample_with_feature_capture_matches_jax():
    from tair_tpu_torch.diffusion.schedules import DiffusionSchedule

    betas = DiffusionSchedule.create(timesteps=1000, beta_schedule="linear",
                                     linear_start=0.00085, linear_end=0.0120,
                                     zero_snr=True).betas
    steps, tags = 6, (2, 6, 4)
    rng = np.random.default_rng(0)
    x_T = rng.standard_normal((2, 4, 4, 3), dtype=np.float32)
    c = rng.standard_normal((2, 4, 4, 3), dtype=np.float32)
    key = jax.random.PRNGKey(7)
    x_j, feats_j = JaxSampler(training_betas=betas).sample(
        _jax_stub, steps, jnp.asarray(x_T), {"c": jnp.asarray(c)}, key, feat_iterations=tags)
    noises = [torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, i), x_T.shape)))
              for i in range(steps)]
    sampler = SpacedSampler(training_betas=betas)
    x_t, feats_t = sampler.sample(_torch_stub, steps, torch.from_numpy(x_T),
                                  {"c": torch.from_numpy(c)}, feat_iterations=tags,
                                  step_noises=noises)
    np.testing.assert_allclose(t2n(x_t), np.asarray(x_j), rtol=0, atol=1e-5)
    assert len(feats_t) == len(feats_j) == 2
    for ft, fj in zip(feats_t, feats_j):
        assert ft.shape == fj.shape and ft.shape[0] == len(tags)
        np.testing.assert_allclose(t2n(ft), np.asarray(fj), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="exceed"):
        sampler.sample(_torch_stub, steps, torch.from_numpy(x_T), {"c": torch.from_numpy(c)},
                       feat_iterations=(steps + 1,))


def _jax_aux_val_metrics():
    import train

    return train._aux_val_metrics


def _recording_aux_val_metrics(monkeypatch):
    """Record the (restored, gt01) arrays that run_validation scores."""
    from tair_tpu_torch.train import __main__ as trainer

    seen, real = [], trainer.aux_val_metrics

    def recording(cfg, restored, gt01, cache=None):
        seen.append((t2n(restored), t2n(gt01)))
        return real(cfg, restored, gt01, cache)

    monkeypatch.setattr(trainer, "aux_val_metrics", recording)
    return seen


def test_validation_on_the_tiny_model(tmp_path, monkeypatch):
    """PSNR, SSIM, the OCR losses, and NIQE (128 x 128 images, over its
    96-pixel floor) equal to the JAX trainer's ``_aux_val_metrics`` on the same
    restored and ground-truth arrays (both numpy in float64 on the same
    float32 values: within 1e-9 relative); no metric is reported skipped."""
    from PIL import Image

    from tair_tpu_torch.config import ExperimentConfig
    from tair_tpu_torch.pipeline import build_tiny_model
    from tair_tpu_torch.train.__main__ import run_validation

    model = build_tiny_model(device="cpu", training=True)
    model.init_parameters(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    b, m, s = 2, 3, 128
    lq = torch.from_numpy(rng.random((b, s, s, 3), dtype=np.float32))
    gt = lq * 2 - 1
    tokens = torch.zeros((b, 77), dtype=torch.long)
    tokens[:, 0], tokens[:, 1] = 49406, 49407
    targets = dict(
        inst_mask=torch.tensor([[True, True, False]] * b),
        boxes=torch.full((b, m, 4), 0.3),
        ctrl_points=torch.from_numpy(rng.uniform(0.1, 0.9, (b, m, 16, 2)).astype(np.float32)),
        texts=torch.from_numpy(rng.integers(0, 97, (b, m, 25))),
    )
    cfg = ExperimentConfig(dtype="float32")
    seen = _recording_aux_val_metrics(monkeypatch)
    metrics = run_validation(model, cfg, gt, lq, tokens, n_images=1, steps=2,
                             feat_iterations=(1, 2, 5), targets=targets,
                             image_dir=str(tmp_path / "val"))
    assert set(metrics) == {"psnr", "ssim", "niqe", "ocr_loss_iter1", "ocr_loss_iter2"}
    assert all(np.isfinite(v) for v in metrics.values()) and model.training
    (restored, gt01), = seen
    want = _jax_aux_val_metrics()(cfg, jnp.asarray(restored), jnp.asarray(gt01))
    assert set(want) == {"niqe"}
    assert metrics["niqe"] == pytest.approx(want["niqe"], rel=1e-9)
    panel = np.asarray(Image.open(tmp_path / "val" / "val_0.png"))
    assert panel.shape == (s, 3 * s, 3)
    np.testing.assert_array_equal(panel[:, :s], (t2n(lq[0]) * 255).astype(np.uint8))


def test_validation_reports_a_configured_learned_metric(tmp_path, monkeypatch):
    """``val.musiq_weights`` set: the trainer's validation reports MUSIQ, the
    mean over the batch, equal to the JAX trainer's ``_aux_val_metrics`` on the
    same arrays within 1e-5 + 1e-4 |score| (float32 on both sides), and builds
    the metric once for every validation that shares its cache."""
    from tair_tpu_torch.config import ExperimentConfig
    from tair_tpu_torch.pipeline import build_tiny_model
    from tair_tpu_torch.train.__main__ import run_validation
    from tair_tpu_torch.utils.musiq import MUSIQMetric
    from test_torch_common import iqa_checkpoints

    model = build_tiny_model(device="cpu", training=True)
    model.init_parameters(torch.Generator().manual_seed(0))
    lq = torch.from_numpy(np.random.default_rng(2).random((2, 64, 64, 3), dtype=np.float32))
    tokens = torch.zeros((2, 77), dtype=torch.long)
    tokens[:, 0], tokens[:, 1] = 49406, 49407
    cfg = ExperimentConfig(dtype="float32")
    cfg.val.musiq_weights = iqa_checkpoints(tmp_path, names=("musiq",))["musiq"]
    seen = _recording_aux_val_metrics(monkeypatch)
    cache = {}
    runs = [run_validation(model, cfg, lq * 2 - 1, lq, tokens, n_images=2, steps=1,
                           metric_cache=cache) for _ in range(2)]
    assert [set(r) for r in runs] == [{"psnr", "ssim", "musiq"}] * 2  # 64 pixels: no NIQE
    assert list(cache) == [("musiq", cfg.val.musiq_weights)]
    assert isinstance(cache[("musiq", cfg.val.musiq_weights)], MUSIQMetric)
    restored, gt01 = seen[0]
    assert restored.shape == (2, 64, 64, 3)
    want = _jax_aux_val_metrics()(cfg, jnp.asarray(restored), jnp.asarray(gt01))["musiq"]
    assert abs(runs[0]["musiq"] - want) <= 1e-5 + 1e-4 * abs(want)


@pytest.mark.parametrize("niqe_file", [False, True], ids=["fitted_on_gt", "niqe_params"])
def test_aux_val_metrics_niqe_equals_jax(tmp_path, niqe_file):
    """NIQE on 128 x 128 arrays (as tests/test_val_metrics.py calls the JAX
    function): against a model fitted on the batch's ground-truth rows, or
    the one ``val.niqe_params`` names; within 1e-9 relative."""
    import types

    from tair_tpu_torch.train.__main__ import aux_val_metrics
    from tair_tpu_torch.utils.niqe import fit_niqe_params

    rng = np.random.RandomState(3)
    gt = rng.rand(2, 128, 128, 3).astype(np.float32)
    restored = np.clip(gt + 0.25 * rng.randn(2, 128, 128, 3), 0, 1).astype(np.float32)
    path = None
    if niqe_file:
        path = str(tmp_path / "niqe.npz")
        fit_niqe_params([rng.rand(128, 128) * 255 for _ in range(2)], patch=32).save(path)
    cfg = types.SimpleNamespace(val=types.SimpleNamespace(
        niqe_params=path, lpips_weights=None, dists_weights=None, clipiqa_weights=None,
        maniqa_weights=None, musiq_weights=None))
    got = aux_val_metrics(cfg, torch.from_numpy(restored), torch.from_numpy(gt))
    want = _jax_aux_val_metrics()(cfg, jnp.asarray(restored), jnp.asarray(gt))
    assert set(got) == set(want) == {"niqe"}
    assert got["niqe"] == pytest.approx(want["niqe"], rel=1e-9)
    assert aux_val_metrics(cfg, torch.from_numpy(restored[:, :95]), torch.from_numpy(gt)) == {}


def test_launch_counts_name_every_wrapper_and_reset():
    from tair_tpu_torch.ops import flash_attention, msda_reduce
    from tair_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from tair_tpu_torch.probes import stream

    flash_attention.launches["dq_tc"] += 2
    msda_reduce.launches["bwd"] += 1
    stream.launches["bulk"] += 3
    counts = launch_counts()
    assert (counts["flash_attention_dq_tc"], counts["msda_corner_reduce_bwd"],
            counts["probe_stream_bulk"]) == (2, 1, 3)
    assert {k.split("_")[0] for k in counts} == {"flash", "msda", "patchify", "w8a8", "jv", "probe"}
    reset_launch_counts()
    assert set(launch_counts().values()) == {0}
