"""The port's config reader, checkpoints, weight exports and image metrics
against the JAX package's: every config file read and merged equal, the npz
weight layout loadable both ways, exact resume, PSNR/SSIM/wavelet fix."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tair_tpu import config as jax_config
from tair_tpu.train import checkpoint as jax_ckpt
from tair_tpu.utils import metrics as jax_metrics
from tair_tpu_torch import config as torch_config
from tair_tpu_torch.train import checkpoint as torch_ckpt
from tair_tpu_torch.utils import metrics as torch_metrics
from tair_tpu_torch.weights.convert import (
    BUNDLE_KEYS, from_jax_params, jax_param_shapes, to_jax_params,
)
from test_torch_common import _tiny_shapes, noise_params, t2n, torch_single_thread  # noqa: F401

CONFIGS = sorted((Path(__file__).resolve().parents[1] / "configs").glob("*.yaml"))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_config_reads_and_merges_equal_to_jax(path):
    text = path.read_text()
    assert torch_config.parse_yaml(text) == yaml.safe_load(text)
    ours, theirs = torch_config.load_config(str(path)), jax_config.load_config(str(path))
    for f in dataclasses.fields(theirs):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if dataclasses.is_dataclass(b):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(theirs)]


@pytest.mark.parametrize("text", [
    "a: 'it''s'\nb: \"x # y\"  # comment\nc: ~\nd: yes\ne: .5\nf:\ng: -3\nh: +1.5\n",
    "top:\n  mid:\n    leaf: [1, 2.5, x, null, true]\n  other: 1.0e-4\nlast: ./runs/x\n",
    "# only comments\n\n",
])
def test_subset_reads_as_pyyaml(text):
    assert torch_config.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: 1e-4", "a: 0x10", "a: 1_000", "a: 12:30", "a: .inf", "- x", "a: {b: 1}",
    "a: &x 1", "a: *x", "a:\tb", "a: b: c", "a: \"x\\ny\"", "---\na: 1", "a: [1, [2]]",
    "a: 1\n  b: 2", "a:\n    b: 1\n  c: 2", "a: |\n  text", "a: !!str 1", "a: 1\na: 2",
    "just text",
])
def test_reader_raises_outside_its_subset(text):
    with pytest.raises(torch_config.YAMLSubsetError):
        torch_config.parse_yaml(text)


def test_unknown_spotter_override_raises():
    """A TESTRConfig field the port lacks raises, for either preset, before
    any model is built; the JAX package's sequence-parallel axis, which the
    port now has, reaches the encoder layers."""
    for preset in ("default", "tiny"):
        cfg = torch_config.ExperimentConfig(
            model_preset=preset, testr_overrides={"enc_sp_mesh": "sp"})
        with pytest.raises(ValueError, match="enc_sp_mesh"):
            torch_config.build_model(cfg, device="cpu")
    cfg = torch_config.ExperimentConfig(model_preset="tiny",
                                        testr_overrides={"enc_sp_axis": "sp"})
    model = torch_config.build_model(cfg, device="cpu")
    assert model.testr.cfg.enc_sp_axis == "sp"
    assert model.testr.transformer.enc_0.sp_axis == "sp"


def _tiny(seed=0):
    from tair_tpu_torch.pipeline import build_tiny_model

    model = build_tiny_model(device="cpu", training=True)
    return model.init_parameters(torch.Generator().manual_seed(seed))


def _tiny_jax_shapes():
    return {part: _tiny_shapes(part) for part in BUNDLE_KEYS}


def test_jax_export_loads_into_the_port(tmp_path):
    params = noise_params(_tiny_jax_shapes(), 3)
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save_params(path, params)
    model = torch_ckpt.load_params(path, _tiny(1))
    want = from_jax_params(params)
    got = model.state_dict()
    assert set(want) <= set(got)
    for name, value in want.items():
        torch.testing.assert_close(got[name], value, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [None, np.float16])
def test_port_export_loads_into_jax(tmp_path, dtype):
    shapes = _tiny_jax_shapes()
    model = _tiny(2)
    sk = jax_param_shapes(model)
    flat_sk = {"/".join(k.key for k in p): tuple(v.shape) for p, v in
               jax.tree_util.tree_flatten_with_path(sk, is_leaf=lambda x: hasattr(x, "shape"))[0]}
    flat_jax = {"/".join(k.key for k in p): tuple(v.shape) for p, v in
                jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert flat_sk == flat_jax  # the port names every JAX leaf, with its shape

    path = str(tmp_path / "port.npz")
    torch_ckpt.save_params(path, model, dtype=dtype)
    loaded = jax_ckpt.load_params(path, shapes)  # ShapeDtypeStructs: no init is run
    want = to_jax_params(model.state_dict(), shapes)
    for (p, got), (_, ref) in zip(jax.tree_util.tree_flatten_with_path(loaded)[0],
                                  jax.tree_util.tree_flatten_with_path(want)[0]):
        ref = ref if dtype is None else ref.astype(dtype).astype(np.float32)
        assert got.dtype == np.float32, p
        np.testing.assert_array_equal(got, ref)

    back = torch_ckpt.load_params(path, _tiny(5)).state_dict()  # and back into the port
    for name, ref in model.state_dict().items():
        ref = ref if dtype is None else ref.half().float()
        torch.testing.assert_close(back[name], ref, rtol=0, atol=0, msg=name)


def _batch(seed):
    rng = np.random.default_rng(seed)
    b, s, m = 2, 64, 3
    tokens = rng.integers(1, 40000, (b, 77))
    tokens[:, 0] = 49406
    return {k: torch.from_numpy(v) for k, v in dict(
        gt=rng.random((b, s, s, 3), dtype=np.float32) * 2 - 1,
        lq=rng.random((b, s, s, 3), dtype=np.float32),
        tokens=tokens,
        inst_mask=np.broadcast_to(np.arange(m) < 2, (b, m)).copy(),
        boxes=np.concatenate([rng.uniform(0.2, 0.8, (b, m, 2)),
                              rng.uniform(0.05, 0.3, (b, m, 2))], -1).astype(np.float32),
        ctrl_points=rng.uniform(0.1, 0.9, (b, m, 16, 2)).astype(np.float32),
        texts=rng.integers(0, 97, (b, m, 25)),
    ).items()}


def _trainer(seed):
    from tair_tpu_torch.diffusion.diffusion import Diffusion
    from tair_tpu_torch.train.step import create_train_state, make_train_step

    model = _tiny(seed)
    state = create_train_state(model, "stage3", 1e-3)
    step = make_train_step(model, Diffusion(model.schedule), model.spotter_loss_fn(),
                           ocr_loss_weight=0.01)
    return state, step


def test_checkpoint_resume_is_exact(tmp_path):
    state, step = _trainer(0)
    gen = lambda i: torch.Generator().manual_seed(100 + i)  # noqa: E731
    state, _ = step(state, _batch(0), gen(0))
    ckpt = str(tmp_path / "ckpt")
    path = torch_ckpt.save_checkpoint(ckpt, state, state.step)
    assert torch_ckpt.save_checkpoint(ckpt, state, state.step) == path  # idempotent
    saved = torch_ckpt.state_checksums(state)
    state, aux_a = step(state, _batch(1), gen(1))

    fresh, step_b = _trainer(9)  # other initial values, overwritten by the restore
    assert torch_ckpt.latest_checkpoint(ckpt) == path
    torch_ckpt.restore_checkpoint(path, fresh)
    assert fresh.step == 1 and torch_ckpt.state_checksums(fresh) == saved
    fresh, aux_b = step_b(fresh, _batch(1), gen(1))
    assert fresh.step == state.step == 2
    assert {k: v.item() for k, v in aux_a.items()} == {k: v.item() for k, v in aux_b.items()}
    for (name, a), b in zip(state.model.named_parameters(), fresh.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    for pa, pb in zip(state.optimizer.param_groups[0]["params"],
                      fresh.optimizer.param_groups[0]["params"]):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(state.optimizer.state[pa][key],
                                       fresh.optimizer.state[pb][key], rtol=0, atol=0)


@pytest.mark.parametrize("hw", [(40, 36), (12, 12)])  # the second pads wider than the image
def test_image_metrics_match_jax(hw):
    rng = np.random.default_rng(4)
    a = rng.random((2, *hw, 3), dtype=np.float32)
    b = np.clip(a + 0.05 * rng.standard_normal(a.shape, dtype=np.float32), 0, 1)
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_allclose(t2n(torch_metrics.psnr(ta, tb)), jax_metrics.psnr(ja, jb), rtol=1e-5)
    np.testing.assert_allclose(t2n(torch_metrics.ssim(ta, tb)), jax_metrics.ssim(ja, jb),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(t2n(torch_metrics.wavelet_reconstruction(ta, tb)),
                               jax_metrics.wavelet_reconstruction(ja, jb), rtol=0, atol=1e-5)
