"""Port's UNet and ControlNet against the JAX modules at the tiny geometry:
the output, all four decoder feature taps, the 13 control residuals, and the
controlled forward of ControlLDM. Every parameter is seeded noise, so the
zero convs, ``proj_out`` and ``out_conv`` carry signal."""

import jax
import numpy as np
import pytest
import torch

from test_torch_common import t2n, tiny_pair, torch_single_thread  # noqa: F401

TOL = 1e-4  # float32 on both sides, small widths; summation order only


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=11, parts=("unet", "controlnet"))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(12)
    return dict(
        x=rng.standard_normal((2, 8, 8, 4), dtype=np.float32),
        hint=rng.standard_normal((2, 8, 8, 4), dtype=np.float32),
        t=np.asarray([7, 981], np.int32),
        ctx=rng.standard_normal((2, 77, 64), dtype=np.float32),
    )


@pytest.fixture(scope="module")
def jax_outputs(pair, inputs):
    """(13 control residuals, eps, 4 taps) of the JAX ControlNet + UNet, one
    compile for the file. With unit control scales this is ControlLDM.apply."""
    jm, params, _ = pair

    def run(p, x, hint, t, ctx):
        control = jm.cldm.controlnet.apply({"params": p["controlnet"]}, x, hint, t, ctx)
        eps, feats = jm.cldm.unet.apply(
            {"params": p["unet"]}, x, t, ctx, control=control, extract_features=True
        )
        return control, eps, feats

    assert jm.cldm.control_scales == (1.0,) * 13
    return jax.jit(run)(
        params, inputs["x"], inputs["hint"], inputs["t"], inputs["ctx"]
    )


def test_controlnet_13_residuals(pair, inputs, jax_outputs):
    _, _, tm = pair
    control_j = jax_outputs[0]
    with torch.no_grad():
        got = tm.cldm.controlnet(
            *(torch.from_numpy(inputs[k]) for k in ("x", "hint", "t", "ctx"))
        )
    assert len(got) == len(control_j) == 13
    for g, w in zip(got, control_j):
        assert np.abs(np.asarray(w)).max() > 1e-3  # zero convs are live
        np.testing.assert_allclose(t2n(g), np.asarray(w), atol=TOL)


def test_unet_output_and_four_taps_with_control(pair, inputs, jax_outputs):
    _, _, tm = pair
    control_j, eps_j, feats_j = jax_outputs
    with torch.no_grad():
        eps_t, feats_t = tm.cldm.unet(
            torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["t"]),
            torch.from_numpy(inputs["ctx"]),
            control=[torch.from_numpy(np.array(c)) for c in control_j],
            extract_features=True,
        )
    assert np.abs(np.asarray(eps_j)).max() > 1e-3  # out_conv is live
    np.testing.assert_allclose(t2n(eps_t), np.asarray(eps_j), atol=TOL)
    assert len(feats_t) == len(feats_j) == 4
    assert [f.shape[-1] for f in feats_t] == [128, 128, 64, 32]
    for g, w in zip(feats_t, feats_j):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(t2n(g), np.asarray(w), atol=TOL)


def test_unet_without_control_or_taps(pair, inputs, jax_outputs):
    _, _, tm = pair
    with torch.no_grad():
        eps_t = tm.cldm.unet(
            torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["t"]),
            torch.from_numpy(inputs["ctx"]),
        )
    # eps only, of the right shape, and not what the controlled forward gives
    assert isinstance(eps_t, torch.Tensor) and tuple(eps_t.shape) == (2, 8, 8, 4)
    assert np.abs(t2n(eps_t) - np.asarray(jax_outputs[1])).max() > 1e-3


def test_cldm_apply_controlled_forward(pair, inputs, jax_outputs):
    _, _, tm = pair
    _, eps_j, feats_j = jax_outputs
    cond = dict(c_txt=inputs["ctx"], c_img=inputs["hint"])
    with torch.no_grad():
        out_t, feats_t = tm.cldm.apply(
            torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["t"]),
            {k: torch.from_numpy(v) for k, v in cond.items()},
        )
    np.testing.assert_allclose(t2n(out_t), np.asarray(eps_j), atol=TOL)
    for g, w in zip(feats_t, feats_j):
        np.testing.assert_allclose(t2n(g), np.asarray(w), atol=TOL)


def test_extract_idx_matches_jax():
    from tair_tpu.models.unet import UNetConfig as JaxCfg
    from tair_tpu_torch.models.unet import UNetConfig

    assert UNetConfig().extract_idx == JaxCfg().extract_idx == (2, 5, 8, 11)
