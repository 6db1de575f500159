"""Port's schedules and spaced sampler against the JAX package: buffers to
1e-7, and one ancestral step given the same model output and the same noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tair_tpu.diffusion import schedules as js
from tair_tpu.sampler.spaced import SpacedSampler as JaxSampler
from tair_tpu_torch.diffusion import schedules as ts
from tair_tpu_torch.sampler.spaced import SpacedSampler
from test_torch_common import jax_fast_compiles, torch_single_thread  # noqa: F401

BUFFERS = (
    "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
    "sqrt_recipm1_alphas_cumprod", "posterior_variance", "posterior_log_variance_clipped",
    "posterior_mean_coef1", "posterior_mean_coef2",
)


def _betas(mod):
    return mod.DiffusionSchedule.create(
        timesteps=1000, beta_schedule="linear", linear_start=0.00085,
        linear_end=0.0120, zero_snr=True,
    ).betas


def test_training_schedule_matches():
    np.testing.assert_allclose(_betas(ts), _betas(js), atol=1e-7, rtol=0)
    for name in ("linear", "cosine", "sqrt_linear", "sqrt"):
        np.testing.assert_allclose(
            ts.make_beta_schedule(name, 100), js.make_beta_schedule(name, 100),
            atol=1e-7, rtol=0,
        )
    assert ts.space_timesteps(1000, "50") == js.space_timesteps(1000, "50")
    assert ts.space_timesteps(1000, "ddim50") == js.space_timesteps(1000, "ddim50")


@pytest.mark.parametrize("steps", [3, 50])
def test_spaced_schedule_buffers_match(steps):
    a = ts.SpacedSchedule.create(_betas(ts), steps)
    b = js.SpacedSchedule.create(_betas(js), steps)
    np.testing.assert_array_equal(a.timesteps, b.timesteps)
    assert a.num_steps == b.num_steps == steps
    for name in BUFFERS:
        with np.errstate(invalid="ignore"):
            np.testing.assert_allclose(
                getattr(a, name), getattr(b, name), atol=1e-7, rtol=0, err_msg=name
            )


@pytest.mark.parametrize("step_idx", [0, 1, 49])
def test_p_sample_same_model_output_same_noise(step_idx):
    rng = np.random.default_rng(41 + step_idx)
    x = rng.standard_normal((2, 8, 8, 4), dtype=np.float32)
    v = rng.standard_normal((2, 8, 8, 4), dtype=np.float32)
    key = jax.random.PRNGKey(step_idx)
    noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    seen = {}

    def jax_model(x_, t_, cond):
        seen["jax_t"] = np.asarray(t_)
        return jnp.asarray(v), ("feats",)

    def torch_model(x_, t_, cond):
        seen["torch_t"] = t_.numpy()
        return torch.from_numpy(v), ("feats",)

    jsamp = JaxSampler(training_betas=_betas(js), parameterization="v")
    tsamp = SpacedSampler(training_betas=_betas(ts), parameterization="v")
    want, _ = jsamp.p_sample(
        jax_model, jsamp.make_schedule(50), jnp.asarray(x), step_idx, {}, None, 1.0, key
    )
    got, feats = tsamp.p_sample(
        torch_model, tsamp.make_schedule(50), torch.from_numpy(x), step_idx, {},
        noise=torch.from_numpy(noise.copy()),
    )
    assert feats == ("feats",)
    np.testing.assert_array_equal(seen["torch_t"], seen["jax_t"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_predict_x0_and_posterior_match():
    rng = np.random.default_rng(44)
    x = rng.standard_normal((1, 4, 4, 4), dtype=np.float32)
    v = rng.standard_normal((1, 4, 4, 4), dtype=np.float32)
    jsamp = JaxSampler(training_betas=_betas(js))
    tsamp = SpacedSampler(training_betas=_betas(ts))
    jsp, tsp = jsamp.make_schedule(50), tsamp.make_schedule(50)
    for idx in (0, 17, 49):
        t_idx = jnp.full((1,), idx, jnp.int32)
        x0_j = jsamp.predict_x0(jsp, jnp.asarray(x), t_idx, jnp.asarray(v))
        x0_t = tsamp.predict_x0(tsp, torch.from_numpy(x), idx, torch.from_numpy(v))
        np.testing.assert_allclose(x0_t.numpy(), np.asarray(x0_j), atol=1e-6)
        mean_j, var_j = jsamp.q_posterior(jsp, x0_j, jnp.asarray(x), t_idx)
        mean_t, var_t = tsamp.q_posterior(tsp, x0_t, torch.from_numpy(x), idx)
        np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), atol=1e-6)
        np.testing.assert_allclose(var_t, float(np.asarray(var_j).ravel()[0]), atol=1e-7)


def test_p_sample_draws_from_generator_and_guidance_raises():
    """The step's noise comes from the generator; classifier-free guidance,
    which raised before the port had it, now mixes the two branches as JAX's
    ``apply_model`` does (the name is kept from then)."""
    tsamp = SpacedSampler(training_betas=_betas(ts))
    sp = tsamp.make_schedule(5)
    x = torch.zeros(1, 4, 4, 4)

    def model(x_, t_, cond):
        return torch.zeros_like(x_), ()

    a, _ = tsamp.p_sample(model, sp, x, 3, {}, generator=torch.Generator().manual_seed(1))
    b, _ = tsamp.p_sample(model, sp, x, 3, {}, generator=torch.Generator().manual_seed(1))
    c, _ = tsamp.p_sample(model, sp, x, 3, {}, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # classifier-free guidance: the mix of JAX's apply_model, the features of
    # the conditional branch, bfloat16 outputs mixed in float32
    rng = np.random.default_rng(45)
    xs = rng.standard_normal((2, 4, 4, 4), dtype=np.float32)
    outs = {k: rng.standard_normal((2, 4, 4, 4), dtype=np.float32) for k in ("c", "u")}

    def jax_model(x_, t_, cond):
        return jnp.asarray(outs[cond]).astype(jnp.bfloat16), (cond,)

    def torch_model(x_, t_, cond):
        return torch.from_numpy(outs[cond]).to(torch.bfloat16), (cond,)

    for rescale in (False, True):
        jsamp = JaxSampler(training_betas=_betas(js), rescale_cfg=rescale)
        tsamp = SpacedSampler(training_betas=_betas(ts), rescale_cfg=rescale)
        t = jnp.full((2,), 601, jnp.int32)
        want, wf = jsamp.apply_model(jax_model, jnp.asarray(xs), t, "c", "u", 3.0)
        got, gf = tsamp.apply_model(torch_model, torch.from_numpy(xs),
                                    torch.full((2,), 601, dtype=torch.int32), "c", "u", 3.0)
        assert wf == gf == ("c",) and got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
