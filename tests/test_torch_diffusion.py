"""Port's training-time diffusion math against the JAX package's, on the
schedule the model bundle trains with; the noise of ``p_losses`` is drawn on
the JAX side from its key and handed to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tair_tpu.diffusion import Diffusion as JaxDiffusion
from tair_tpu.diffusion.schedules import DiffusionSchedule as JaxSchedule
from tair_tpu_torch.diffusion.diffusion import Diffusion
from tair_tpu_torch.diffusion.schedules import DiffusionSchedule
from test_torch_common import jax_fast_compiles, torch_single_thread  # noqa: F401

TOL = 1e-6  # float32 elementwise arithmetic on float32 buffers of one float64 schedule
KW = dict(timesteps=1000, beta_schedule="linear", linear_start=0.00085,
          linear_end=0.0120, zero_snr=True)
SHAPE = (3, 8, 8, 4)


def _pair(parameterization="v", loss_type="l2"):
    return (
        JaxDiffusion(JaxSchedule.create(**KW), parameterization, loss_type),
        Diffusion(DiffusionSchedule.create(**KW), parameterization, loss_type),
    )


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(SHAPE, dtype=np.float32)
    noise = rng.standard_normal(SHAPE, dtype=np.float32)
    t = np.array([0, 431, 999], np.int32)  # both ends of the schedule
    return x, noise, t


@pytest.mark.parametrize("fn", ["q_sample", "get_v", "pred_x_start_from_v", "target"])
def test_elementwise_functions_match(fn):
    jd, td = _pair()
    x, noise, t = _arrays()
    order = {"q_sample": (x, t, noise), "get_v": (x, noise, t),
             "pred_x_start_from_v": (x, t, noise), "target": (x, noise, t)}[fn]
    want = getattr(jd, fn)(*(jnp.asarray(a) for a in order))
    got = getattr(td, fn)(*(torch.from_numpy(a) for a in order))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_pred_x_start_from_eps_matches_away_from_the_zero_snr_end():
    jd, td = _pair("eps")
    x, noise, _ = _arrays(1)
    t = np.array([0, 431, 900], np.int32)  # at t=999 the division is by zero
    want = jd.pred_x_start_from_eps(*(jnp.asarray(a) for a in (x, t, noise)))
    got = td.pred_x_start_from_eps(*(torch.from_numpy(a) for a in (x, t, noise)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("parameterization,loss_type", [("v", "l2"), ("eps", "l1"), ("x0", "l2")])
def test_p_losses_match_with_the_noise_passed_in(parameterization, loss_type):
    jd, td = _pair(parameterization, loss_type)
    z_0, _, t = _arrays(2)
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(key, SHAPE, jnp.float32))
    w = np.random.default_rng(4).standard_normal((4, 4), dtype=np.float32)

    def jax_model(z_t, t_, cond):
        return jnp.tanh(z_t @ jnp.asarray(w)) * cond, ("feats", z_t)

    def torch_model(z_t, t_, cond):
        return torch.tanh(z_t @ torch.from_numpy(w)) * cond, ("feats", z_t)

    want, (_, zt_j) = jd.p_losses(jax_model, jnp.asarray(z_0), jnp.asarray(t), 0.7, key)
    got, (tag, zt_t) = td.p_losses(
        torch_model, torch.from_numpy(z_0), torch.from_numpy(t), 0.7,
        noise=torch.from_numpy(noise),
    )
    assert tag == "feats"
    np.testing.assert_allclose(zt_t.numpy(), np.asarray(zt_j), atol=TOL)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_p_losses_draws_its_noise_from_the_generator():
    _, td = _pair()
    z_0, _, t = _arrays(5)
    model = lambda z_t, t_, cond: (z_t, None)  # noqa: E731
    a = td.p_losses(model, torch.from_numpy(z_0), torch.from_numpy(t), None,
                    generator=torch.Generator().manual_seed(6))[0]
    b = td.p_losses(model, torch.from_numpy(z_0), torch.from_numpy(t), None,
                    generator=torch.Generator().manual_seed(6))[0]
    c = td.p_losses(model, torch.from_numpy(z_0), torch.from_numpy(t), None,
                    generator=torch.Generator().manual_seed(7))[0]
    assert float(a) == float(b) != float(c)


def test_unknown_parameterization_raises():
    with pytest.raises(ValueError):
        Diffusion(DiffusionSchedule.create(**KW), "score")
