"""The port's samplers against the JAX package on an analytic model (no
network): DDIM (eta 0 and > 0), DPM-Solver++ multistep and singlestep at
orders 1-3, the five EDM solvers and the spaced sampler, with and without
classifier-free guidance. The model is linear in x and its conditional and
unconditional outputs differ, so a wrong mix, scale or timestep shows. The JAX
noises (``fold_in(key, i)``) are handed to the port. Timesteps (recorded as the
model sees them), schedules and sigma tables must be equal; outputs within
1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tair_tpu.diffusion import schedules as js
from tair_tpu.sampler import ddim as j_ddim
from tair_tpu.sampler import dpm as j_dpm
from tair_tpu.sampler import edm as j_edm
from tair_tpu.sampler.spaced import SpacedSampler as JSpaced
from tair_tpu_torch.sampler import ddim as t_ddim
from tair_tpu_torch.sampler import dpm as t_dpm
from tair_tpu_torch.sampler import edm as t_edm
from tair_tpu_torch.sampler.spaced import SpacedSampler as TSpaced
from test_torch_common import jax_fast_compiles, torch_single_thread  # noqa: F401

SHAPE = (2, 4, 4, 3)
STEPS = 4
TOL = 1e-5
BETAS = js.DiffusionSchedule.create(
    timesteps=1000, beta_schedule="linear", linear_start=0.00085, linear_end=0.0120,
    zero_snr=True,
).betas
SAC = np.sqrt(np.cumprod(1.0 - BETAS)).astype(np.float32)
S1M = np.sqrt(1.0 - SAC * SAC)


def _conds():
    rng = np.random.default_rng(5)
    c = rng.standard_normal(SHAPE, dtype=np.float32)
    u = rng.standard_normal(SHAPE, dtype=np.float32)
    x_T = rng.standard_normal(SHAPE, dtype=np.float32)
    return c, u, x_T


def _models():
    """(jax model_fn, torch model_fn, timesteps the JAX one saw, the torch one's).
    The v-prediction of a model that knows x0 = cond["c"] / 2, plus 0.1 * a_t *
    x: its data prediction stays of order 1, so 1e-5 is a float32 tolerance."""
    seen_j, seen_t = [], []
    sac_j, sac_t = jnp.asarray(SAC), torch.from_numpy(SAC)
    s1m_j, s1m_t = jnp.asarray(S1M), torch.from_numpy(S1M)

    def jax_model(x, t, cond):
        jax.debug.callback(lambda tt: seen_j.append(int(np.asarray(tt)[0])), t, ordered=True)
        a, b = sac_j[t].reshape(-1, 1, 1, 1), s1m_j[t].reshape(-1, 1, 1, 1)
        x0 = 0.5 * cond["c"]
        return a * (x - a * x0) / jnp.maximum(b, 1e-8) - b * x0 + 0.1 * a * x, ()

    def torch_model(x, t, cond):
        seen_t.append(int(t[0]))
        a, b = sac_t[t.long()].reshape(-1, 1, 1, 1), s1m_t[t.long()].reshape(-1, 1, 1, 1)
        x0 = 0.5 * cond["c"]
        return a * (x - a * x0) / b.clamp(min=1e-8) - b * x0 + 0.1 * a * x, ()

    return jax_model, torch_model, seen_j, seen_t


def _noises(key, n):
    return [torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, i), SHAPE,
                                                        jnp.float32)))
            for i in range(n)]


def _run_both(jax_sampler, torch_sampler, cfg_scale, noises=False, **kw):
    c, u, x_T = _conds()
    jm, tm, seen_j, seen_t = _models()
    guided = cfg_scale != 1.0
    key = jax.random.PRNGKey(11)
    want = jax_sampler.sample(
        jm, STEPS, jnp.asarray(x_T), {"c": jnp.asarray(c)}, key,
        uncond={"c": jnp.asarray(u)} if guided else None, cfg_scale=cfg_scale, **kw,
    )
    jax.effects_barrier()
    got = torch_sampler.sample(
        tm, STEPS, torch.from_numpy(x_T), {"c": torch.from_numpy(c)},
        uncond={"c": torch.from_numpy(u)} if guided else None, cfg_scale=cfg_scale,
        step_noises=_noises(key, STEPS) if noises else None, **kw,
    )
    want = want[0] if isinstance(want, tuple) else want
    got = got[0] if isinstance(got, tuple) else got
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    return seen_j, seen_t


@pytest.mark.parametrize("rescale", [False, True])
def test_cfg_scale_matches(rescale):
    js_ = JSpaced(training_betas=BETAS, rescale_cfg=rescale)
    ts_ = TSpaced(training_betas=BETAS, rescale_cfg=rescale)
    for scale in (1.0, 0.5, 4.0):
        for t in (0, 1, 250, 999, 1000):
            want = float(js_.get_cfg_scale(scale, jnp.asarray(t, jnp.int32)))
            got = ts_.get_cfg_scale(scale, t)
            assert isinstance(got, float)
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=f"{scale} {t}")
    # the rescaled scale starts at 1 at t = 1000 and rises to 1 + scale at t = 0
    if rescale:
        assert ts_.get_cfg_scale(4.0, 1000) == 1.0
        np.testing.assert_allclose(ts_.get_cfg_scale(4.0, 0), 5.0, rtol=1e-6)


@pytest.mark.parametrize("cfg_scale,rescale", [(1.0, False), (3.0, False), (3.0, True)])
def test_spaced_sampler_with_guidance(cfg_scale, rescale):
    seen_j, seen_t = _run_both(
        JSpaced(training_betas=BETAS, rescale_cfg=rescale),
        TSpaced(training_betas=BETAS, rescale_cfg=rescale), cfg_scale, noises=True,
    )
    assert seen_t == seen_j and len(seen_t) == STEPS * (2 if cfg_scale != 1.0 else 1)


@pytest.mark.parametrize("eta,cfg_scale", [(0.0, 1.0), (0.0, 2.5), (0.7, 2.5)])
def test_ddim(eta, cfg_scale):
    seen_j, seen_t = _run_both(
        j_ddim.DDIMSampler(training_betas=BETAS, rescale_cfg=True, eta=eta),
        t_ddim.DDIMSampler(training_betas=BETAS, rescale_cfg=True, eta=eta),
        cfg_scale, noises=True,
    )
    assert seen_t == seen_j


@pytest.mark.parametrize("single", [False, True])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_dpm_solver(order, single):
    cls_j = j_dpm.DPMSolverPPSingle if single else j_dpm.DPMSolverPP
    cls_t = t_dpm.DPMSolverPPSingle if single else t_dpm.DPMSolverPP
    cfg_scale = 1.0 if order == 2 else 2.0
    seen_j, seen_t = _run_both(
        cls_j(training_betas=BETAS, order=order, rescale_cfg=True),
        cls_t(training_betas=BETAS, order=order, rescale_cfg=True), cfg_scale,
    )
    passes = (STEPS * order + 1) if single else (STEPS + 1)
    assert len(seen_t) == passes * (2 if cfg_scale != 1.0 else 1)
    if single:
        assert seen_t == seen_j
    else:
        # the JAX scan evaluates node 0 twice on the same input; the port once
        per = 2 if cfg_scale != 1.0 else 1
        assert seen_j[:per] == seen_j[per:2 * per] and seen_t == seen_j[per:]


@pytest.mark.parametrize("steps", [2, 4, 10, 25, 50])
def test_dpm_timesteps_and_tables_are_equal(steps):
    alpha, sigma, lam, t_disc = j_dpm.DPMSolverPP(training_betas=BETAS)._schedule(steps)
    ta, ts_, tl, tt = t_dpm.DPMSolverPP(training_betas=BETAS).schedule(steps)
    np.testing.assert_array_equal(tt, np.asarray(t_disc))
    for got, want in ((ta, alpha), (ts_, sigma), (tl, lam)):
        np.testing.assert_array_equal(got, np.asarray(want))
    # the singlestep solver's intermediate nodes, as the JAX sample() builds them
    t_grid, lam_c, log_alpha, n = j_dpm._cont_maps(BETAS)
    lam_i = j_dpm._nodes_at_t(np.linspace(1.0, 1e-3, steps + 1), t_grid, lam_c, log_alpha, n)[2]
    h = lam_i[1:] - lam_i[:-1]
    for order, r1 in ((2, 0.5), (3, 1.0 / 3.0)):
        s = t_dpm.DPMSolverPPSingle(training_betas=BETAS, order=order).schedule(steps)
        for r, key in ((r1, "td1"), (2.0 / 3.0, "td2")):
            want = j_dpm._nodes_at_t(j_dpm._t_of_lam(lam_i[:-1] + r * h, t_grid, lam_c),
                                     t_grid, lam_c, log_alpha, n)[3]
            np.testing.assert_array_equal(s[key], want)


@pytest.mark.parametrize("solver", ["euler", "heun", "dpmpp_2m", "euler_ancestral",
                                    "dpmpp_2m_sde"])
def test_edm_solver(solver):
    stochastic = solver in ("euler_ancestral", "dpmpp_2m_sde")
    cfg_scale = 2.0 if solver in ("heun", "dpmpp_2m_sde") else 1.0
    seen_j, seen_t = _run_both(
        j_edm.EDMSampler(training_betas=BETAS, solver=solver, rescale_cfg=True),
        t_edm.EDMSampler(training_betas=BETAS, solver=solver, rescale_cfg=True),
        cfg_scale, noises=stochastic,
    )
    per = 2 if cfg_scale != 1.0 else 1
    passes = 2 * STEPS - 1 if solver == "heun" else STEPS
    assert len(seen_t) == passes * per
    if solver == "dpmpp_2m":
        # the JAX scan's carry starts as D(x, sigma_0) * 0: one pass more
        assert seen_t == seen_j[per:]
    else:
        assert seen_t == seen_j


def test_edm_tables_and_nearest_timestep():
    sampler = t_edm.EDMSampler(training_betas=BETAS)
    vp = sampler.vp_sigmas()
    np.testing.assert_array_equal(vp, np.asarray(
        j_edm.EDMSampler(training_betas=BETAS)._vp_tables()))
    for steps in (4, 50):
        sig = t_edm.karras_sigmas(steps, 0.0292, 14.61)
        np.testing.assert_array_equal(sig, j_edm.karras_sigmas(steps, 0.0292, 14.61))
        want = np.asarray(jnp.argmin(jnp.abs(jnp.asarray(vp)[None, :] - jnp.asarray(sig)[:, None]),
                                     axis=-1))
        assert [sampler.timestep_of(s, vp) for s in sig] == want.tolist()
    # a tie goes to the lower index, as jnp.argmin breaks it
    table = np.asarray([1.0, 3.0, 5.0], np.float32)
    want = int(jnp.argmin(jnp.abs(jnp.asarray(table) - jnp.float32(2.0))))
    assert sampler.timestep_of(np.float32(2.0), table) == want == 0


def test_stochastic_solvers_draw_from_the_generator():
    c, u, x_T = _conds()
    _, tm, _, _ = _models()
    for sampler in (t_edm.EDMSampler(training_betas=BETAS, solver="euler_ancestral"),
                    t_ddim.DDIMSampler(training_betas=BETAS, eta=1.0)):
        runs = [sampler.sample(tm, STEPS, torch.from_numpy(x_T), {"c": torch.from_numpy(c)},
                               generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
        assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    with pytest.raises(ValueError, match="step_noises"):
        sampler.sample(tm, STEPS, torch.from_numpy(x_T), {"c": torch.from_numpy(c)},
                       step_noises=[torch.zeros(SHAPE)])
