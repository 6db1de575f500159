"""The DiffBIR restoration path of the port against the JAX package: its
building blocks (``gaussian_window``, ``make_tiled_fn``, GroupNorm pooled over
the tiles, the tiled VAE, latent guidance, the BSRNet and SCUNet cleaners) and
``DiffBIRPipeline.run`` as a whole on the tiny model, with the JAX draws
(``x_T``, the step noises, the ``noise_aug`` noise) taken from its keys and
handed to the port. Two JAX runs in all, each compiled with ``jax.jit`` once in
a module-scoped fixture: an untiled request with guidance (classifier-free,
rescaled), `strength`, `noise_aug`, MSE guidance and the colour fix; and a
tiled one with guidance and DDIM. The JAX tiled VAE reads its NaN check on the
host, which a trace cannot; the fixture stubs that check while it traces (it
changes no value), which halves the run's time against an eager one."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tair_tpu.diffbir_pipeline import DiffBIRPipeline as JaxPipeline
from tair_tpu.models import cleaners as jc
from tair_tpu.models import layers as jl
from tair_tpu.models.tokenizer import tokenize
from tair_tpu.tiling import gaussian_window as jax_gaussian_window
from tair_tpu.tiling import make_tiled_fn as jax_make_tiled_fn
from tair_tpu.utils import guidance as jg
from tair_tpu.utils import tilevae as jt
from tair_tpu_torch.diffbir_pipeline import DiffBIRPipeline
from tair_tpu_torch.models import cleaners as tc
from tair_tpu_torch.models import layers as tl
from tair_tpu_torch.tiling import gaussian_window, make_tiled_fn
from tair_tpu_torch.utils import guidance as tg
from tair_tpu_torch.utils import tilevae as tt
from test_torch_common import (  # noqa: F401
    jax_shapes, load_module, noise_params, t2n, tiny_pair, torch_single_thread,
)

PARTS = ("unet", "controlnet", "vae", "clip", "swinir")
RUN_TOL = 1e-3  # float32 on both sides through a whole request of 2 steps


def _n(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("size", [7, 8, 64])
def test_gaussian_window_is_bit_equal(size):
    np.testing.assert_array_equal(gaussian_window(size), jax_gaussian_window(size))


@pytest.mark.parametrize("hw", [(20, 20), (12, 28), (5, 30)])
def test_make_tiled_fn_with_a_convolution(hw):
    """Square, non-square, and one axis under the tile (edge-padded): a 3x3
    convolution whose tile borders differ from the whole image's, plus an extra
    array tiled on the same grid."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, *hw, 3), dtype=np.float32)
    extra = rng.standard_normal((2, *hw, 4), dtype=np.float32)
    k = rng.standard_normal((3, 3, 3, 4), dtype=np.float32)  # HWIO

    def jfn(xt, et):
        y = jax.lax.conv_general_dilated(xt, jnp.asarray(k), (1, 1), "SAME",
                                         dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return y + et

    def tfn(xt, et):
        w = torch.from_numpy(k).permute(3, 2, 0, 1)
        return F.conv2d(xt.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1) + et

    want = jax_make_tiled_fn(jfn, 8, 4)(jnp.asarray(x), jnp.asarray(extra))
    got = make_tiled_fn(tfn, 8, 4)(torch.from_numpy(x), torch.from_numpy(extra))
    assert got.shape == (2, *hw, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_group_norm_pools_over_the_batch_inside_the_context_only():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 6, 5, 64), dtype=np.float32) * 2.0 + 1.0
    x[1] += 3.0  # tiles of unequal statistics
    mod = jl.GroupNorm32()
    params = jax.tree.map(np.asarray, mod.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    params = jax.tree.map(lambda p: p + rng.standard_normal(p.shape, dtype=np.float32), params)
    port = tl.GroupNorm32(64)
    port.load_state_dict({"weight": torch.from_numpy(params["GroupNorm_0"]["scale"]),
                          "bias": torch.from_numpy(params["GroupNorm_0"]["bias"])}, strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with jl.gn_stats_over_batch():
        pooled_j = mod.apply({"params": params}, jnp.asarray(x))
    plain_j = mod.apply({"params": params}, jnp.asarray(x))
    with tl.gn_stats_over_batch():
        pooled_t = port(xt)
    plain_t = port(xt)
    np.testing.assert_allclose(t2n(pooled_t.permute(0, 2, 3, 1)), np.asarray(pooled_j), atol=1e-5)
    np.testing.assert_allclose(t2n(plain_t.permute(0, 2, 3, 1)), np.asarray(plain_j), atol=1e-5)
    assert not np.allclose(np.asarray(pooled_j), np.asarray(plain_j), atol=1e-2)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=91, parts=PARTS)


@pytest.mark.parametrize("cross_tile_gn", [False, True])
def test_tiled_vae_encode_and_decode(pair, cross_tile_gn):
    jm, params, tm = pair
    rng = np.random.default_rng(9)
    img = rng.random((1, 64, 48, 3), dtype=np.float32) * 2.0 - 1.0
    z = rng.standard_normal((1, 8, 6, 4), dtype=np.float32)
    want_z = jt.tiled_vae_encode(jm.cldm, params, jnp.asarray(img), tile_size=32, overlap=16,
                                 cross_tile_gn=cross_tile_gn)
    want_x = jt.tiled_vae_decode(jm.cldm, params, jnp.asarray(z), tile_size=4, overlap=2,
                                 cross_tile_gn=cross_tile_gn)
    with torch.no_grad():
        got_z = tt.tiled_vae_encode(tm.cldm, torch.from_numpy(img), tile_size=32, overlap=16,
                                    cross_tile_gn=cross_tile_gn)
        got_x = tt.tiled_vae_decode(tm.cldm, torch.from_numpy(z), tile_size=4, overlap=2,
                                    cross_tile_gn=cross_tile_gn)
    assert got_z.shape == (1, 8, 6, 4) and got_x.shape == (1, 64, 48, 3)
    np.testing.assert_allclose(got_z.numpy(), np.asarray(want_z), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=1e-4, rtol=0)
    with pytest.raises(tt.NansException):
        tt.tiled_apply(lambda tiles: tiles * float("nan"), torch.zeros(1, 8, 8, 1), 4, 2, 1, 1)


@pytest.mark.parametrize("weighted", [False, True])
def test_latent_guidance(weighted):
    rng = np.random.default_rng(10)
    x0 = rng.standard_normal((2, 6, 5, 4), dtype=np.float32)
    target = rng.standard_normal((2, 6, 5, 4), dtype=np.float32)
    t = np.asarray([300, 900], np.int32)  # the second outside the window
    kw = dict(scale=0.05, t_start=800, t_stop=100, n_repeats=2)
    jcls, tcls = ((jg.WeightedMSEGuidance, tg.WeightedMSEGuidance) if weighted
                  else (jg.MSEGuidance, tg.MSEGuidance))
    want = jcls(**kw)(jnp.asarray(x0), jnp.asarray(target), jnp.asarray(t))
    with torch.no_grad():  # the pipeline calls it under no_grad
        got = tcls(**kw)(torch.from_numpy(x0), torch.from_numpy(target), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), x0[1])
    assert not np.allclose(got[0].numpy(), x0[0])


@pytest.mark.parametrize("name,hw", [("rrdb_x2", (12, 10)), ("rrdb_x4", (8, 8)),
                                     ("scunet", (40, 56))])
def test_cleaners_through_converted_weights(name, hw):
    """BSRNet at x2 and x4, and SCUNet on an input edge-padded to 64 x 64 whose
    deepest level is one 8 x 8 window (the shift mask and roll at that size)."""
    if name == "scunet":
        cfg = dict(dim=16, config=(1, 1, 1, 1, 1, 1, 1), head_dim=8)
        jmod, tmod = jc.SCUNet(jc.SCUNetConfig(**cfg)), tc.SCUNet(tc.SCUNetConfig(**cfg))
    else:
        cfg = dict(nf=8, nb=2, gc=4, sf=int(name[-1]))
        jmod, tmod = jc.RRDBNet(jc.RRDBNetConfig(**cfg)), tc.RRDBNet(tc.RRDBNetConfig(**cfg))
    x = np.random.default_rng(11).random((1, *hw, 3), dtype=np.float32)
    params = noise_params(jax_shapes(jmod.init, jnp.asarray(x))["params"], 12)
    want = jax.jit(lambda p, v: jmod.apply({"params": p}, v))(params, jnp.asarray(x))
    with torch.no_grad():
        got = load_module(tmod, params)(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def _jax_draws(rng_key, c_shape, steps, noise_aug):
    """The JAX run's draws in its order: the noise_aug noise, x_T, then the
    sampler's per-step noises (fold_in of the chain key)."""
    draws = {}
    if noise_aug > 0:
        k_aug, rng_key = jax.random.split(rng_key)
        draws["aug_noise"] = _n(jax.random.normal(k_aug, c_shape, jnp.float32))
    k_noise, k_chain = jax.random.split(rng_key)
    draws["x_T"] = _n(jax.random.normal(k_noise, c_shape, jnp.float32))
    draws["step_noises"] = [_n(jax.random.normal(jax.random.fold_in(k_chain, i), c_shape,
                                                 jnp.float32)) for i in range(steps)]
    return draws


RUNS = {
    "untiled_cfg": dict(
        hw=(80, 100), latent=(16, 16),
        kw=dict(steps=2, cfg_scale=3.0, rescale_cfg=True, sampler_type="spaced",
                strength=0.8, noise_aug=20, color_fix=True),
    ),
    "tiled_cfg_ddim": dict(
        hw=(96, 96), latent=(16, 16),
        kw=dict(steps=2, cfg_scale=3.0, tiled=True, tile_size=64, tile_stride=32,
                sampler_type="ddim"),
    ),
}


@pytest.fixture(scope="module")
def jax_runs(pair):
    """Each JAX request once: (lq, tokens, key, JAX output)."""
    jm, params, _ = pair
    pipe = JaxPipeline(jm)
    out = {}
    for name, run in RUNS.items():
        lq = jnp.asarray(np.random.default_rng(13).random((1, *run["hw"], 3), dtype=np.float32))
        toks = jnp.asarray(tokenize(["a shop sign"]))
        key = jax.random.PRNGKey(17)
        kw = dict(run["kw"])
        if name == "untiled_cfg":
            kw["guidance"] = jg.MSEGuidance(scale=0.05)

        def fn(p, lq_, toks_, key_, kw=kw):
            return pipe.run(p, lq_, toks_, key_, **kw)

        with mock.patch.object(jt, "_check_nans", lambda *args: None):
            out[name] = (lq, toks, key, np.asarray(jax.jit(fn)(params, lq, toks, key)))
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_run_matches_jax(pair, jax_runs, name):
    _, _, tm = pair
    run = RUNS[name]
    lq, toks, key, want = jax_runs[name]
    draws = _jax_draws(key, (1, *run["latent"], 4), run["kw"]["steps"],
                       run["kw"].get("noise_aug", 0))
    kw = dict(run["kw"])
    if name == "untiled_cfg":
        kw["guidance"] = tg.MSEGuidance(scale=0.05)
    got = DiffBIRPipeline(tm).run(_n(lq), _n(toks).long(), **kw, **draws)
    assert got.shape == (1, *run["hw"], 3)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    np.testing.assert_allclose(got.numpy(), want, atol=RUN_TOL, rtol=0)


def test_unknown_sampler_and_resizing_cleaner_raise(pair):
    """An unknown sampler name raises in both packages. A cleaner that
    upscales (BSRNet x4) cannot serve `run`: JAX draws x_T at the padded
    input's size / 8 and fails to join the 4x condition to it; the port says so."""
    jm, params, tm = pair
    with pytest.raises(NotImplementedError):
        JaxPipeline(jm)._make_sampler("plms", False)
    with pytest.raises(NotImplementedError):
        DiffBIRPipeline(tm)._make_sampler("plms", False)
    cfg = dict(nf=4, nb=1, gc=4, sf=4)
    jclean, tclean = jc.RRDBNet(jc.RRDBNetConfig(**cfg)), tc.RRDBNet(tc.RRDBNetConfig(**cfg))
    lq = np.random.default_rng(14).random((1, 64, 64, 3), dtype=np.float32)
    cparams = noise_params(jax_shapes(jclean.init, jnp.asarray(lq))["params"], 15)
    jpipe = JaxPipeline(jm, cleaner_apply=lambda p, v: jclean.apply({"params": cparams}, v))
    toks = tokenize([""])
    with pytest.raises(TypeError):
        jax.eval_shape(lambda p: jpipe.run(p, jnp.asarray(lq), jnp.asarray(toks),
                                           jax.random.PRNGKey(0), steps=1), params)
    tpipe = DiffBIRPipeline(tm, cleaner=load_module(tclean, cparams))
    with pytest.raises(ValueError, match="keeps the size"):
        tpipe.run(torch.from_numpy(lq), torch.from_numpy(toks).long(), steps=1)


def test_restore_with_negative_tokens_runs_both_branches(pair):
    """`TeReDiff.restore` with `negative_tokens`: two passes a step, the
    negative prompt's embedding in the second, and at scale 1.0 the
    conditional pass alone (the run above holds the mix against JAX)."""
    _, _, tm = pair
    rng = np.random.default_rng(16)
    lq = torch.from_numpy(rng.random((1, 64, 64, 3), dtype=np.float32))
    toks = torch.from_numpy(tokenize(["a shop sign"])).long()
    neg = torch.from_numpy(tokenize([""])).long()
    x_T = torch.from_numpy(rng.standard_normal((1, 8, 8, 4), dtype=np.float32))
    noises = [torch.from_numpy(rng.standard_normal((1, 8, 8, 4), dtype=np.float32))
              for _ in range(2)]
    seen = []
    apply = tm.cldm.apply

    def counting(x, t, cond, **kw):
        seen.append(cond["c_txt"])
        return apply(x, t, cond, **kw)

    tm.cldm.apply = counting
    try:
        kw = dict(steps=2, x_T=x_T, step_noises=noises)
        plain, _, _ = tm.restore(lq, toks, **kw)
        n_plain = len(seen)
        same, _, _ = tm.restore(lq, toks, negative_tokens=neg, cfg_scale=1.0, **kw)
        n_same = len(seen) - n_plain
        guided, _, _ = tm.restore(lq, toks, negative_tokens=neg, cfg_scale=4.0,
                                  rescale_cfg=True, **kw)
    finally:
        del tm.cldm.apply
    assert n_plain == n_same == 2 and len(seen) == 2 + 2 + 4
    assert torch.equal(plain, same) and not torch.allclose(plain, guided, atol=1e-4)
    with torch.no_grad():
        neg_embed = tm.cldm.clip_encode_tokens(neg)
    assert torch.equal(seen[5], neg_embed) and not torch.equal(seen[4], neg_embed)
