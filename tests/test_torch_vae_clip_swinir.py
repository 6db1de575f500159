"""Port's VAE, CLIP text tower and SwinIR cleaner against the JAX modules at
the tiny geometry, every parameter seeded noise."""

import jax
import numpy as np
import pytest
import torch

from tair_tpu.models.vae import AutoencoderKL as JaxVAE
from test_torch_common import jax_fast_compiles, t2n, tiny_pair, torch_single_thread  # noqa: F401

TOL = 1e-4  # float32 on both sides; summation order only


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=21, parts=("vae", "clip", "swinir"))


def test_vae_encode_moments_and_scaled_latent(pair):
    jm, params, tm = pair
    img = np.random.default_rng(22).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    mean_j, logvar_j = jax.jit(
        lambda p, x: jm.cldm.vae.apply({"params": p}, x, method=JaxVAE.encode_moments)
    )(params["vae"], img)
    with torch.no_grad():
        mean_t, logvar_t = tm.cldm.vae.encode_moments(torch.from_numpy(img))
        z_t = tm.cldm.vae_encode(torch.from_numpy(img), sample=False)
    np.testing.assert_allclose(t2n(mean_t), np.asarray(mean_j), atol=TOL)
    np.testing.assert_allclose(t2n(logvar_t), np.asarray(logvar_j), atol=TOL)
    np.testing.assert_allclose(t2n(z_t), np.asarray(mean_j) * 0.18215, atol=TOL)


def test_vae_decode(pair):
    jm, params, tm = pair
    z = np.random.default_rng(23).standard_normal((2, 8, 8, 4), dtype=np.float32)
    want = jax.jit(lambda p, z: jm.cldm.vae_decode(p, z))(params, z)
    with torch.no_grad():
        got = tm.cldm.vae_decode(torch.from_numpy(z))
    assert tuple(got.shape) == (2, 64, 64, 3)
    np.testing.assert_allclose(t2n(got), np.asarray(want), atol=TOL)


def test_vae_wide_middle_attention_matches_jax():
    """A VAEConfig whose middle width ch * ch_mult[-1] passes 512 (160 x 4 =
    640: the middle attention's single head is wider than the D = 512
    kernels, and on the card runs on the column-split ones): the port builds
    it, and its encode and decode match the JAX VAE's on the same noise
    parameters, handed over through ``from_jax_params``."""
    from tair_tpu.models.vae import VAEConfig as JaxVAEConfig
    from tair_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from tair_tpu_torch.weights.convert import from_jax_params, module_param_shapes
    from test_torch_common import noise_params

    cfg = dict(ch=160, ch_mult=(1, 4), num_res_blocks=1)
    vae = AutoencoderKL(VAEConfig(**cfg)).eval()
    params = noise_params(module_param_shapes(vae), seed=26)
    state = from_jax_params({"vae": params})
    vae.load_state_dict({k.removeprefix("cldm.vae."): v for k, v in state.items()}, strict=True)
    jvae = JaxVAE(JaxVAEConfig(**cfg))
    rng = np.random.default_rng(27)
    img = rng.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    z = rng.standard_normal((1, 8, 8, 4), dtype=np.float32)
    # encode and decode as one JAX program: one compilation
    mean_j, logvar_j, image_j = jax.jit(lambda p, x, z: (
        *jvae.apply({"params": p}, x, method=JaxVAE.encode_moments),
        jvae.apply({"params": p}, z, method=JaxVAE.decode),
    ))(params, img, z)
    with torch.no_grad():
        mean_t, logvar_t = vae.encode_moments(torch.from_numpy(img))
        image_t = vae.decode(torch.from_numpy(z))
    assert vae.encoder.mid_attn.q.out_channels == 640
    np.testing.assert_allclose(t2n(mean_t), np.asarray(mean_j), atol=TOL)
    np.testing.assert_allclose(t2n(logvar_t), np.asarray(logvar_j), atol=TOL)
    assert tuple(image_t.shape) == (1, 16, 16, 3)
    np.testing.assert_allclose(t2n(image_t), np.asarray(image_j), atol=TOL)


def test_vae_encode_sample_draws_from_generator(pair):
    _, _, tm = pair
    img = torch.from_numpy(
        np.random.default_rng(24).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    )
    with torch.no_grad():
        a = tm.cldm.vae_encode(img, sample=True, generator=torch.Generator().manual_seed(3))
        b = tm.cldm.vae_encode(img, sample=True, generator=torch.Generator().manual_seed(3))
        mode = tm.cldm.vae_encode(img, sample=False)
    assert torch.equal(a, b) and not torch.equal(a, mode)


def test_clip_encode_tokens(pair):
    jm, params, tm = pair
    rng = np.random.default_rng(25)
    tokens = rng.integers(0, 49408, (2, 77)).astype(np.int32)
    tokens[:, 0] = 49406
    tokens[0, 5:] = 0
    want = jax.jit(lambda p, t: jm.cldm.clip_encode_tokens(p, t))(params, tokens)
    with torch.no_grad():
        got = tm.cldm.clip_encode_tokens(torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 77, 64)
    np.testing.assert_allclose(t2n(got), np.asarray(want), atol=TOL)


def test_clip_is_causal(pair):
    _, _, tm = pair
    tokens = torch.from_numpy(
        np.random.default_rng(26).integers(0, 49408, (1, 77)).astype(np.int64)
    )
    other = tokens.clone()
    other[0, 40:] = 1
    with torch.no_grad():
        a, b = tm.cldm.clip_encode_tokens(tokens), tm.cldm.clip_encode_tokens(other)
    assert torch.equal(a[:, :40], b[:, :40]) and not torch.equal(a[:, 40:], b[:, 40:])


def test_swinir_clean(pair):
    jm, params, tm = pair
    lq = np.random.default_rng(27).random((2, 64, 64, 3), dtype=np.float32)
    raw = jax.jit(lambda p, x: jm.swinir.apply({"params": p}, x))(params["swinir"], lq)
    want = np.clip(np.asarray(raw), 0.0, 1.0)  # TeReDiff.clean
    with torch.no_grad():
        got = tm.clean(torch.from_numpy(lq))
        got_raw = tm.swinir(torch.from_numpy(lq))
    np.testing.assert_allclose(t2n(got_raw), np.asarray(raw), atol=TOL)
    np.testing.assert_allclose(t2n(got), np.asarray(want), atol=TOL)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


def test_swinir_shift_mask_and_rel_index_match_jax():
    from tair_tpu.models import swinir as js
    from tair_tpu_torch.models import swinir as ts

    np.testing.assert_array_equal(ts._rel_pos_index(4), js._rel_pos_index(4))
    np.testing.assert_array_equal(
        ts._shift_attn_mask(8, 12, 4, 2), js._shift_attn_mask(8, 12, 4, 2)
    )
