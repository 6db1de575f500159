"""The slice as a whole: ``restore_fused_feedback`` of the port against the
JAX package (default configuration) on the tiny model, 3 steps, with
``score_threshold=0.0`` so that words are kept and the prompt splice and the
CLIP re-encode really run. x_T and the step noises are reproduced from the
JAX keys and handed to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import (  # noqa: F401
    compiling, jax_fast_compiles, t2n, tiny_pair, torch_single_thread,
)

STEPS = 3


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=51)


@pytest.fixture(scope="module")
def lq():
    return np.random.default_rng(52).random((1, 64, 64, 3), dtype=np.float32)


def _jax_noises(rng, shape):
    k_noise, k_chain = jax.random.split(rng)
    x_T = np.array(jax.random.normal(k_noise, shape, jnp.float32))
    noises = [
        np.array(jax.random.normal(jax.random.fold_in(k_chain, i), shape, jnp.float32))
        for i in range(STEPS)
    ]
    return x_T, noises


@pytest.fixture(scope="module")
def results(pair, lq):
    """(JAX's restore, the port's): the JAX program compiles in a thread
    (`compiling`) while the port's restore runs."""
    jm, params, tm = pair
    rng = jax.random.PRNGKey(53)
    program = compiling({"restore": jax.jit(
        lambda p, x, r: jm.restore_fused_feedback(
            p, x, r, steps=STEPS, score_threshold=0.0, return_spots=True
        )
    ).lower(params, lq, rng)})["restore"]
    x_T, noises = _jax_noises(rng, (1, 8, 8, 4))
    got = tm.restore_fused_feedback(
        torch.from_numpy(lq), steps=STEPS, score_threshold=0.0, return_spots=True,
        x_T=torch.from_numpy(x_T), step_noises=[torch.from_numpy(n) for n in noises],
    )
    return program.result()(params, lq, rng), got


def test_restored_image_matches(results):
    (img_j, _, _), (img_t, _, _) = results
    assert tuple(img_t.shape) == (1, 64, 64, 3)
    assert float(img_t.min()) >= 0.0 and float(img_t.max()) <= 1.0
    # float32 through cleaner, VAE, 3 x (ControlNet + UNet + spotter + CLIP)
    np.testing.assert_allclose(t2n(img_t), np.asarray(img_j), atol=1e-3)


def test_final_tokens_equal_and_carry_words(results):
    (_, tok_j, _), (_, tok_t, _) = results
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    # the splice really ran: more than [SOT, EOT]
    assert int((tok_t != 0).sum()) > 2


def test_last_spots_match(results):
    (_, _, sp_j), (_, _, sp_t) = results
    assert set(sp_t) == {"scores", "keep", "polygons", "recs"}
    np.testing.assert_allclose(t2n(sp_t["scores"]), np.asarray(sp_j["scores"]), atol=1e-3)
    np.testing.assert_allclose(t2n(sp_t["polygons"]), np.asarray(sp_j["polygons"]), atol=64e-3)
    np.testing.assert_array_equal(sp_t["keep"].numpy(), np.asarray(sp_j["keep"]))


def test_generator_draws_are_reproducible_and_spotter_every(pair, lq):
    _, _, tm = pair
    x = torch.from_numpy(lq)
    a, ta = tm.restore_fused_feedback(x, torch.Generator().manual_seed(7), steps=2, score_threshold=0.0)
    b, tb = tm.restore_fused_feedback(x, torch.Generator().manual_seed(7), steps=2, score_threshold=0.0)
    c, _ = tm.restore_fused_feedback(x, torch.Generator().manual_seed(8), steps=2, score_threshold=0.0)
    assert torch.equal(a, b) and torch.equal(ta, tb) and not torch.equal(a, c)
    # refreshing every 4th step of a 2-step chain never runs the spotter
    _, tok = tm.restore_fused_feedback(
        x, torch.Generator().manual_seed(7), steps=2, score_threshold=0.0, spotter_every=4
    )
    assert tok[0, :3].tolist() == [49406, 49407, 0]


def test_step_noises_of_wrong_length_raise(pair, lq):
    _, _, tm = pair
    with pytest.raises(ValueError):
        tm.restore_fused_feedback(
            torch.from_numpy(lq), steps=3, step_noises=[torch.zeros(1, 8, 8, 4)]
        )
