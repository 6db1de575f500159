"""Port's on-device prompt splice against the JAX function (token ids exact),
and its constant token tables against the JAX package's tokenizer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tair_tpu.models.prompt_splice import char_token_tables
from tair_tpu.models.prompt_splice import splice_tag_prompt as jax_splice
from tair_tpu.models.tokenizer import empty_tokens as jax_empty_tokens
from tair_tpu.spotter.charset import PAD_ID, encode_text
from tair_tpu_torch.models import prompt_splice as ps
from test_torch_common import torch_single_thread  # noqa: F401


def test_constant_tables_equal_the_tokenizer():
    mid, end, comma, sot, eot = char_token_tables()
    np.testing.assert_array_equal(np.asarray(ps.CHAR_TOKENS_MID), mid)
    np.testing.assert_array_equal(np.asarray(ps.CHAR_TOKENS_END), end)
    assert (ps.COMMA_TOKEN, ps.SOT_TOKEN, ps.EOT_TOKEN) == (comma, sot, eot)
    np.testing.assert_array_equal(ps.empty_tokens(3), jax_empty_tokens(3))


def _both(recs, scores, keep, max_words):
    want = jax_splice(jnp.asarray(recs), jnp.asarray(scores), jnp.asarray(keep), max_words)
    got = ps.splice_tag_prompt(
        torch.from_numpy(recs), torch.from_numpy(scores), torch.from_numpy(keep), max_words
    )
    assert tuple(got.shape) == (recs.shape[0], 77)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return got.numpy()


@pytest.mark.parametrize("max_words", [1, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_predictions_exact(seed, max_words):
    rng = np.random.default_rng(seed)
    recs = rng.integers(0, 97, (3, 10, 25)).astype(np.int32)
    # a run of pads in most words, as the spotter's argmax gives
    cut = rng.integers(0, 25, (3, 10))
    recs[np.arange(25)[None, None] >= cut[..., None]] = PAD_ID
    scores = rng.random((3, 10), dtype=np.float32)
    keep = scores > 0.4
    _both(recs, scores, keep, max_words)


def test_known_words():
    recs = np.full((1, 5, 25), PAD_ID, np.int32)
    recs[0, 1] = encode_text("STOP")
    recs[0, 3] = encode_text("go")
    scores = np.asarray([[0.1, 0.9, 0.2, 0.8, 0.3]], np.float32)
    keep = scores > 0.5
    toks = _both(recs, scores, keep, 4)[0]
    n = 1 + 4 + 1 + 2  # SOT, s t o p</w>, comma, g o</w>
    assert toks[0] == ps.SOT_TOKEN and toks[n] == ps.EOT_TOKEN and (toks[n + 1 :] == 0).all()
    assert toks[5] == ps.COMMA_TOKEN


def test_nothing_kept_gives_empty_prompt():
    recs = np.zeros((2, 6, 25), np.int32)
    scores = np.zeros((2, 6), np.float32)
    keep = np.zeros((2, 6), bool)
    toks = _both(recs, scores, keep, 4)
    np.testing.assert_array_equal(toks, ps.empty_tokens(2))


def test_overflowing_prompt_is_cut_at_the_context():
    recs = np.full((1, 6, 25), 33, np.int32)  # six 25-char words: 150 > 77 tokens
    scores = np.linspace(0.9, 0.6, 6, dtype=np.float32)[None]
    keep = np.ones((1, 6), bool)
    toks = _both(recs, scores, keep, 6)[0]
    assert toks[0] == ps.SOT_TOKEN and toks[76] == ps.EOT_TOKEN
