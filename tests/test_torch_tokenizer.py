"""The port's BPE tokenizer against the JAX package's: the same ids for every
prompt, the pre-tokenizer that replaces the ``regex`` package included."""

import numpy as np
import pytest
import regex

from tair_tpu.models import tokenizer as jax_tok
from tair_tpu_torch.models import prompt_splice
from tair_tpu_torch.models import tokenizer as torch_tok
from test_torch_common import torch_single_thread  # noqa: F401

PROMPTS = [
    "A realistic scene where the texts \"OPEN\", \"EXIT\" appear clearly on signs.",
    "Hello, World! It's 9:30 -- don't stop; we'll see (maybe) [x] {y} <z> ...",
    "Café naïve façade Ångström coöperate déjà-vu",
    "東京タワー 北京 서울 Москва Αθήνα",
    "x² + y³ = z⁴, ½ cup, ¾ mile, Ⅻ o'clock, ⅷ",
    "Tom &amp; Jerry &lt;3 &quot;quoted&quot; &amp;amp; twice",
    "  spaces\tand\nnewlines\r\n  everywhere  ",
    "I'M SHOUTING: IT'S DON'T WE'RE THEY'VE I'D YOU'LL",
    "ſ'ſ 'ſ emoji 🙂👍🏽 mixed123abc 4.5e-3 #hash @at $5.00 100%",
    "",
]


def test_pre_tokenizer_matches_the_regex_pattern():
    pat = jax_tok.get_tokenizer().pat
    for text in PROMPTS:
        cleaned = jax_tok._whitespace_clean(jax_tok._basic_clean(text)).lower()
        assert torch_tok.pre_tokenize(cleaned) == regex.findall(pat, cleaned), text


@pytest.mark.parametrize("text", PROMPTS)
def test_ids_equal_jax(text):
    np.testing.assert_array_equal(torch_tok.tokenize(text), jax_tok.tokenize(text))


def test_truncation_at_77_keeps_the_end_token():
    long = " ".join(f"word{i} ½ ²" for i in range(60))
    ours, theirs = torch_tok.tokenize([long, "short"]), jax_tok.tokenize([long, "short"])
    np.testing.assert_array_equal(ours, theirs)
    assert ours.shape == (2, 77) and ours.dtype == np.int32
    assert ours[0, -1] == torch_tok.get_tokenizer().eot_token


def test_special_tokens_and_empty_prompt_agree_everywhere():
    tok = torch_tok.get_tokenizer()
    assert tok.sot_token == jax_tok.get_tokenizer().sot_token == prompt_splice.SOT_TOKEN
    assert tok.eot_token == jax_tok.get_tokenizer().eot_token == prompt_splice.EOT_TOKEN
    np.testing.assert_array_equal(torch_tok.empty_tokens(3), jax_tok.empty_tokens(3))
    np.testing.assert_array_equal(torch_tok.empty_tokens(3), prompt_splice.empty_tokens(3))
    assert tok.decode(tok.encode("hello world")) == "hello world "
