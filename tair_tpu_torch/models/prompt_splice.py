"""On-device prompt assembly from spotter predictions.

Counterpart of ``tair_tpu/models/prompt_splice.py``. Every printable-ASCII
character is itself a valid CLIP BPE token (byte tokens and their '</w>'
end-of-word forms), so a predicted word can be spliced token by token from two
95-entry lookup tables, and the whole TAG-style prompt ("w1, w2, ...")
assembled with cumsum positions and scatters, with no host round-trip.

The BPE tokenizer is not part of this slice: the token ids it would give for
the 95 characters of the spotter's charset (lower-cased, mid-word and
end-of-word form), the comma, and the start and end tokens are kept here as
constants. A test holds them against the tokenizer of the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..spotter.charset import CTLABELS

CONTEXT_LENGTH = 77
SOT_TOKEN = 49406
EOT_TOKEN = 49407
COMMA_TOKEN = 267  # ",</w>"
# token id of each charset character inside a word ...
CHAR_TOKENS_MID = (
    220, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10,
    11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 26, 27, 28, 29, 30, 31, 64, 65, 66,
    67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 77, 78,
    79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70,
    71, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82,
    83, 84, 85, 86, 87, 88, 89, 90, 91, 92, 93,
)
# ... and as the last character of a word
CHAR_TOKENS_END = (
    476, 256, 257, 258, 259, 260, 261, 262, 263, 264, 265, 266,
    267, 268, 269, 270, 271, 272, 273, 274, 275, 276, 277, 278,
    279, 280, 281, 282, 283, 284, 285, 286, 287, 320, 321, 322,
    323, 324, 325, 326, 327, 328, 329, 330, 331, 332, 333, 334,
    335, 336, 337, 338, 339, 340, 341, 342, 343, 344, 345, 314,
    315, 316, 317, 318, 319, 320, 321, 322, 323, 324, 325, 326,
    327, 328, 329, 330, 331, 332, 333, 334, 335, 336, 337, 338,
    339, 340, 341, 342, 343, 344, 345, 346, 347, 348, 349,
)
if not len(CHAR_TOKENS_MID) == len(CHAR_TOKENS_END) == len(CTLABELS):
    raise ImportError("the character token tables do not cover the charset")


def empty_tokens(batch: int, context_length: int = CONTEXT_LENGTH) -> np.ndarray:
    """Empty-prompt token batch ([SOT, EOT, 0...]): the initial condition of
    the prompt-recycling loop."""
    out = np.zeros((batch, context_length), np.int32)
    out[:, 0] = SOT_TOKEN
    out[:, 1] = EOT_TOKEN
    return out


@functools.lru_cache(maxsize=8)
def _token_tables(device: torch.device):
    return (
        torch.tensor(CHAR_TOKENS_MID, dtype=torch.long, device=device),
        torch.tensor(CHAR_TOKENS_END, dtype=torch.long, device=device),
    )


def splice_tag_prompt(
    recs: torch.Tensor,        # [B, K, Nw] predicted char ids (PAD_ID padded)
    scores: torch.Tensor,      # [B, K] instance scores
    keep: torch.Tensor,        # [B, K] bool
    max_words: int = 4,
) -> torch.Tensor:             # [B, 77] int64 CLIP tokens
    """Assemble TAG-style prompts ("word1, word2, ...") on the device."""
    dev = recs.device
    mid_t, end_t = _token_tables(dev)
    n_chars = len(CTLABELS)
    b, k, nw = recs.shape
    ctx = CONTEXT_LENGTH
    recs = recs.long()

    # pick the top max_words kept instances by score
    ranked = scores.float().masked_fill(~keep, -torch.inf)
    top_scores, top_idx = torch.topk(ranked, max_words, dim=1)        # [B, W]
    words = torch.gather(recs, 1, top_idx[..., None].expand(-1, -1, nw))  # [B, W, Nw]
    word_valid = torch.isfinite(top_scores)                           # [B, W]

    # per-word char validity and lengths (chars after the first PAD ignored)
    is_char = words < n_chars                                         # [B, W, Nw]
    first_pad = torch.cumprod(is_char.long(), dim=-1)                 # run of chars
    char_valid = first_pad.bool() & word_valid[..., None]
    lengths = char_valid.sum(-1)                                      # [B, W]
    has_word = lengths > 0

    # token per char: end-form on the word's last char, else mid-form
    pos_in_word = torch.cumsum(char_valid.long(), dim=-1) - 1
    is_last = char_valid & (pos_in_word == (lengths[..., None] - 1))
    safe = words.clamp(0, n_chars - 1)
    char_tok = torch.where(is_last, end_t[safe], mid_t[safe])

    # word slots: chars + one separator (comma) after each non-final word
    n_words = has_word.sum(-1, keepdim=True)                          # [B, 1]
    word_order = torch.cumsum(has_word.long(), -1) - 1                # index among kept
    sep_valid = has_word & (word_order < n_words - 1)                 # [B, W]

    # flatten (char tokens ++ separator) per word with cumsum positions
    unit_len = lengths + sep_valid.long()                             # [B, W]
    word_start = torch.cumsum(unit_len, -1) - unit_len + 1            # +1 for SOT
    char_pos = word_start[..., None] + pos_in_word                    # [B, W, Nw]
    sep_pos = word_start + lengths                                    # [B, W]

    total = 1 + unit_len.sum(-1)                                      # EOT position

    # valid positions are distinct by construction; invalid entries write 0
    # into a slot past the context that is cut off below
    frame = torch.zeros((b, ctx + nw), dtype=torch.long, device=dev)  # overflow room
    zero = torch.zeros((), dtype=torch.long, device=dev)
    char_idx = torch.where(
        char_valid, char_pos.clamp(0, ctx + nw - 1), torch.full_like(char_pos, ctx)
    )
    frame.scatter_(
        1, char_idx.reshape(b, -1), torch.where(char_valid, char_tok, zero).reshape(b, -1)
    )
    sep_idx = torch.where(
        sep_valid, sep_pos.clamp(0, ctx + nw - 1), torch.full_like(sep_pos, ctx + nw - 1)
    )
    frame.scatter_(
        1, sep_idx, torch.where(sep_valid, torch.full_like(sep_pos, COMMA_TOKEN), zero)
    )

    frame = frame[:, :ctx].clone()
    frame[:, 0] = SOT_TOKEN
    eot_pos = total.clamp(1, ctx - 1)
    frame.scatter_(1, eot_pos[:, None], torch.full_like(eot_pos[:, None], EOT_TOKEN))
    # zero everything past EOT (scatter overflow hygiene)
    past = torch.arange(ctx, device=dev)[None] > eot_pos[:, None]
    return frame.masked_fill(past, 0)
