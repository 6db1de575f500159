"""Port's TESTR set criterion against the JAX package's on seeded outputs and
targets: every key of the loss dict, with auxiliary and encoder outputs, in
both matcher orientations, and the gradient of the total with respect to the
outputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tair_tpu.spotter import losses as jl
from tair_tpu_torch.spotter import losses as tl
from test_torch_common import torch_single_thread  # noqa: F401

N_PTS, N_CHARS, VOC = 16, 25, 97


def _layer(rng, b, q):
    return dict(
        pred_logits=rng.standard_normal((b, q, N_PTS, 1), dtype=np.float32) * 2,
        pred_ctrl_points=rng.random((b, q, N_PTS, 2), dtype=np.float32),
        pred_texts=rng.standard_normal((b, q, N_CHARS, VOC), dtype=np.float32),
    )


def _case(b, q, m, s, seed):
    rng = np.random.default_rng(seed)
    outputs = _layer(rng, b, q)
    outputs["aux_outputs"] = [_layer(rng, b, q) for _ in range(2)]
    outputs["enc_outputs"] = dict(
        pred_logits=rng.standard_normal((b, s, 1), dtype=np.float32) * 2,
        pred_boxes=np.concatenate(
            [rng.uniform(0.2, 0.8, (b, s, 2)), rng.uniform(0.05, 0.5, (b, s, 2))], -1
        ).astype(np.float32),
    )
    n_valid = np.array([m, 0, max(m - 1, 1)])[:b]
    targets = dict(
        inst_mask=np.arange(m)[None] < n_valid[:, None],
        boxes=np.concatenate(
            [rng.uniform(0.2, 0.8, (b, m, 2)), rng.uniform(0.05, 0.5, (b, m, 2))], -1
        ).astype(np.float32),
        ctrl_points=rng.random((b, m, N_PTS, 2), dtype=np.float32),
        texts=rng.integers(0, VOC, (b, m, N_CHARS)).astype(np.int32),
    )
    return outputs, targets


def _tree(fn, node):
    if isinstance(node, dict):
        return {k: _tree(fn, v) for k, v in node.items()}
    if isinstance(node, list):
        return [_tree(fn, v) for v in node]
    return fn(node)


@pytest.mark.parametrize("q,m", [(10, 4), (3, 6)])  # M <= Q, and more targets than queries
def test_every_key_of_set_criterion_matches(q, m):
    outputs, targets = _case(3, q, m, s=40, seed=q)
    want = jax.jit(jl.set_criterion)(_tree(jnp.asarray, outputs), _tree(jnp.asarray, targets))
    t_out = _tree(torch.from_numpy, outputs)
    t_tgt = _tree(torch.from_numpy, targets)
    got = tl.set_criterion(t_out, t_tgt)
    assert set(got) == set(want) and len(got) == 3 * 3 + 3 + 1
    for key, w in want.items():
        # float32 sums over at most a few thousand elements
        np.testing.assert_allclose(float(got[key]), float(w), rtol=2e-5, err_msg=key)


def test_gradient_of_the_total_matches():
    outputs, targets = _case(2, 6, 3, s=20, seed=5)
    j_tgt = _tree(jnp.asarray, targets)
    want = jax.jit(jax.grad(lambda o: jl.set_criterion(o, j_tgt)["loss_total"]))(
        _tree(jnp.asarray, outputs)
    )
    t_out = _tree(lambda a: torch.from_numpy(a).requires_grad_(True), outputs)
    tl.set_criterion(t_out, _tree(torch.from_numpy, targets))["loss_total"].backward()
    pairs = [
        (t_out["pred_logits"], want["pred_logits"]),
        (t_out["pred_ctrl_points"], want["pred_ctrl_points"]),
        (t_out["pred_texts"], want["pred_texts"]),
        (t_out["aux_outputs"][1]["pred_texts"], want["aux_outputs"][1]["pred_texts"]),
        (t_out["enc_outputs"]["pred_logits"], want["enc_outputs"]["pred_logits"]),
        (t_out["enc_outputs"]["pred_boxes"], want["enc_outputs"]["pred_boxes"]),
    ]
    for leaf, w in pairs:
        assert leaf.grad.abs().max() > 0
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)


def test_without_aux_and_encoder_outputs_and_with_greedy_matcher():
    outputs, targets = _case(2, 6, 3, s=20, seed=6)
    for key in ("aux_outputs", "enc_outputs"):
        outputs.pop(key)
    cfg_j = jl.CriterionConfig(matcher="greedy", point_text_weight=0.5)
    cfg_t = tl.CriterionConfig(matcher="greedy", point_text_weight=0.5)
    want = jl.set_criterion(_tree(jnp.asarray, outputs), _tree(jnp.asarray, targets), cfg_j)
    got = tl.set_criterion(
        _tree(torch.from_numpy, outputs), _tree(torch.from_numpy, targets), cfg_t
    )
    assert set(got) == set(want) == {"loss_ce", "loss_ctrl_points", "loss_texts", "loss_total"}
    for key, w in want.items():
        np.testing.assert_allclose(float(got[key]), float(w), rtol=2e-5, err_msg=key)


def test_sigmoid_focal_loss_rejects_other_ranks():
    with pytest.raises(ValueError):
        tl.sigmoid_focal_loss(torch.zeros((2, 3)), torch.zeros((2, 3)), 1.0)
