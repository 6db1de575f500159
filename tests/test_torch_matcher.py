"""Port's matchers against the JAX package's: the cost terms elementwise, and
the assignments of the exact solve against the on-device Jonker-Volgenant
(``jv_assignment``) on seeded costs without ties, in both orientations and
with padded targets."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tair_tpu.spotter import matcher as jm
from tair_tpu_torch.spotter import matcher as tm
from test_torch_common import torch_single_thread  # noqa: F401

TOL = 1e-5  # float32 elementwise arithmetic


def _outputs_targets(b, q, m, n_pts, seed):
    rng = np.random.default_rng(seed)
    outputs = dict(
        pred_logits=rng.standard_normal((b, q, n_pts, 1), dtype=np.float32) * 2,
        pred_ctrl_points=rng.random((b, q, n_pts, 2), dtype=np.float32),
    )
    enc = dict(
        pred_logits=rng.standard_normal((b, q, 1), dtype=np.float32) * 2,
        pred_boxes=np.concatenate(
            [rng.uniform(0.2, 0.8, (b, q, 2)), rng.uniform(0.05, 0.5, (b, q, 2))], -1
        ).astype(np.float32),
    )
    n_valid = rng.integers(0, m + 1, (b,))
    n_valid[0] = m   # one element with every slot real
    if b > 1:
        n_valid[1] = 0  # and one with none
    targets = dict(
        ctrl_points=rng.random((b, m, n_pts, 2), dtype=np.float32),
        boxes=np.concatenate(
            [rng.uniform(0.2, 0.8, (b, m, 2)), rng.uniform(0.05, 0.5, (b, m, 2))], -1
        ).astype(np.float32),
        inst_mask=np.arange(m)[None] < n_valid[:, None],
    )
    return outputs, enc, targets


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def test_cost_terms_match_elementwise():
    rng = np.random.default_rng(0)
    prob = rng.random((2, 9, 5, 1), dtype=np.float32)
    np.testing.assert_allclose(
        tm._focal_class_cost(torch.from_numpy(prob)).numpy(),
        np.asarray(jm._focal_class_cost(jnp.asarray(prob))), atol=TOL,
    )
    boxes_a = np.concatenate(
        [rng.uniform(0.1, 0.9, (2, 9, 2)), rng.uniform(0.01, 0.6, (2, 9, 2))], -1
    ).astype(np.float32)
    boxes_b = np.concatenate(
        [rng.uniform(0.1, 0.9, (2, 4, 2)), rng.uniform(0.01, 0.6, (2, 4, 2))], -1
    ).astype(np.float32)
    xa_t = tm.box_cxcywh_to_xyxy(torch.from_numpy(boxes_a))
    xa_j = jm.box_cxcywh_to_xyxy(jnp.asarray(boxes_a))
    np.testing.assert_allclose(xa_t.numpy(), np.asarray(xa_j), atol=TOL)
    giou_t = tm.generalized_box_iou_pairwise(
        xa_t, tm.box_cxcywh_to_xyxy(torch.from_numpy(boxes_b))
    )
    giou_j = jm.generalized_box_iou_pairwise(xa_j, jm.box_cxcywh_to_xyxy(jnp.asarray(boxes_b)))
    assert tuple(giou_t.shape) == (2, 9, 4)
    np.testing.assert_allclose(giou_t.numpy(), np.asarray(giou_j), atol=TOL)


@pytest.mark.parametrize("q,m", [(12, 5), (5, 5), (4, 9)])  # M < Q, M == Q, M > Q
def test_exact_assignment_equals_jv_on_seeded_costs(q, m):
    rng = np.random.default_rng(q * 31 + m)
    b = 4
    cost = rng.standard_normal((b, q, m)).astype(np.float32)  # continuous: no ties
    n_valid = np.array([m, 0, max(m - 2, 1), min(m, q)], np.int32)
    want = np.asarray(jm.jv_assignment(jnp.asarray(cost), jnp.asarray(n_valid)))
    for impl in ("hungarian", "jv", "hungarian_host"):
        got = tm._dispatch(impl, torch.from_numpy(cost), torch.from_numpy(n_valid))
        assert got.dtype == torch.long and tuple(got.shape) == (b, m)
        np.testing.assert_array_equal(got.numpy(), want)
    # padded targets and, with more targets than queries, the surplus: -1
    assert (want[1] == -1).all()
    for i in range(b):
        matched = want[i][want[i] >= 0]
        assert len(matched) == min(q, n_valid[i]) == len(set(matched.tolist()))
        assert (want[i, n_valid[i]:] == -1).all()


@pytest.mark.parametrize("q,m", [(12, 5), (4, 9)])
def test_greedy_equals_greedy_assignment(q, m):
    rng = np.random.default_rng(q + m)
    cost = rng.standard_normal((3, q, m)).astype(np.float32)
    n_valid = np.array([m, 0, 2], np.int32)
    want = np.asarray(jm.greedy_assignment(jnp.asarray(cost), jnp.asarray(n_valid)))
    got = tm._dispatch("greedy", torch.from_numpy(cost), torch.from_numpy(n_valid))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("q,m", [(10, 4), (3, 6)])
def test_ctrl_point_and_box_match_equal_the_jax_matchers(q, m):
    outputs, enc, targets = _outputs_targets(3, q, m, 16, seed=q)
    want = np.asarray(jm.ctrl_point_match(_j(outputs), _j(targets)))
    got = tm.ctrl_point_match(_t(outputs), _t(targets))
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jm.box_match(_j(enc), _j(targets)))
    got = tm.box_match(_t(enc), _t(targets))
    np.testing.assert_array_equal(got.numpy(), want)
    cost, n_valid = tm.box_cost(_t(enc), _t(targets))
    assert tuple(cost.shape) == (3, q, m) and not cost.requires_grad
    np.testing.assert_array_equal(n_valid.numpy(), targets["inst_mask"].sum(-1))


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="unknown matcher"):
        tm._dispatch("auction", torch.zeros((1, 2, 2)), torch.tensor([2]))
