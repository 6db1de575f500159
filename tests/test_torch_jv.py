"""The port's exact matcher against the JAX package's on-device Jonker-Volgenant
solve (``tair_tpu.spotter.matcher.jv_assignment``): the plain version of
kernel J1 (``jv_assignment_reference``), and the default matcher
("hungarian" / "jv") that runs it on CPU tensors, equal to JAX's assignment
element for element, on float costs and on integer costs full of ties, in both
orientations (M <= Q target-major, M > Q query-major), with all-padded rows
and n_valid = 0. The (Q, M) pairs are those of ``tests/test_jv_matcher.py``
plus the stage-3 config's (100, 32). Each JAX shape is compiled once."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tair_tpu.spotter import matcher as jm
from tair_tpu_torch.spotter import matcher as tm
from test_torch_common import torch_single_thread  # noqa: F401

PAIRS = [(8, 8), (20, 7), (100, 16), (5, 1), (3, 5), (8, 32), (100, 128), (1, 4), (100, 32)]


@functools.lru_cache(maxsize=None)
def _jax_jv():
    return jax.jit(jm.jv_assignment)  # one compile per shape, shared by the tests


def _jax(cost, n_valid):
    return np.asarray(_jax_jv()(jnp.asarray(cost), jnp.asarray(n_valid)))


def _costs(q, m, kind, seed):
    rng = np.random.default_rng(seed)
    b = 4
    if kind == "float":
        cost = rng.standard_normal((b, q, m)) * 10
    else:  # integers in {0..3}: most optima tie
        cost = rng.integers(0, 4, (b, q, m))
    # no valid target, every slot valid, one in between, and one past Q when M > Q
    n_valid = np.array([0, m, int(rng.integers(1, m + 1)), max(m // 2, 1)], np.int64)
    return cost.astype(np.float32), n_valid


def test_default_matcher_breaks_ties_as_jax():
    """Integer costs in {0..3} tie between optima in most draws: the default
    matcher must pick JAX's optimum, not merely an optimum of the same cost."""
    differ = []
    for seed in range(200):
        rng = np.random.default_rng(seed)
        cost = rng.integers(0, 4, (2, 12, 5)).astype(np.float32)
        n_valid = np.array([5, 3], np.int32)
        want = _jax(cost, n_valid)
        for impl in ("hungarian", "jv"):
            got = tm._dispatch(impl, torch.from_numpy(cost), torch.from_numpy(n_valid))
            if not np.array_equal(got.numpy(), want):
                differ.append((seed, impl))
    assert not differ, f"{len(differ)} of 400 assignments differ from JAX's: {differ[:5]}"


@pytest.mark.parametrize("kind", ["float", "tied"])
@pytest.mark.parametrize("q,m", PAIRS)
def test_plain_j1_equals_jax(q, m, kind):
    cost, n_valid = _costs(q, m, kind, seed=q * 1000 + m)
    want = _jax(cost, n_valid.astype(np.int32))
    got = tm.jv_assignment_reference(torch.from_numpy(cost), torch.from_numpy(n_valid))
    assert got.dtype == torch.long and tuple(got.shape) == (4, m)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[0] == -1).all()  # n_valid = 0
    for i in range(4):  # min(Q, n_valid) distinct queries, padding -1
        matched = want[i][want[i] >= 0]
        assert len(matched) == min(q, n_valid[i]) == len(set(matched.tolist()))
        assert (want[i, n_valid[i]:] == -1).all()


@pytest.mark.parametrize("q,m", [(12, 5), (4, 9)])  # both orientations
def test_default_dispatch_equals_jax(q, m):
    cost, n_valid = _costs(q, m, "tied", seed=7)
    want = _jax(cost, n_valid.astype(np.int32))
    for impl in ("hungarian", "jv"):
        got = tm._dispatch(impl, torch.from_numpy(cost), torch.from_numpy(n_valid))
        np.testing.assert_array_equal(got.numpy(), want)


def test_all_padded_rows_and_empty_batches():
    """Every target padded (n_valid = 0), a single query, and empty batches."""
    cost = np.ones((1, 4, 3), np.float32)
    got = tm.jv_assignment_reference(torch.from_numpy(cost), torch.tensor([0]))
    np.testing.assert_array_equal(got.numpy(), _jax(cost, np.array([0], np.int32)))
    assert (got == -1).all()
    for shape in ((0, 5, 3), (0, 3, 5), (2, 5, 0)):
        got = tm.jv_assignment_reference(torch.zeros(shape), torch.zeros(shape[0], dtype=torch.long))
        assert tuple(got.shape) == (shape[0], shape[2])


def test_plain_j1_counts_the_work_it_does():
    """`stats` counts the search steps and the relaxed columns (the chip
    run's operation count); at most Q steps a row."""
    cost, n_valid = _costs(20, 7, "float", seed=3)
    stats = {}
    tm.jv_assignment_reference(torch.from_numpy(cost), torch.from_numpy(n_valid), stats)
    assert 0 < stats["steps"] <= 4 * 7 * 20  # B * M rows, Q steps at most each
    assert stats["steps"] <= stats["relaxed"] <= stats["steps"] * 20


def test_kernel_wrapper_never_falls_back():
    """On a tensor that lies neither on the CPU nor on a CUDA device the
    default matcher raises; it never takes the plain version."""
    cost = torch.zeros((1, 4, 3), device="meta")
    with pytest.raises(ValueError, match="J1 runs on CUDA tensors"):
        tm.jv_assignment(cost, torch.tensor([3], device="meta"))
