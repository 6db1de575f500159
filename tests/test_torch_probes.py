"""The probes' plain versions at a small size against numpy, and the wrappers'
behaviour on CPU tensors (plain version, no launch counted). The kernels
themselves run only on a CUDA device, where ``chip_smoke.py`` holds each
against the plain version checked here."""

import numpy as np
import pytest
import torch

from tair_tpu_torch.probes import dyngather, msda_lab, stream
from test_torch_common import torch_single_thread  # noqa: F401

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32}


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gather_plain_matches_numpy_take_along_axis(dtype):
    rng = np.random.default_rng(0)
    g, c, r, s, j = 2, 3, 4, 17, 8
    x = rng.standard_normal((g, r, s)).astype(np.float32)
    if dtype == "int32":
        x = (x * 1000).astype(np.int32)
    idx = rng.integers(0, s, (g, c, r, j)).astype(np.int32)
    tx = torch.from_numpy(x).to(DTYPES[dtype])
    want = np.take_along_axis(
        tx.float().numpy()[:, None].repeat(c, axis=1), idx.astype(np.int64), axis=3
    )
    for where in ("global", "shared"):  # on a CPU tensor both take the plain version
        got = dyngather.gather(tx, torch.from_numpy(idx), where)
        assert got.dtype == DTYPES[dtype]
        np.testing.assert_array_equal(got.float().numpy(), want)  # values are moved
    assert dyngather.launches == {"global": 0, "shared": 0}
    wide = dyngather.gather(tx, torch.from_numpy(idx), out_dtype=torch.float32) if dtype == "bfloat16" else None
    if wide is not None:
        assert wide.dtype == torch.float32
        np.testing.assert_array_equal(wide.numpy(), want)


def test_gather_clamps_indices_and_refuses_what_it_does_not_take():
    x = torch.arange(12, dtype=torch.float32).reshape(1, 2, 6)
    idx = torch.tensor([[[[-3, 0, 5, 99], [7, -1, 2, 3]]]], dtype=torch.int32)
    got = dyngather.gather_plain(x, idx)
    np.testing.assert_array_equal(got.numpy(), [[[[0, 0, 5, 5], [11, 6, 8, 9]]]])
    with pytest.raises(TypeError, match="int32"):
        dyngather.gather(x, idx.long())
    with pytest.raises(TypeError, match="no gather"):
        dyngather.gather(x, idx, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="where"):
        dyngather.gather(x, idx, where="l2")
    with pytest.raises(ValueError, match="G and R"):
        dyngather.gather(x, idx[:, :, :1])


@pytest.mark.parametrize("rows", [2048, 5000, 7])
def test_column_sums_plain_matches_numpy(rows):
    g = stream.make_g("cpu", rows=rows, seed=1)
    exact = g.double().numpy().sum(axis=0)
    tol = stream.SUM_RTOL * np.abs(g.double().numpy()).sum(axis=0)
    for kernel in ("strided", "pipeline", "bulk"):  # on a CPU tensor all take the plain version
        got = stream.column_sums(g, kernel)
        assert got.dtype == torch.float32 and got.shape == (stream.COLS,)
        assert (np.abs(got.double().numpy() - exact) <= tol).all()
    assert not any(stream.launches.values())
    held = stream.held(stream.column_sums_plain(g), *stream.reference(g))
    assert held["max_share_of_tol"] <= 1.0


def test_column_sums_tolerance_catches_a_dropped_row():
    g = stream.make_g("cpu", rows=3000, seed=2)
    exact, tol = stream.reference(g)
    short = stream.column_sums_plain(g[:-1])
    with pytest.raises(AssertionError, match="column sums off"):
        stream.held(short, exact, tol)
    assert stream.held(short, exact, tol, enforce=False)["max_share_of_tol"] > 1.0


def _lab_reference(g, ws, k):
    """The reference of the JAX lab's check, in numpy: weight the four corner
    slices, sum them, sum each group of k rows."""
    nq, lanes = ws[0].shape
    d = g.shape[1] // 4
    g5 = g.astype(np.float64).reshape(nq, lanes, 4, d)
    w = np.stack(ws, axis=2).astype(np.float64)  # [NQ, lanes, 4]
    ref = (g5 * w[..., None]).sum(2).reshape(nq, lanes // k, k, d).sum(2)
    return ref.reshape(nq * (lanes // k), d)


@pytest.mark.parametrize("variant", msda_lab.VARIANTS + ("prod",))
def test_lab_plain_matches_numpy(variant):
    nq, lanes, d, k = 5, 32, 8, 4
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.standard_normal((nq * lanes, 4 * d), dtype=np.float32)).bfloat16()
    ws = [torch.from_numpy(rng.random((nq, lanes), dtype=np.float32)) for _ in range(4)]
    gn, wn = g.float().numpy(), [w.numpy() for w in ws]
    got = msda_lab.lab_plain(variant, g, ws, k).numpy()
    if variant == "copy":
        np.testing.assert_array_equal(got, gn.reshape(nq * lanes // k, k, 4 * d)[:, 0, :d])
    elif variant == "seg":
        np.testing.assert_allclose(got, _lab_reference(gn, [np.ones_like(w) for w in wn], k), atol=1e-5)
    elif variant == "w16":
        bound = msda_lab.W16_RTOL * _lab_reference(np.abs(gn), wn, k) + 1e-6
        assert (np.abs(got - _lab_reference(gn, wn, k)) <= bound).all()
        assert np.abs(got - _lab_reference(gn, wn, k)).max() > 1e-4  # it does round
    else:
        np.testing.assert_allclose(got, _lab_reference(gn, wn, k), atol=1e-5)
        from tair_tpu_torch.ops.msda_reduce import msda_corner_reduce_plain

        np.testing.assert_allclose(got, msda_corner_reduce_plain(g, *ws, k).numpy(), atol=1e-5)
    if variant != "prod":
        wrapped = msda_lab.lab(variant, g, ws, k)  # CPU tensor: the plain version
        np.testing.assert_array_equal(wrapped.numpy(), got)
        assert msda_lab.held(variant, wrapped, g, ws, k)["max_share_of_tol"] <= 1.0
    assert not any(msda_lab.launches.values())


@pytest.mark.parametrize("probe", [dyngather, stream, msda_lab], ids=lambda m: m.__name__.split(".")[-1])
def test_probe_runs_its_plain_versions_on_the_cpu_and_needs_a_card_otherwise(probe):
    report = probe.run(device="cpu")
    assert report["device"] == "cpu"
    if torch.cuda.is_available():  # decided inside the test, never at import
        pytest.skip("a CUDA device is present: the default device works here")
    with pytest.raises(RuntimeError, match="CUDA"):
        probe.run()
