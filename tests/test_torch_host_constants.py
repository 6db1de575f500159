"""The port's device constants (``utils/device_constants.py``): a constant
that a module used to copy from the host on every call (SwinIR's shift mask
and mean, the unsharp-mask and colour-fix blur kernels, DISTS' pooling
window, the Swin tables of MANIQA and RAM++, ``diff_jpeg``'s tables, a
diffusion schedule's buffers, the tile window of tiled sampling) is made once
per key and device: equal to a fresh build, the same tensor on a second call
with the same key, a new one for another shape; the cache is bounded in
bytes. The resize weights, which vary with the image size, are copied per
call and not kept. The values against JAX stay with each module's own parity
tests."""

import numpy as np
import pytest
import torch

from tair_tpu_torch import tiling
from tair_tpu_torch.data import degradation, diffjpeg, resize
from tair_tpu_torch.diffusion.diffusion import Diffusion
from tair_tpu_torch.diffusion.schedules import DiffusionSchedule
from tair_tpu_torch.models import swinir
from tair_tpu_torch.utils import device_constants as dc
from tair_tpu_torch.utils import dists, maniqa, metrics
from test_torch_common import torch_single_thread  # noqa: F401

CPU = torch.device("cpu")


def _tiny_swinir():
    torch.manual_seed(0)
    return swinir.SwinIR(swinir.SwinIRConfig(embed_dim=16, depths=(2,), num_heads=(2,),
                                             window_size=4, num_feat=8)).eval()


SWINIR = _tiny_swinir()


def _swinir(size):
    with torch.no_grad():
        SWINIR(torch.zeros((1, size, 64, 3)))
    return {
        ("swinir_shift_mask", size // 8, 8, 4, 2): swinir._shift_attn_mask(size // 8, 8, 4, 2),
        ("swinir_mean",): np.array(swinir._MEAN, np.float32),
    }


def _usm(radius):
    degradation.usm_sharpen(torch.zeros((1, 16, 16, 3)), radius=radius)
    g = degradation._gaussian_kernel_1d(radius)
    return {("usm_kernel", radius): np.outer(g, g)}


def _binomial(radius):
    metrics._gaussian_blur(torch.zeros((1, 8, 8, 3)), radius)
    k = np.array([0.25, 0.5, 0.25], np.float32)
    return {("binomial_3x3",): np.outer(k, k)}


def _hann(size):
    dists._l2_pool(torch.ones((1, 2, 8, 8)), size=size)
    w = np.outer(np.hanning(size)[1:-1], np.hanning(size)[1:-1])
    return {("dists_hann", size): (w / w.sum()).astype(np.float32)}


def _swin_tables(window):
    maniqa._on_device("index", CPU, window)
    maniqa._on_device("mask", CPU, 2 * window, 2 * window, window, window // 2)
    return {
        ("swin_index", window): maniqa._rel_pos_index(window).reshape(-1),
        ("swin_mask", 2 * window, 2 * window, window, window // 2):
            maniqa._shift_mask(2 * window, 2 * window, window, window // 2),
    }


def _schedule(steps):
    """Two Diffusion objects of one schedule share its device buffers."""
    schedule = DiffusionSchedule.create(timesteps=steps)
    t, z = torch.tensor([steps - 1]), torch.zeros((1, 2, 2, 1))
    for _ in range(2):
        Diffusion(schedule=schedule).q_sample(z, t, z)
    return {("diffusion", name, np.asarray(getattr(schedule, name), np.float32).tobytes()):
            np.asarray(getattr(schedule, name), np.float32)
            for name in ("sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod")}


def _tile_window(size):
    tiling.make_tiled_fn(lambda x: x, size, size // 2)(torch.zeros((1, size + 4, size, 1)))
    return {("gaussian_window", size): tiling.gaussian_window(size)}


def _jpeg(name):
    diffjpeg._constant(name, CPU)
    return {("diffjpeg", name): diffjpeg._CONSTANTS[name]}


SITES = {  # name: (call at a size, returning the keys it uses and fresh builds; two sizes)
    "swinir": (_swinir, (64, 128)),
    "usm": (_usm, (5, 7)),
    "colour_fix_blur": (_binomial, (1, 2)),  # one kernel for every dilation
    "dists_window": (_hann, (5, 7)),
    "swin_tables": (_swin_tables, (4, 8)),
    "diffjpeg": (_jpeg, ("dct", "y_table")),
    "diffusion_schedule": (_schedule, (10, 20)),
    "tile_window": (_tile_window, (8, 16)),
}


def _entry(key):
    return next(t for (k, dev, _), t in dc._CACHE.items() if k == key and dev == CPU)


@pytest.mark.parametrize("site", list(SITES))
def test_constant_is_made_once_per_key(site):
    call, (first, second) = SITES[site]
    fresh = call(first)
    held = {key: _entry(key) for key in fresh}
    for key, want in fresh.items():
        np.testing.assert_array_equal(held[key].numpy(), want, err_msg=str(key))
    call(first)
    assert all(_entry(key) is t for key, t in held.items())  # reused, not rebuilt
    other = call(second)  # another shape: another tensor where the constant depends on it
    for key, want in other.items():
        np.testing.assert_array_equal(_entry(key).numpy(), want, err_msg=str(key))
        if key in held:
            assert _entry(key) is held[key]
        else:
            assert all(_entry(key) is not t for t in held.values())


def test_cached_builds_once_per_device_and_dtype_and_to_device_moves_tensors():
    builds = []

    def build():
        builds.append(1)
        return np.arange(4, dtype=np.float64)

    a = dc.cached(("test_constant",), "cpu", build)
    b = dc.cached(("test_constant",), CPU, build)
    c = dc.cached(("test_constant",), CPU, build, torch.float32)
    assert a is b and len(builds) == 2 and a.dtype == torch.float64
    assert c.dtype == torch.float32 and torch.equal(c, torch.arange(4.0))
    t = torch.ones(3)
    assert dc.to_device(t, CPU) is t
    assert dc.to_device(np.ones(3, np.float64), CPU, torch.float32).dtype == torch.float32


def test_cached_is_bounded_in_bytes(monkeypatch):
    monkeypatch.setattr(dc, "_CACHE", type(dc._CACHE)())
    monkeypatch.setattr(dc, "MAX_BYTES", 3 * 4 * 8)  # three float32 [8] entries
    held = [dc.cached(("bounded", k), CPU, lambda: np.zeros(8, np.float32)) for k in range(3)]
    assert [k for (k, _, _) in dc._CACHE] == [("bounded", k) for k in range(3)]
    dc.cached(("bounded", 0), CPU, lambda: np.zeros(8, np.float32))  # used: now the newest
    dc.cached(("bounded", 3), CPU, lambda: np.zeros(8, np.float32))
    assert [k for (k, _, _) in dc._CACHE] == [("bounded", k) for k in (2, 0, 3)]
    assert dc._CACHE[(("bounded", 0), CPU, None)] is held[0]
    big = dc.cached(("bounded", "big"), CPU, lambda: np.zeros(64, np.float32))
    assert list(dc._CACHE.values()) == [big]  # the newest stays, however large


@pytest.mark.parametrize("entry", ["resize", "scale_and_translate"])
def test_resize_weights_are_copied_per_call_and_not_kept(entry, monkeypatch):
    copied = []

    def record(array, device, dtype=None):
        copied.append(np.array(array))
        return dc.to_device(array, device, dtype)

    monkeypatch.setattr(resize, "to_device", record)
    img = torch.arange(7 * 6, dtype=torch.float32).reshape(1, 7, 6, 1)
    if entry == "resize":
        got = resize.resize(img, (5, 4), "cubic")
        want = [resize.weight_matrix(7, 5, np.float32(1.0 / (5 / 7)), np.float32(0.0), "cubic",
                                     True),
                resize.weight_matrix(6, 4, np.float32(1.0 / (4 / 6)), np.float32(0.0), "cubic",
                                     True)]
    else:
        got = resize.scale_and_translate(img, (5, 4), 0.75, 0.5, "linear", True)
        inv = np.float32(1.0) / np.float32(0.75)
        want = [resize.weight_matrix(n, n_out, inv, np.float32(0.5), "linear", True)
                for n, n_out in ((7, 5), (6, 4))]
    assert got.shape == (1, 5, 4, 1) and len(copied) == 2
    for c, w in zip(copied, want):
        np.testing.assert_array_equal(c, w)
    np.testing.assert_allclose(got[0, ..., 0].numpy(),
                               want[0].T @ img[0, ..., 0].numpy() @ want[1], rtol=1e-6, atol=1e-5)
    assert not any(k[0] == "resize" for (k, _, _) in dc._CACHE)
