"""The port's on-device degradation against the JAX package's: the resize
rules of ``jax.image``, blur, unsharp mask, JPEG and both noises given the
same random fields, and the whole two-stage ``degrade_batch`` with every draw
taken from JAX's own keys."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tair_tpu.data import batch_transform as jax_bt
from tair_tpu.data import degradation as jax_deg
from tair_tpu.data import diffjpeg as jax_jpeg
from tair_tpu.data.satext import SyntheticSAText, collate
from tair_tpu_torch.data import batch_transform as torch_bt
from tair_tpu_torch.data import degradation as torch_deg
from tair_tpu_torch.data import diffjpeg as torch_jpeg
from tair_tpu_torch.data import resize as torch_resize
from test_torch_common import t2n, torch_single_thread  # noqa: F401

TOL = 1e-5  # float32 on both sides; summation order only


def _img(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _close(ours, theirs, tol=TOL):
    ours, theirs = t2n(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape
    err = np.abs(ours - theirs).max()
    assert err <= tol, err


@pytest.mark.parametrize("method,antialias", [("linear", True), ("linear", False), ("cubic", False)])
@pytest.mark.parametrize("out_hw", [(7, 29), (19, 11)])  # down and up on each axis, mixed
def test_resize_matches_jax(method, antialias, out_hw):
    x = _img((2, 13, 17, 3))
    want = jax.image.resize(jnp.asarray(x), (2, *out_hw, 3), method, antialias=antialias)
    _close(torch_resize.resize(torch.from_numpy(x), out_hw, method, antialias), want)


@pytest.mark.parametrize("method", ["linear", "cubic"])
@pytest.mark.parametrize("scale,translation", [(0.37, -2.96), (1.75, 3.5)])
def test_scale_and_translate_matches_jax(method, scale, translation):
    x = _img((2, 21, 21, 3), 1)
    s, t = np.float32(scale), np.float32(translation)
    want = jax.image.scale_and_translate(
        jnp.asarray(x), (2, 16, 24, 3), (1, 2), jnp.stack([s, s]), jnp.stack([t, t]),
        method, antialias=True,
    )
    _close(torch_resize.scale_and_translate(torch.from_numpy(x), (16, 24), s, t, method), want)


def test_resize_on_canvas_matches_jax():
    x = _img((1, 24, 24, 3), 2)
    want = jax_deg.resize_on_canvas(jnp.asarray(x), np.float32(0.625), (20, 20))
    _close(torch_deg.resize_on_canvas(torch.from_numpy(x), 0.625, (20, 20)), want)


@pytest.mark.parametrize("n,pad", [(9, 3), (5, 12), (1, 4), (2, 5)])
def test_reflect_pad_reflects_again_like_numpy(n, pad):
    got = torch_deg.reflect_index(n, pad, "cpu").numpy()
    np.testing.assert_array_equal(got, np.pad(np.arange(n), pad, mode="reflect"))


@pytest.mark.parametrize("hw,k", [((16, 20), 7), ((9, 11), 21)])  # the second pads wider than the image
def test_filter2d_matches_jax(hw, k):
    x = _img((2, *hw, 3), 3)
    kern = _img((2, k, k), 4)
    kern /= kern.sum(axis=(1, 2), keepdims=True)
    want = jax_deg.filter2d(jnp.asarray(x), jnp.asarray(kern))
    _close(torch_deg.filter2d(torch.from_numpy(x), torch.from_numpy(kern)), want)


def test_usm_sharpen_matches_jax():
    x = _img((1, 32, 32, 3), 5)
    _close(torch_deg.usm_sharpen(torch.from_numpy(x)), jax_deg.usm_sharpen(jnp.asarray(x)))


def test_diff_jpeg_matches_jax():
    x = _img((2, 24, 40, 3), 6)  # not multiples of 16: edge-padded and cropped back
    q = np.array([35.0, 80.0], np.float32)
    want = jax_jpeg.diff_jpeg(jnp.asarray(x), jnp.asarray(q))
    _close(torch_jpeg.diff_jpeg(torch.from_numpy(x), torch.from_numpy(q)), want)


def test_noises_match_jax_given_the_same_fields():
    # 16 x 16 is the size of both noise stages of the degrade_batch test below,
    # so the two share JAX's compiled samplers
    x = _img((2, 16, 16, 3), 7)
    key = jax.random.PRNGKey(11)
    k1, k2 = jax.random.split(key)
    sigma, scale = np.array([5.0, 25.0], np.float32), np.array([0.5, 2.5], np.float32)
    gray = np.array([0.0, 1.0], np.float32)
    normal = np.array(jax.random.normal(k1, x.shape))
    normal_gray = np.array(jax.random.normal(k2, (2, 16, 16, 1)))
    _close(
        torch_deg.add_gaussian_noise(
            torch.from_numpy(x), torch.from_numpy(sigma), torch.from_numpy(gray),
            normal=torch.from_numpy(normal), normal_gray=torch.from_numpy(normal_gray)),
        jax_deg.add_gaussian_noise(key, jnp.asarray(x), jnp.asarray(sigma), jnp.asarray(gray)),
    )
    xj = jnp.asarray(x)
    base = jnp.clip(jnp.round(xj * 255.0), 0, 255) / 255.0
    luma = jnp.clip(jnp.round((0.299 * xj[..., 0] + 0.587 * xj[..., 1] + 0.114 * xj[..., 2])
                              * 255.0), 0, 255) / 255.0
    counts = np.asarray(jax.random.poisson(k1, base * 256.0), np.float32)
    counts_gray = np.asarray(jax.random.poisson(k2, luma * 256.0), np.float32)
    _close(
        torch_deg.add_poisson_noise(
            torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(gray),
            poisson=torch.from_numpy(counts), poisson_gray=torch.from_numpy(counts_gray)),
        jax_deg.add_poisson_noise(key, jnp.asarray(x), jnp.asarray(scale), jnp.asarray(gray)),
    )


def _jax_draws(rng, b, cfg):
    """The draws of `degrade_batch(rng, ...)` by JAX's own key splits
    (batch_transform.py:127-153 and _noise_stage :93-101)."""
    keys = jax.random.split(rng, 12)

    def noise(key, g_prob, noise_range, poisson_range, gray_prob):
        k_pick, k_sig, k_scale, k_gray, _ = jax.random.split(key, 5)
        return dict(
            use_gauss=bool(jax.random.uniform(k_pick) < g_prob),
            sigma=np.array(jax.random.uniform(k_sig, (b,), minval=noise_range[0],
                                                maxval=noise_range[1])),
            scale=np.array(jax.random.uniform(k_scale, (b,), minval=poisson_range[0],
                                                maxval=poisson_range[1])),
            gray=np.array((jax.random.uniform(k_gray, (b,)) < gray_prob).astype(jnp.float32)),
        )

    return dict(
        scale1=np.float32(jax_bt._draw_scale(keys[0], cfg.resize_prob, *cfg.resize_range)),
        method1=int(jax.random.randint(keys[1], (), 0, 3)),
        scale2=np.float32(jax_bt._draw_scale(keys[2], cfg.resize_prob2, *cfg.resize_range2)),
        method2=int(jax.random.randint(keys[3], (), 0, 3)),
        jpeg_q1=np.array(jax.random.uniform(keys[5], (b,), minval=cfg.jpeg_range[0],
                                              maxval=cfg.jpeg_range[1])),
        jpeg_q2=np.array(jax.random.uniform(keys[6], (b,), minval=cfg.jpeg_range2[0],
                                              maxval=cfg.jpeg_range2[1])),
        do_blur2=bool(jax.random.uniform(keys[7]) < cfg.second_blur_prob),
        order_first=bool(jax.random.uniform(keys[8]) < 0.5),
        noise1=noise(keys[9], cfg.gaussian_noise_prob, cfg.noise_range,
                     cfg.poisson_scale_range, cfg.gray_noise_prob),
        noise2=noise(keys[10], cfg.gaussian_noise_prob2, cfg.noise_range2,
                     cfg.poisson_scale_range2, cfg.gray_noise_prob2),
    )


# lq passes round(x * 255) and the JPEG rounding surrogate, which are
# discontinuous: where float32 summation order moves a value across a rounding
# boundary, one JPEG coefficient steps by a quantisation step or a pixel by
# 1/255, and the resizes after it spread the step over its neighbours. So lq
# is held by share: at least LQ_SHARE of its elements within LQ_TOL, and every
# element within LQ_BOUND (a coefficient step of the coarsest quantisation,
# 0.75 * 99 * 5000 / 30 / 100 / 8 grey levels, rounded up, in [0, 1] units).
LQ_TOL, LQ_SHARE, LQ_BOUND = 1e-4, 0.99, 0.25


def _branches(draws):
    """The branches a set of draws takes: (order_first, do_blur2, Gaussian
    noise in stage 1, in stage 2, resize method of stage 1, of stage 2, scale
    choice of stage 1, of stage 2)."""
    def choice(scale):
        return "up" if scale > 1 else "down" if scale < 1 else "keep"

    return (draws["order_first"], draws["do_blur2"], draws["noise1"]["use_gauss"],
            draws["noise2"]["use_gauss"], draws["method1"], draws["method2"],
            choice(float(draws["scale1"])), choice(float(draws["scale2"])))


# key -> the branches its draws take. Key 5, and 2, 4 and 31: the first three
# keys in order that together take both sides of every branch, every resize
# method and every scale choice in each stage.
DEGRADE_KEYS = {
    5: (True, True, True, False, 0, 1, "down", "keep"),
    2: (True, False, True, True, 2, 1, "up", "up"),
    4: (False, True, True, False, 0, 0, "down", "keep"),
    31: (False, True, False, False, 1, 2, "keep", "down"),
}


def test_degrade_keys_take_every_branch():
    sides = [set(col) for col in zip(*(DEGRADE_KEYS[k] for k in (2, 4, 31)))]
    assert [len(s) for s in sides] == [2, 2, 2, 2, 3, 3, 3, 3], sides


@pytest.mark.parametrize("key", list(DEGRADE_KEYS))
def test_degrade_batch_matches_jax(monkeypatch, key):
    cfg = jax_bt.DegradationConfig()
    batch = collate([SyntheticSAText(size=64, length=2, seed=0)[i] for i in range(2)], 4)
    rng = jax.random.PRNGKey(key)
    draws = _jax_draws(rng, 2, cfg)
    assert _branches(draws) == DEGRADE_KEYS[key]

    # run the JAX function op by op: branch on the drawn indices in Python
    # (compiling all lax.switch branches at once takes minutes on a CPU) and
    # keep the noise fields it draws, to hand the same ones to the port
    fields = []

    def keep(fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            fields.append(np.array(out, np.float32))
            return out
        return wrapped

    monkeypatch.setattr(jax.lax, "switch", lambda i, branches, *ops: branches[int(i)](*ops))
    monkeypatch.setattr(jax.lax, "cond", lambda p, a, b, *ops: (a if bool(p) else b)(*ops))
    monkeypatch.setattr(jax.random, "normal", keep(jax.random.normal))
    monkeypatch.setattr(jax.random, "poisson", keep(jax.random.poisson))
    gt_j, lq_j = jax_bt.degrade_batch(
        rng, *(jnp.asarray(batch[k]) for k in ("hq", "kernel1", "kernel2", "sinc_kernel")), cfg)

    assert len(fields) == 4
    for stage, (a, b) in (("noise1", fields[:2]), ("noise2", fields[2:])):
        names = ("normal", "normal_gray") if draws[stage]["use_gauss"] else ("poisson", "poisson_gray")
        draws[stage].update({names[0]: torch.from_numpy(a), names[1]: torch.from_numpy(b)})
    gt_t, lq_t = torch_bt.degrade_batch(
        *(torch.from_numpy(batch[k]) for k in ("hq", "kernel1", "kernel2", "sinc_kernel")),
        torch_bt.DegradationConfig(), draws=draws,
    )
    _close(gt_t, gt_j)
    err = np.abs(t2n(lq_t) - np.asarray(lq_j))
    share = float((err <= LQ_TOL).mean())
    print(f"degrade_batch key {key} lq: {share:.6f} of elements within {LQ_TOL}, max |d| {err.max():.3g}")
    assert lq_t.shape == (2, 64, 64, 3) and share >= LQ_SHARE and err.max() <= LQ_BOUND
    assert float(lq_t.min()) >= 0.0 and float(lq_t.max()) <= 1.0


def test_snap_reaches_the_jax_sizes():
    """Every drawn scale lands on the size the JAX function's switch picks."""
    for s, lo, hi in ((256, 0.15, 1.5), (64, 0.3, 1.2), (512, 0.15, 1.5)):
        step = max(8, s // 16)
        grid = jax_bt._size_grid(s * lo, s * hi, step)
        np.testing.assert_array_equal(torch_bt._size_grid(s * lo, s * hi, step), grid)
        for scale in np.linspace(lo, hi, 97, dtype=np.float32):
            n = jnp.clip(jnp.round(s * jnp.float32(scale) / step).astype(jnp.int32) * step,
                         int(grid[0]), int(grid[-1]))
            assert torch_bt._snap(s, scale, step, grid) == int(n)


def test_degrade_batch_draws_on_its_own():
    batch = collate([SyntheticSAText(size=64, length=1, seed=1)[0]], 4)
    args = [torch.from_numpy(batch[k]) for k in ("hq", "kernel1", "kernel2", "sinc_kernel")]
    cfg = torch_bt.DegradationConfig()
    outs = [torch_bt.degrade_batch(*args, cfg, rng=np.random.default_rng(3),
                                   generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="draws"):
        torch_bt.degrade_batch(*args, cfg)
