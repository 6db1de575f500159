"""The port's w8a8 serving path (``ops/quant.py``, the quantizable layers,
``ControlLDM``'s quant fields and ``calibrate_quant``) against the JAX
package's, float32 on the CPU.

Every input is seeded numpy; JAX runs as ``tests/test_quant.py`` runs it,
eagerly (``calibrate_quant`` needs concrete activations), all of it in one
module fixture. Tolerances:

- the weight and activation quantizers: bit for bit (the same float32
  divisions and the same round-half-to-even);
- the quantized products on the same inputs: 1 ulp of float32 (the integer
  product is exact on both sides; the rescale is one multiply);
- the tiny quantized ControlNet + UNet (``tests/test_quant.py``'s sizes),
  teacher-forced: the JAX runs record each site's (x8, scale), and the
  port's runs put them in at the same site in place of their own. The two
  packages' float32 activations differ by rounding, about 1e-6 of their
  abs-max, which is 1.3e-4 of one int8 step; so at each site the port's own
  x8 equals JAX's except at elements closer than FRAGILE steps to a
  half-step, where it may differ by one, and its own scale equals JAX's
  within 1e-5 relative (bit for bit on the static path, whose amax is JAX's
  record). With JAX's x8 and scale put in, nothing downstream re-draws a
  rounding, so the calibration record is held within 1e-5 relative at every
  site and the outputs within float32 rounding (1e-5 of max |ref|).
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tair_tpu.models.cldm import ControlLDM as JaxControlLDM
from tair_tpu.ops import quant as jq
from tair_tpu_torch.models.cldm import ControlLDM
from tair_tpu_torch.models.clip import CLIPTextConfig
from tair_tpu_torch.models.layers import QuantConv2d, QuantLinear
from tair_tpu_torch.models.unet import UNetConfig
from tair_tpu_torch.models.vae import VAEConfig
from tair_tpu_torch.ops import quant
from tair_tpu_torch.weights.convert import convert_tree, from_jax_params, module_param_shapes
from test_quant import TINY_CLIP, TINY_UNET, TINY_VAE
from test_torch_common import noise_params, t2n, torch_single_thread  # noqa: F401

FRAGILE = 2e-3  # int8 steps from a half-step: 1.6e-5 of the abs-max, over 10x the float32 drift
MIN_RATIO = 2.0  # selective: a site quantizes when its weight has >= 2x the activation's elements
# (name, kernel size, stride, padding) of the convolution sites: 3x3, the
# stride-2 Downsample, the 1x1 skip / zero convs
CONVS = [("3x3_s1", 3, 1, 1), ("3x3_s2", 3, 2, 1), ("1x1", 1, 1, 0)]


def _inputs():
    """Seeded inputs. The products' operands have the shapes of sites of the
    tiny model (8 x 8 x 32 convolutions, 4 x 4 x 64 tokens), so their JAX
    ops compile once for both."""
    rng = np.random.default_rng(2024)
    w_conv = {name: rng.standard_normal((k, k, 32, 32), dtype=np.float32) * 0.1
              for name, k, _, _ in CONVS}
    for w in w_conv.values():
        w[..., 5] = 0.0  # a zero output channel: scale 1, exact zeros
    return dict(
        w_conv=w_conv,
        x_conv=rng.standard_normal((2, 8, 8, 32), dtype=np.float32),
        w_dense=rng.standard_normal((64, 64), dtype=np.float32) * 0.1,  # [in, out]
        x_dense=rng.standard_normal((2, 16, 64), dtype=np.float32),
        x=rng.standard_normal((2, 8, 8, 4), dtype=np.float32),
        hint=rng.standard_normal((2, 8, 8, 4), dtype=np.float32),
        t=np.asarray([17, 600], np.int32),
        ctx=rng.standard_normal((2, 77, 64), dtype=np.float32),
    )


def _jax_conv(x, w, stride, pad):
    dn = jax.lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
    return jq.w8a8_conv(x, w, (stride, stride), ((pad, pad), (pad, pad)), dimension_numbers=dn)


def _jax_dense(x, w):
    return jq.w8a8_dot_general(x, w, (((x.ndim - 1,), (0,)), ((), ())))


@contextlib.contextmanager
def _jax_sites(sites):
    """Appends each JAX site's (x8, scale) to `sites`, in the order the sites
    run."""
    plain = jq._quant_act

    def recording(x):
        x8, scale = plain(x)
        sites.append((np.array(x8), np.array(scale)))  # writable copies for torch
        return x8, scale

    jq._quant_act = recording
    try:
        yield sites
    finally:
        jq._quant_act = plain


@pytest.fixture(scope="module")
def ref():
    """Everything the tests compare against, from the JAX package: the
    quantizers, the products, and the tiny quantized ControlLDM's calibration
    records with each site's (x8, scale), and its forwards (dynamic,
    selective). A static record replays the dynamic forward bit for bit, so
    the port's static run is held against the dynamic one. Compiled without
    LLVM's expensive passes (each eager op compiles once, and there are
    hundreds); the compile caches are dropped afterwards, so no later test
    of this process runs an executable built so."""
    inp = _inputs()
    jm = JaxControlLDM.create(unet_cfg=TINY_UNET, vae_cfg=TINY_VAE, clip_cfg=TINY_CLIP,
                              dtype=jnp.float32, quantized=True)
    x, hint, t, ctx = (inp[k] for k in ("x", "hint", "t", "ctx"))
    # the JAX trees' names and shapes worked out from the port's modules (no
    # JAX trace; a wrong name fails the JAX forward)
    model = _port_cldm(None)
    params = noise_params({k: module_param_shapes(getattr(model, k))
                           for k in ("unet", "controlnet")}, 2025)
    cond = {"c_txt": ctx, "c_img": hint}
    w_dense, x_conv, x_dense = inp["w_dense"], inp["x_conv"], inp["x_dense"]
    amax = float(np.abs(x_conv).max())
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        out = dict(
            qw_conv=jq._quant_weight(inp["w_conv"]["3x3_s1"], (0, 1, 2)),
            qw_dense=jq._quant_weight(w_dense, (0,)),
            qa_dynamic=jq._quant_act(x_conv),
            qa_zero=jq._quant_act(np.zeros_like(x_conv)),
            conv={name: _jax_conv(x_conv, inp["w_conv"][name], s, p) for name, _, s, p in CONVS},
            dense=_jax_dense(x_dense, w_dense),
        )
        with jq.quantized(True, static_act_amax=0.5 * amax):  # half the range: clips
            out["qa_static"] = jq._quant_act(x_conv)
            out["conv_static"] = _jax_conv(x_conv, inp["w_conv"]["3x3_s1"], 1, 1)
        with jq.quantized(True, static_act_amax=[0.5 * amax, 0.0]):  # per site; amax 0
            out["qa_sites"] = (jq._quant_act(x_conv), jq._quant_act(x_conv))
        sel = dataclasses.replace(jm, quant_min_ratio=MIN_RATIO)
        with _jax_sites([]) as sites:
            out["record"] = jm.calibrate_quant(params, x, t, cond)
        with _jax_sites([]) as sites_sel:
            out["record_sel"] = sel.calibrate_quant(params, x, t, cond)
        out["dynamic"] = jm.apply(params, x, t, cond)
        out["selective"] = sel.apply(params, x, t, cond)
    finally:
        jax.config.update("jax_disable_most_optimizations", before)
        jax.clear_caches()
    out = jax.tree.map(np.asarray, out)
    out["sites"], out["sites_sel"] = sites, sites_sel
    return inp, params, out


def _port_cldm(params, **quant_fields) -> ControlLDM:
    ucfg = UNetConfig(**{f.name: getattr(TINY_UNET, f.name) for f in dataclasses.fields(UNetConfig)})
    model = ControlLDM(
        unet_cfg=ucfg, vae_cfg=VAEConfig(ch=16, ch_mult=(1, 2), num_res_blocks=1),
        clip_cfg=CLIPTextConfig(width=64, layers=2, heads=2), **quant_fields,
    ).eval()
    if params is None:
        return model
    model.unet.load_state_dict(convert_tree(params["unet"]), strict=True)
    model.controlnet.load_state_dict(convert_tree(params["controlnet"]), strict=True)
    return model


def _args(inp):
    cond = {"c_txt": torch.from_numpy(inp["ctx"]), "c_img": torch.from_numpy(inp["hint"])}
    return torch.from_numpy(inp["x"]), torch.from_numpy(inp["t"]), cond


class _Forced:
    """Teacher forcing of the port's activation quantize: at the i-th site
    the port's own (x8, stats) are computed and checked against JAX's i-th
    site, then JAX's x8 and scale go on in their place (the port's own amax
    stays in stats, so a calibration record is the port's)."""

    def __init__(self, sites):
        self.sites, self.used, self.faults = sites, 0, []

    def __call__(self, x2d, amax_const):
        x8, stats = quant.quantize_activation_plain(x2d, amax_const)
        if self.used >= len(self.sites):
            self.faults.append(f"site {self.used}: JAX ran {len(self.sites)} sites")
            return x8, stats
        i, (j8, jscale) = self.used, self.sites[self.used]
        self.used += 1
        c = x2d.shape[1]
        j8 = torch.from_numpy(j8.reshape(-1, c))
        if j8.shape != x2d.shape:
            self.faults.append(f"site {i}: JAX's activation {tuple(j8.shape)}, the port's "
                               f"{tuple(x2d.shape)}")
            return x8, stats
        r = x2d.float() / stats[1]
        fragile = (r - torch.floor(r) - 0.5).abs() < FRAGILE
        d = x8[:, :c].int() - j8.int()
        if ((d != 0) & ~fragile).any() or d.abs().max() > 1:
            self.faults.append(f"site {i}: x8 differs from JAX's beyond a flip at a half-step")
        jscale = torch.from_numpy(np.asarray(jscale, np.float32))
        exact = amax_const is not None  # the static amax is JAX's record: the same division
        if not (torch.equal(stats[1], jscale) if exact else
                torch.allclose(stats[1], jscale, rtol=1e-5, atol=0)):
            self.faults.append(f"site {i}: scale {stats[1].item()} against JAX's {jscale.item()}")
        return F.pad(j8.to(torch.int8), (0, x8.shape[1] - c)), torch.stack([stats[0], jscale])


@contextlib.contextmanager
def _forced(sites):
    forced = _Forced(sites)
    plain = quant.quantize_activation
    quant.quantize_activation = forced
    try:
        yield forced
    finally:
        quant.quantize_activation = plain


@pytest.fixture(scope="module")
def port(ref):
    """The port's runs of the tiny ControlLDM: its own (calibration record,
    dynamic, static on that record, unquantized), and teacher-forced by
    JAX's sites (records, dynamic, selective, static on JAX's record), with
    each forced run's `_Forced` (its site checks)."""
    inp, params, want = ref
    model = _port_cldm(params, quantized=True)
    x, t, cond = _args(inp)
    sel = model.replace(quant_min_ratio=MIN_RATIO)
    static = model.replace(quant_static_amax=tuple(want["record"]))
    with torch.no_grad():
        record = model.calibrate_quant(x, t, cond)
        own = dict(
            dynamic=model.apply(x, t, cond),
            static=model.replace(quant_static_amax=tuple(record)).apply(x, t, cond),
            exact=model.replace(quantized=False).apply(x, t, cond),
        )
        forced = {}
        for name, run, sites in (
            ("record", lambda: model.calibrate_quant(x, t, cond), want["sites"]),
            ("record_sel", lambda: sel.calibrate_quant(x, t, cond), want["sites_sel"]),
            ("dynamic", lambda: model.apply(x, t, cond), want["sites"]),
            ("selective", lambda: sel.apply(x, t, cond), want["sites_sel"]),
            ("static", lambda: static.apply(x, t, cond), want["sites"]),
        ):
            with _forced(sites) as check:
                forced[name] = (run(), check)
    return model, record, own, forced


def _oihw(w_hwio: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


def _nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def test_weight_quantizer_equals_jax(ref):
    inp, _, want = ref
    w8, scale = quant._quant_weight(_oihw(inp["w_conv"]["3x3_s1"]), (1, 2, 3))
    np.testing.assert_array_equal(w8.numpy().transpose(2, 3, 1, 0), want["qw_conv"][0])
    np.testing.assert_array_equal(scale.numpy(), want["qw_conv"][1])
    assert scale[5] == 1.0 and not w8[5].any()  # the zero channel
    w8, scale = quant._quant_weight(torch.from_numpy(inp["w_dense"].T.copy()), (1,))
    np.testing.assert_array_equal(w8.numpy().T, want["qw_dense"][0])
    np.testing.assert_array_equal(scale.numpy(), want["qw_dense"][1])


@pytest.mark.parametrize("case", ["dynamic", "zero", "static", "sites"])
def test_activation_quantizer_equals_jax(ref, case):
    """Dynamic, a zero tensor (scale 1), a static amax at half the range
    (clipped to +-127), and per-site static entries (the second 0: scale 1)."""
    inp, _, want = ref
    x = torch.from_numpy(inp["x_conv"].reshape(-1, 32))  # [rows, C], C a multiple of 16

    def site_act(x2d):  # as a site quantizes: the scope's static entry, then Q2
        return quant.quantize_activation(x2d, quant._static_entry())

    if case == "dynamic":
        pairs = [(site_act(x), want["qa_dynamic"])]
    elif case == "zero":
        pairs = [(site_act(torch.zeros_like(x)), want["qa_zero"])]
    elif case == "static":
        with quant.quantized(True, static_act_amax=0.5 * float(x.abs().max())):
            pairs = [(site_act(x), want["qa_static"])]
        assert want["qa_static"][0].max() == 127
    else:
        with quant.quantized(True, static_act_amax=[0.5 * float(x.abs().max()), 0.0]):
            pairs = list(zip((site_act(x), site_act(x)), want["qa_sites"]))
    for (x8, stats), (w8, wscale) in pairs:
        assert x8.dtype == torch.int8 and x8.shape == x.shape
        np.testing.assert_array_equal(x8.numpy().reshape(w8.shape), w8)
        np.testing.assert_array_equal(stats[1].numpy(), wscale)


@pytest.mark.parametrize("name,k,stride,pad", CONVS)
def test_conv_equals_jax(ref, name, k, stride, pad):
    inp, _, want = ref
    got = quant.w8a8_conv2d(_nchw(inp["x_conv"]), _oihw(inp["w_conv"][name]), None, stride, pad)
    np.testing.assert_array_max_ulp(t2n(got).transpose(0, 2, 3, 1), want["conv"][name])
    if name == "3x3_s1":
        with quant.quantized(True, static_act_amax=0.5 * float(np.abs(inp["x_conv"]).max())):
            got = quant.w8a8_conv2d(_nchw(inp["x_conv"]), _oihw(inp["w_conv"][name]), None, 1, 1)
        np.testing.assert_array_max_ulp(t2n(got).transpose(0, 2, 3, 1), want["conv_static"])


def test_linear_equals_jax(ref):
    inp, _, want = ref
    got = quant.w8a8_linear(torch.from_numpy(inp["x_dense"]),
                            torch.from_numpy(inp["w_dense"].T.copy()))
    np.testing.assert_array_max_ulp(t2n(got), want["dense"])


@pytest.mark.parametrize("name,k,stride,pad", CONVS)
def test_kernel_layout_plain_versions_equal_the_product(name, k, stride, pad):
    """What the card runs, through the kernels' plain versions: a site
    (``w8a8_site``, one library call on the card) is Q2, which writes the
    activation channels-last, 8 channels padded to 16, then Q1, which reads
    that and the padded weight layout and applies the epilogue with the
    bias. Bit-equal to the integer convolution of the same int8 values
    (float64 F.conv2d, exact) rescaled as the JAX package does."""
    rng = np.random.default_rng(2026)
    x = torch.from_numpy(rng.standard_normal((2, 10, 10, 8), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 8, k, k), dtype=np.float32) * 0.1)
    bias = torch.linspace(-1.0, 1.0, 16)
    got = quant.w8a8_conv2d(x.permute(0, 3, 1, 2), w, bias, stride, pad)
    b, h, wd, c = x.shape
    x8, stats = quant.quantize_activation(x.reshape(-1, c), None)
    assert x8.shape == (b * h * wd, 16) and not x8[:, c:].any()
    assert stats[0] == x.abs().max() and stats[1] == stats[0] / torch.tensor(127.0)
    w8, wscale = quant._quant_weight(w, (1, 2, 3))
    assert torch.equal(quant.kernel_layout(w8)[..., :c], w8.permute(0, 2, 3, 1))
    site, site_stats = quant.w8a8_site(x.reshape(-1, c), (b, h, wd), quant.kernel_layout(w8),
                                       wscale, bias, torch.float32, stride, pad, None)
    assert torch.equal(site_stats, stats) and torch.equal(site.permute(0, 3, 1, 2), got)
    acc = torch.nn.functional.conv2d(x8[:, :c].reshape(b, h, wd, c).permute(0, 3, 1, 2).double(),
                                     w8.double(), None, stride, pad)
    want = (acc.float() * (wscale * stats[1])[:, None, None]).float() + bias[:, None, None]
    assert torch.equal(got, want)


# (M, N, K) of the distinct int8 products of a 512 x 512 ControlNet + UNet step
STEP_PRODUCTS = [
    (4096, 320, 144), (4096, 320, 320), (4096, 320, 2880), (77, 320, 1024), (4096, 2560, 320),
    (4096, 320, 1280), (1024, 320, 2880), (1024, 320, 320), (1024, 640, 2880), (1024, 640, 5760),
    (1024, 640, 320), (1024, 640, 640), (77, 640, 1024), (1024, 5120, 640), (1024, 640, 2560),
    (256, 640, 5760), (256, 640, 640), (256, 1280, 5760), (256, 1280, 11520), (256, 1280, 640),
    (256, 1280, 1280), (77, 1280, 1024), (256, 10240, 1280), (256, 1280, 5120),
    (64, 1280, 11520), (64, 1280, 1280), (64, 10240, 1280), (64, 1280, 5120),
    (64, 1280, 23040), (64, 1280, 2560), (256, 1280, 23040), (256, 1280, 2560),
    (256, 1280, 17280), (256, 1280, 1920), (1024, 1280, 11520), (1024, 640, 17280),
    (1024, 640, 1920), (1024, 640, 11520), (1024, 640, 1280), (1024, 640, 8640), (1024, 640, 960),
    (4096, 640, 5760), (4096, 320, 8640), (4096, 320, 960), (4096, 320, 5760), (4096, 320, 640),
    (4096, 4, 2880),
]


def test_split_k_splits_the_inner_blocks_only():
    """Q1's schedule at 512 x 512: the 8 x 8 and 16 x 16 levels' 3x3 convs
    (M = 64 and 256, N = 1280, K = 11,520) split K inside the launch; the
    64 x 64 level's dense layers and its feed-forward input (M = 4096) fill
    the card with one split."""
    assert quant.conv_schedule(64, 1280, 9 * 1280)[1] > 1
    assert quant.conv_schedule(256, 1280, 9 * 1280)[1] > 1
    assert quant.conv_schedule(4096, 320, 320, gather=False)[1] == 1
    assert quant.conv_schedule(4096, 2560, 320, gather=False)[1] == 1
    assert quant.gathered(3, 3, 1, 1) and quant.gathered(1, 1, 2, 0)
    assert not quant.gathered(1, 1, 1, 0)


@pytest.mark.parametrize("m,n,k", STEP_PRODUCTS + [(5, 6, 16), (300, 130, 48), (1, 4, 4096)])
@pytest.mark.parametrize("gather", [True, False])
def test_conv_schedule_covers_k_once(m, n, k, gather):
    """Every split holds at least one 128-byte K step and the splits hold
    them all; a split launch makes at most one wave of the 132 SMs, with at
    most MAX_SPLITS splits a tile (one thread block cluster), and at most
    MAX_CLUSTERED_BLOCKS blocks in clusters of more than two."""
    bn, splits, per = quant.conv_schedule(m, n, k, gather)
    steps = -(-k // quant.CONV_BK)
    assert bn in quant.CONV_BN and per >= 1
    assert (splits - 1) * per < steps <= splits * per
    if splits > 1:
        blocks = -(-m // quant.CONV_BM) * -(-n // bn) * splits
        assert splits <= quant.MAX_SPLITS and per >= quant.MIN_SPLIT_STEPS and blocks <= 132
        assert splits <= 2 or blocks <= quant.MAX_CLUSTERED_BLOCKS


def emulate_q1_blocks(x8, w8, stats, wscale, bias, dtype, stride, pad, schedule):
    """Q1's block program (int8_conv.cu) on the CPU: for each 128 x bn tile
    and each split of its 128-byte K steps, the im2col rows gathered in
    16-byte pieces of one tap (zero outside the image and past K) times the
    weight rows (zero past O), summed in int64 over the split's steps; the
    splits' sums added as the workspace adds them; the epilogue on the total.
    Edit it with csrc/int8_conv.cu."""
    b, h, w, cp = x8.shape
    o, kh, kw, _ = w8.shape
    bn, splits, per = schedule
    ho, wo = (h + 2 * pad - kh) // stride + 1, (w + 2 * pad - kw) // stride + 1
    m_total, k_total = b * ho * wo, kh * kw * cp
    xpad = F.pad(x8.long(), (0, 0, pad, pad, pad, pad))  # zero outside the image
    wk = w8.long().reshape(o, k_total)
    acc = torch.zeros(m_total, o, dtype=torch.int64)
    for m0 in range(0, m_total, quant.CONV_BM):
        rows = torch.arange(m0, min(m0 + quant.CONV_BM, m_total))
        bi, rem = rows // (ho * wo), rows % (ho * wo)
        oy, ox = rem // wo, rem % wo
        for n0 in range(0, o, bn):
            cols = slice(n0, min(n0 + bn, o))
            for z in range(splits):
                part = torch.zeros(len(rows), cols.stop - n0, dtype=torch.int64)
                for step in range(z * per, min((z + 1) * per, -(-k_total // quant.CONV_BK))):
                    for piece in range(quant.CONV_BK // 16):
                        k = step * quant.CONV_BK + piece * 16
                        if k >= k_total:
                            continue
                        tap, c = divmod(k, cp)
                        ky, kx = divmod(tap, kw)
                        a = xpad[bi, oy * stride + ky, ox * stride + kx, c:c + 16]
                        part += a @ wk[cols, k:k + 16].T
                acc[rows, cols] += part
    return quant._rescale(acc.double(), wscale, stats[1], bias, dtype).reshape(b, ho, wo, o)


@pytest.mark.parametrize("shape", [
    ((2, 9, 7, 32), (40, 3, 3), 2, 1),     # stride 2, ragged M, N and K
    ((1, 6, 6, 48), (36, 3, 3), 1, 1),     # K = 432: 4 steps, taps across steps
    ((150, 1, 1, 272), (8, 1, 1), 1, 0),   # a dense layer: two M tiles, a partial K step
])
@pytest.mark.parametrize("forced", [None, (32, 2), (160, 3)])
def test_q1_block_program_equals_the_plain_product(shape, forced):
    """The kernel's tiles, splits and im2col pieces, emulated, give the plain
    version's output bit for bit under the schedule conv_schedule picks and
    under forced (width, splits)."""
    (b, h, w, c), (o, kh, kw), stride, pad = shape
    rng = np.random.default_rng(7)
    x8 = torch.from_numpy(rng.integers(-127, 128, (b, h, w, c), dtype=np.int8))
    w8 = torch.from_numpy(rng.integers(-127, 128, (o, kh, kw, c), dtype=np.int8))
    wscale = torch.from_numpy(rng.uniform(1e-3, 1e-2, o).astype(np.float32))
    stats = torch.tensor([3.0, 3.0 / 127.0])
    bias = torch.from_numpy(rng.standard_normal(o, dtype=np.float32))
    ho, wo = (h + 2 * pad - kh) // stride + 1, (w + 2 * pad - kw) // stride + 1
    schedule = quant.conv_schedule(b * ho * wo, o, kh * kw * c,
                                   quant.gathered(kh, kw, stride, pad))
    if forced is not None:
        per = -(-(-(-kh * kw * c // quant.CONV_BK)) // forced[1])
        schedule = (forced[0], -(-(-(-kh * kw * c // quant.CONV_BK)) // per), per)
    want = quant.int8_conv_plain(x8, w8, stats, wscale, bias, torch.float32, stride, pad)
    got = emulate_q1_blocks(x8, w8, stats, wscale, bias, torch.float32, stride, pad, schedule)
    assert torch.equal(got, want)


def _held(got, want, what: str) -> None:
    got, want = t2n(got), np.asarray(want)
    assert got.shape == want.shape, what
    err, bound = np.abs(got - want).max(), 1e-5 * np.abs(want).max()
    assert err <= bound, (what, err, bound)


def _sites_held(check, n_sites: int, what: str) -> None:
    assert not check.faults, (what, check.faults[:5])
    assert check.used == n_sites > 10, what


@pytest.mark.parametrize("run", ["dynamic", "selective", "static"])
def test_quantized_cldm_apply_equals_jax(ref, port, run):
    """Teacher-forced: each site's x8 equal to JAX's but for flips at a
    half-step, its scale JAX's, the outputs within float32 rounding of
    JAX's (the static run, on JAX's record, of JAX's dynamic forward)."""
    _, _, want = ref
    _, _, own, forced = port
    (eps_t, feats_t), check = forced[run]
    eps_j, feats_j = want["selective" if run == "selective" else "dynamic"]
    _sites_held(check, len(want["sites_sel" if run == "selective" else "sites"]), run)
    _held(eps_t, eps_j, f"{run} eps")
    assert len(feats_t) == len(feats_j) == 2
    for i, (g, w) in enumerate(zip(feats_t, feats_j)):
        _held(g, w, f"{run} feat {i}")
    # quantization is on: the output is not the exact forward's
    assert not torch.equal(eps_t, own["exact"][0])


@pytest.mark.parametrize("which", ["record", "record_sel"])
def test_calibration_record_equals_jax(ref, port, which):
    _, _, want = ref
    _, _, _, forced = port
    record, check = forced[which]
    got, exp = np.asarray(record), np.asarray(want[which])
    _sites_held(check, len(want["sites_sel" if which == "record_sel" else "sites"]), which)
    assert len(got) == len(exp) > 10
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=0)
    if which == "record_sel":
        assert 0 < len(got) < len(want["record"])  # the gate skips real sites


def test_calibration_max_merges_and_static_replays_dynamic(ref, port):
    """A second calibration pass max-merges in place; the record replayed as
    static amax reproduces the dynamic forward bit for bit."""
    inp, _, _ = ref
    model, first, own, _ = port
    record = list(first)
    with torch.no_grad():
        again = model.calibrate_quant(*_args(inp), record=record)
    assert again is record and record == first
    assert torch.equal(own["static"][0], own["dynamic"][0])
    for a, b in zip(own["static"][1], own["dynamic"][1]):
        assert torch.equal(a, b)


def test_errors_match_jax(ref, port):
    inp, _, _ = ref
    model = port[0]
    with pytest.raises(ValueError, match="quant site"), torch.no_grad():
        model.replace(quant_static_amax=(1.0, 2.0)).apply(*_args(inp))
    for scope in (jq.quantized, quant.quantized):
        with pytest.raises(ValueError, match="mutually exclusive"):
            with scope(True, static_act_amax=1.0, calibrate=[]):
                pass
    assert not quant.active() and quant.static_act_amax() is None


def test_scope_off_is_the_default_forward_bit_for_bit(ref, port):
    inp, params, _ = ref
    model, _, own, _ = port
    default = _port_cldm(params)
    with torch.no_grad():
        eps, feats = default.apply(*_args(inp))
    assert torch.equal(eps, own["exact"][0])
    assert all(torch.equal(a, b) for a, b in zip(feats, own["exact"][1]))
    assert not quant.active()
    assert list(default.state_dict()) == list(model.state_dict())
    with pytest.raises(TypeError):
        model.replace(control_scales=(0.0,) * 13)


def test_vae_and_clip_are_never_quantized(port):
    model = port[0]
    for part in (model.vae, model.clip):
        assert not any(isinstance(m, (QuantConv2d, QuantLinear)) for m in part.modules())
    z = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 4, 4, 4), dtype=np.float32))
    tokens = torch.arange(77)[None] % 50
    with torch.no_grad():
        want = model.vae_decode(z), model.clip_encode_tokens(tokens)
        with quant.quantized(True):
            got = model.vae_decode(z), model.clip_encode_tokens(tokens)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_from_jax_params_loads_into_a_quantized_model(ref, port):
    inp, params, _ = ref
    fresh = _port_cldm(params, quantized=True)
    state = from_jax_params({k: params[k] for k in ("unet", "controlnet")})
    missing, unexpected = fresh.load_state_dict(
        {k.removeprefix("cldm."): v for k, v in state.items()}, strict=False)
    assert not unexpected and all(k.startswith(("vae.", "clip.")) for k in missing)
    with torch.no_grad():
        eps, _ = fresh.apply(*_args(inp))
    assert torch.equal(eps, port[2]["dynamic"][0])


def test_weight_cache_follows_in_place_updates():
    """The int8 weight is made once per parameter version, and again after an
    in-place update or a load_state_dict."""
    torch.manual_seed(0)
    layer = QuantConv2d(8, 16, 3, padding=1)
    x = torch.randn(1, 8, 6, 6)

    def fresh_output():
        return quant.w8a8_conv2d(x, layer.weight.detach().clone(), layer.bias, 1, 1)

    with torch.no_grad(), quant.quantized(True):
        first = layer(x)
        cached = layer._wq.value
        assert torch.equal(layer(x), first) and layer._wq.value is cached
        layer.weight.mul_(-2.0)
        assert torch.equal(layer(x), fresh_output()) and not torch.equal(layer(x), first)
        layer.load_state_dict({"weight": torch.randn(16, 8, 3, 3), "bias": layer.bias})
        assert torch.equal(layer(x), fresh_output())
    assert torch.equal(layer(x), torch.nn.functional.conv2d(x, layer.weight, layer.bias, 1, 1))


def test_device_amax_mode_equals_the_dynamic_path_at_equal_amax():
    """Q2's two modes of a row-parallel site, through their plain versions:
    the amax-only pass gives the abs-max (a NaN kept), and quantizing from
    that amax on the device gives the dynamic path's x8 and stats bit for bit
    (the static path's clip never binds there); from a larger amax, the
    static path's at that amax. The amax of two halves of the features is
    the maximum of their amaxes, taken on the floats' bits."""
    rng = np.random.default_rng(2030)
    x = torch.from_numpy(rng.standard_normal((37, 24), dtype=np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        amax = quant.activation_amax(xd)
        assert amax[0] == xd.float().abs().max() and amax[1] == 0
        x8_dyn, stats_dyn = quant.quantize_activation(xd, None)
        x8, stats = quant.quantize_activation(xd, amax.clone())
        assert torch.equal(x8, x8_dyn) and torch.equal(stats, stats_dyn)
        big = torch.stack([amax[0] * 3, amax[1]])
        x8_big, stats_big = quant.quantize_activation(xd, big)
        x8_static, stats_static = quant.quantize_activation(xd, float(big[0]))
        assert torch.equal(x8_big, x8_static) and torch.equal(stats_big, stats_static)
    halves = [quant.activation_amax(x[:, :12]), quant.activation_amax(x[:, 12:])]
    bits = torch.stack([h[:1] for h in halves]).view(torch.int32).amax(0).view(torch.float32)
    assert bits == quant.activation_amax(x)[0]
    x[3, 5] = float("nan")
    nan_amax = quant.activation_amax(x)
    assert nan_amax[0].isnan() and nan_amax[:1].view(torch.int32) > torch.tensor(
        float("inf")).view(torch.int32)
    assert quant.quantize_activation(x, nan_amax)[1][1].isnan()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int32_mode_then_rescale_equals_the_fused_epilogue(dtype):
    """Q1's int32 mode (plain version) gives the accumulators; the sum of the
    accumulators of two halves of K (two row-parallel processes) is the
    whole product's, and `_rescale` after it equals the fused epilogue bit
    for bit, bias included."""
    rng = np.random.default_rng(2031)
    x8 = torch.from_numpy(rng.integers(-127, 128, (50, 1, 1, 64), dtype=np.int8))
    w8 = torch.from_numpy(rng.integers(-127, 128, (24, 1, 1, 64), dtype=np.int8))
    wscale = torch.from_numpy(rng.uniform(1e-3, 1e-2, 24).astype(np.float32))
    stats = torch.tensor([3.0, 3.0 / 127], dtype=torch.float32)
    bias = torch.linspace(-1.0, 1.0, 24).to(dtype)
    acc = quant.int8_conv(x8, w8, wscale, stats, None, torch.int32, 1, 0)
    assert acc.dtype == torch.int32 and acc.shape == (50, 1, 1, 24)
    halves = [quant.int8_conv(x8[..., s].contiguous(), w8[..., s].contiguous(), wscale, stats,
                              None, torch.int32, 1, 0) for s in (slice(0, 32), slice(32, 64))]
    assert torch.equal(halves[0] + halves[1], acc)
    fused = quant.int8_conv(x8, w8, wscale, stats, bias, dtype, 1, 0)
    assert torch.equal(quant._rescale(acc, wscale, stats[1], bias, dtype), fused)
    with pytest.raises(ValueError, match="int32"):
        quant._q1_args((50, 1, 1), w8, wscale, stats, bias.to(torch.int32), torch.int32, 1, 0)
