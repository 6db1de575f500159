"""w8a8 serving quantization of the UNet and ControlNet convolutions and
dense layers: the scope, the weight and activation quantizers, the
quantized products with their plain versions, and the wrappers of the two
CUDA kernels that compute them on the card.

Counterpart of ``tair_tpu/ops/quant.py``. The arithmetic is the JAX
package's:

  - weights: symmetric int8, one scale per output channel,
    ``scale = amax / 127`` where amax > 0, else 1, ``w8 = round(w / scale)``;
  - activations: symmetric int8, one scale per tensor, from the tensor's
    abs-max (dynamic), or from a fixed amax per site recorded by a
    calibration pass (static, clipped to +-127);
  - an s8 x s8 -> s32 product, then ``float32(acc) * (wscale * xscale)``,
    cast to the compute type, then the bias added in that type (Flax's
    ``nn.Conv`` and ``nn.Dense`` add the bias after the product).

Scopes: ``quantized(on, static_act_amax=, calibrate=)`` switches the
quantizable layers of ``models/layers.py`` onto this module and resets the
site counter (restoring the previous state on exit); ``selective(min_ratio)``
quantizes only the sites whose weight has at least ``min_ratio`` times the
activation's elements. A skipped site takes neither a calibration slot nor a
static entry. Calibration (``calibrate=[...]``) runs the dynamic path and
max-merges each site's observed abs-max into the list, one ``.item()`` a
site: eager only.

On a CUDA tensor a quantized site is one call of ``w8a8_site`` into the
``w8a8`` library, which launches the two kernels (no fallback); each also has
a wrapper of its own:

  ``quantize_activation``  ``csrc/quant_act.cu`` (Q2): the per-tensor abs-max
      and the int8 quantize in one launch (a cooperative grid with a
      grid-wide barrier on the dynamic path), written channels-innermost with
      the channels padded to a multiple of 16, the layout Q1 reads; the scale
      stays on the device (no host synchronisation on the dynamic path);
  ``int8_conv``            ``csrc/int8_conv.cu`` (Q1): the s8 x s8 -> s32
      implicit-GEMM convolution (3 x 3 stride 1 or 2, 1 x 1; a dense layer is
      a 1 x 1 convolution over its tokens) on ``wgmma`` with the weight tile
      loaded by TMA, K split inside the launch where the tiles do not fill
      the card (a tile's splits one cluster, summed in its shared memory;
      ``conv_schedule``), the rescale and the bias in its epilogue.

Under tensor parallelism (``parallel/tp.py``) a row-parallel dense site holds
a slice of the input features, so it computes what the JAX package's
global program does on the whole tensors (`w8a8_linear_row`): Q2's amax-only
mode gives this process's abs-max, an all-reduce (MAX, on the float's bits,
which keeps a NaN) over the model axis makes it the whole activation's, Q2's
device-amax mode quantizes with it (the static path's rounding and clip,
bit-equal to the dynamic path at equal amax), the weight's per-channel
abs-max is the axis' maximum too (`WeightCache` with a group), Q1's int32
mode writes the accumulators, which an all-reduce sums (exactly) before the
epilogue (`_rescale`, bit-equal to Q1's). The site then equals one process's
bit for bit. The selective gate compares the global sizes.

The kernels' scratch (Q2's barrier words, a site's x8) stays on the device
across calls, one set per stream. The weight's int8 copy and scales are made
once per parameter version by ``WeightCache`` (tensor ops; JAX gets the same
from XLA hoisting the quantize out of the sampler's scan). Both devices run
one composition: on CPU tensors ``w8a8_site`` runs the two wrappers' plain
versions, whose integer product is exact in float64.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import List, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import _build

_state = threading.local()

# kernel launches made by the wrappers (never by a plain version): Q2 on the
# dynamic path (abs-max, grid barrier and quantize in one launch) and on the
# static path (the quantize alone), and Q1 (split K included); and the modes
# of a row-parallel site under tensor parallelism: Q2's amax-only and
# device-amax passes, Q1's int32 accumulators
launches = {"act_dynamic": 0, "act_static": 0, "conv": 0, "act_amax": 0, "act_device": 0,
            "conv_acc": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_OUT_CODES = {**_DTYPE_CODES, torch.int32: 2}  # Q1's outputs: the accumulators too
# quant_act_s8's modes (its is_static argument)
_Q2_DYNAMIC, _Q2_STATIC, _Q2_DEVICE_AMAX, _Q2_AMAX_ONLY = 0, 1, 2, 3
CHANNEL_PAD = 16  # Q1 reads 16-byte pieces of one tap: channels padded to 16
# Q2's amax: None (dynamic), a float (static) or a [2] float32 tensor on the
# device holding it at [0] (device amax)
Amax = Union[None, float, torch.Tensor]


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


# ---- scopes ------------------------------------------------------------------


def active() -> bool:
    return getattr(_state, "on", False)


def static_act_amax():
    return getattr(_state, "static_amax", None)


@contextlib.contextmanager
def quantized(on: bool = True, static_act_amax=None, calibrate: Optional[List[float]] = None):
    """Scope within which the quantizable layers run w8a8.

    static_act_amax: one float (every site) or a sequence of per-site floats,
    consumed in execution order, instead of the dynamic abs-max. calibrate: a
    list that each site's observed abs-max is appended to (or max-merged
    into, on a repeat pass), in the order static_act_amax consumes them."""
    if calibrate is not None and static_act_amax is not None:
        raise ValueError("calibrate and static_act_amax are mutually exclusive")
    prev = (active(), getattr(_state, "static_amax", None),
            getattr(_state, "calib", None), getattr(_state, "site", 0))
    _state.on, _state.static_amax, _state.calib, _state.site = on, static_act_amax, calibrate, 0
    try:
        yield
    finally:
        _state.on, _state.static_amax, _state.calib, _state.site = prev


def _next_site() -> int:
    i = getattr(_state, "site", 0)
    _state.site = i + 1
    return i


def min_weight_act_ratio() -> Optional[float]:
    return getattr(_state, "min_ratio", None)


@contextlib.contextmanager
def selective(min_ratio: Optional[float]):
    """Quantize only the sites with weight.numel() >= min_ratio *
    activation.numel() (None: every site). Calibrate under the same scope
    you serve with: skipped sites take no slot of the record."""
    prev = getattr(_state, "min_ratio", None)
    _state.min_ratio = min_ratio
    try:
        yield
    finally:
        _state.min_ratio = prev


def _selective_skip(x: torch.Tensor, w: torch.Tensor, sizes=None) -> bool:
    """Whether the selective gate skips the site; `sizes`: the (activation,
    weight) element counts of the whole tensors where `x` and `w` are one
    process's slices (tensor parallelism)."""
    r = min_weight_act_ratio()
    x_size, w_size = sizes or (x.numel(), w.numel())
    return r is not None and w_size < r * x_size


def _static_entry() -> Optional[float]:
    """This site's static amax (advancing the site counter for a per-site
    sequence), or None on the dynamic path."""
    amax = static_act_amax()
    if amax is None or isinstance(amax, (int, float)):
        return amax
    site = _next_site()
    try:
        return float(amax[site])
    except IndexError:
        raise ValueError(
            f"static_act_amax has {len(amax)} entries but the program reached quant "
            f"site {site}: calibrate with the same model config (quant.quantized(calibrate=...))"
        ) from None


def _record(amax: torch.Tensor) -> None:
    """Max-merge this site's observed abs-max into the calibration list."""
    calib = getattr(_state, "calib", None)
    if calib is None:
        return
    site = _next_site()
    observed = float(amax.item())
    if site < len(calib):
        calib[site] = max(calib[site], observed)
    else:
        calib.append(observed)


# ---- plain versions ------------------------------------------------------------


def _over_127(a: torch.Tensor) -> torch.Tensor:
    """a / 127 as one IEEE division. A Python number as the divisor would let
    PyTorch's CUDA kernel multiply by its reciprocal instead, which differs
    from the division in the last bit for some values."""
    return a / a.new_full((), 127.0)


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """`t` (float32 abs-maxima: >= 0 or a NaN with its sign cleared) set in
    place to its maximum over `group`, on the floats' bits: such floats
    order as their int32 bits do, a NaN above everything, so a NaN survives
    (a float MAX may drop it). No host synchronisation."""
    dist.all_reduce(t.view(torch.int32), op=dist.ReduceOp.MAX, group=group)
    return t


def _quant_weight(w: torch.Tensor, reduce_dims, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8: (w8, scale[out]). The output channel
    is the one dimension not in `reduce_dims`. Zero channels get scale 1 and
    an all-zero w8. `group`: `w` holds a slice of the input features, and
    each channel's abs-max is the maximum over the group's slices."""
    wf = w.float()
    amax = wf.abs().amax(dim=reduce_dims, keepdim=True)
    if group is not None:
        all_reduce_max(amax, group)
    scale = torch.where(amax > 0, _over_127(amax), torch.ones_like(amax))
    w8 = torch.round(wf / scale).to(torch.int8)
    return w8, scale.reshape(-1)


def _act_scale(xf: torch.Tensor, amax_const: Optional[float]):
    """(amax, scale) of a float32 activation as 0-d float32 tensors: the
    static amax when given, else the tensor's abs-max (NaN if it holds one);
    scale = 1 where amax <= 0, else amax / 127 (one float32 division on both
    paths). A NaN amax gives a NaN scale, so a NaN activation reaches the
    product's output instead of hiding behind scale 1 (the JAX package's
    ``amax > 0`` test gives 1 there)."""
    if amax_const is not None:
        amax = torch.tensor(amax_const, dtype=torch.float32, device=xf.device)
        return amax, (torch.ones_like(amax) if amax_const <= 0 else _over_127(amax))
    amax = xf.abs().amax()
    return amax, torch.where(amax <= 0, torch.ones_like(amax), _over_127(amax))


def _quantize(xf: torch.Tensor, scale: torch.Tensor, static: bool) -> torch.Tensor:
    """round(x / scale) to int8, half to even; clipped to +-127 on the static
    path (the dynamic scale cannot overflow)."""
    q = torch.round(xf / scale)
    return (q.clamp(-127.0, 127.0) if static else q).to(torch.int8)


def _rescale(acc: torch.Tensor, wscale, xscale, bias, dtype) -> torch.Tensor:
    """The epilogue: float32(acc) * (wscale * xscale), cast, then + bias in
    `dtype`; acc holds exact integers (float64), channels last."""
    y = (acc.float() * (wscale * xscale)).to(dtype)
    return y if bias is None else y + bias.to(dtype)


# ---- weight cache --------------------------------------------------------------


class WeightCache:
    """The int8 copy of one layer's weight, as the compute type holds it, in
    the layout Q1 reads ([O, kh, kw, Cp], input channels innermost and
    zero-padded to Cp), and its per-channel scales, made once per parameter
    version: keyed on the parameter's storage, version counter (raised by
    ``load_state_dict``, ``copy_`` and optimiser steps), dtype, shape and
    device, and the compute type. Writes through ``.data`` bypass the
    version counter and are not seen."""

    def __init__(self):
        self.key = None
        self.value = None

    def get(self, w: torch.Tensor, dtype: torch.dtype, group=None):
        """`group`: `w` is a row-parallel slice (its input features), and the
        scales are the model axis' (one all-reduce a weight version)."""
        key = (w.data_ptr(), w._version, w.dtype, tuple(w.shape), w.device, dtype, group)
        if key != self.key:
            self.key, self.value = None, None  # a failed build leaves no stale entry
            self.value = _prepare_weight(w.to(dtype), group)
            self.key = key
        return self.value


def _prepare_weight(w: torch.Tensor, group=None):
    """(w8 in the layout Q1 reads, wscale [O] float32) of an OIHW or
    [out, in] weight."""
    w8, scale = _quant_weight(w.detach(), (1, 2, 3) if w.dim() == 4 else (1,), group)
    return kernel_layout(w8), scale.contiguous()


def kernel_layout(w8: torch.Tensor) -> torch.Tensor:
    """An int8 weight, OIHW or [out, in], in the layout Q1 reads:
    [O, kh, kw, Cp], input channels innermost and zero-padded to Cp."""
    w8 = w8.permute(0, 2, 3, 1) if w8.dim() == 4 else w8[:, None, None, :]
    c = w8.shape[-1]
    return F.pad(w8, (0, _padded(c) - c)).contiguous()


def _padded(c: int) -> int:
    return -(-c // CHANNEL_PAD) * CHANNEL_PAD


# ---- the quantized products ------------------------------------------------------


def w8a8_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                cache: Optional[WeightCache] = None, shards: int = 1) -> torch.Tensor:
    """``F.linear`` (weight [out, in]) run w8a8, a 1 x 1 convolution over the
    tokens; the plain product when the selective gate skips the site.
    `shards` > 1: `weight` is one of that many column-parallel slices (its
    output features; the whole rows, so its scales are the global ones) and
    the gate reads the whole weight's size."""
    if _selective_skip(x, weight, (x.numel(), weight.numel() * shards)):
        return F.linear(x, weight, bias)
    dtype = torch.promote_types(x.dtype, weight.dtype)
    w8, wscale = (cache or WeightCache()).get(weight, dtype)
    lead, c = x.shape[:-1], x.shape[-1]
    out = _kernel_product(x.to(dtype).reshape(-1, 1, 1, c), w8, wscale, bias, dtype, 1, 0)
    return out.reshape(*lead, w8.shape[0])


def row_skipped(x: torch.Tensor, weight: torch.Tensor, shards: int) -> bool:
    """Whether the selective gate skips a row-parallel site whose `x` and
    `weight` hold 1/`shards` of the input features."""
    return _selective_skip(x, weight, (x.numel() * shards, weight.numel() * shards))


def w8a8_linear_row(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                    group, cache: Optional[WeightCache] = None) -> torch.Tensor:
    """A row-parallel dense site run w8a8 over the model axis' `group`: x
    [..., in/n] and weight [out, in/n] hold this process's input features
    (serving; the caller has passed the selective gate, `row_skipped`).
    Dynamic: Q2's amax-only pass, the axis' maximum, Q2's device-amax pass;
    static: Q2's static pass. Then Q1's int32 accumulators, summed over the
    axis, and the epilogue with the whole bias: the whole product, on every
    process, bit-equal to one process's site."""
    dtype = torch.promote_types(x.dtype, weight.dtype)
    w8, wscale = (cache or WeightCache()).get(weight, dtype, group)
    lead, c = x.shape[:-1], x.shape[-1]
    if w8.shape[3] != _padded(c):
        raise ValueError(f"weight holds {w8.shape[3]} padded input channels, the input {c}")
    x2d = x.to(dtype).reshape(-1, c)
    amax_const = _static_entry()
    if amax_const is None:
        stats = activation_amax(x2d)
        all_reduce_max(stats[:1], group)
        _record(stats[0])
        x8, stats = quantize_activation(x2d, stats)
    else:
        x8, stats = quantize_activation(x2d, amax_const)
    rows = x2d.shape[0]
    acc = int8_conv(x8.view(rows, 1, 1, w8.shape[3]), w8, wscale, stats, None, torch.int32, 1, 0)
    dist.all_reduce(acc, group=group)
    out = _rescale(acc, wscale, stats[1], None if bias is None else bias.to(dtype), dtype)
    return out.reshape(*lead, w8.shape[0])


def w8a8_conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                stride: int = 1, padding: int = 0,
                cache: Optional[WeightCache] = None) -> torch.Tensor:
    """``F.conv2d`` (NCHW, OIHW, square stride and padding, no groups or
    dilation) run w8a8; the plain convolution when the selective gate skips
    the site. The output is channels-last in memory."""
    if _selective_skip(x, weight):
        return F.conv2d(x, weight, bias, stride, padding)
    dtype = torch.promote_types(x.dtype, weight.dtype)
    w8, wscale = (cache or WeightCache()).get(weight, dtype)
    out = _kernel_product(x.to(dtype).permute(0, 2, 3, 1), w8, wscale, bias, dtype, stride,
                          padding)
    return out.permute(0, 3, 1, 2)


def _kernel_product(x_nhwc, w8, wscale, bias, dtype, stride: int, padding: int):
    """One quantized site: the scope's static amax (or none: dynamic,
    recorded under calibration), then `w8a8_site`: x_nhwc [B, H, W, C] ->
    [B, Ho, Wo, O] in dtype."""
    b, h, w, c = x_nhwc.shape
    if w8.shape[3] != _padded(c):
        raise ValueError(f"weight holds {w8.shape[3]} padded input channels, the input {c}")
    amax_const = _static_entry()
    out, stats = w8a8_site(x_nhwc.reshape(b * h * w, c), (b, h, w), w8, wscale,
                           None if bias is None else bias.to(dtype), dtype, stride, padding,
                           amax_const)
    if amax_const is None:
        _record(stats[0])
    return out


def _check_device(x: torch.Tensor) -> None:
    if x.device.type != "cpu":
        raise RuntimeError(f"the w8a8 kernels have no version for device {x.device}")


# ---- Q1's schedule -------------------------------------------------------------------

CONV_BM, CONV_BK = 128, 128  # Q1's tile rows, and the bytes of K of one step (int8_conv.cu)
CONV_BN = (256, 160, 32)  # Q1's tile widths, the wgmma widths it instantiates
MIN_SPLIT_STEPS = 2  # K steps a split holds at least
MAX_SPLITS = 8  # a tile's splits are one thread block cluster: 8 is the portable most
# Q1's time model, in microseconds, fitted to CUDA-graph timings of the
# step's shapes on an H100 SXM at 700 W (chip_smoke.py --phases quant): a
# block's start and epilogue and a 128-byte K step, each at tile width bn,
# with the activation rows gathered by cp.async (im2col) or, at a 1 x 1
# stride-1 unpadded product, loaded by TMA; and the sum of a tile's splits
# through the cluster's shared memory (its launch, two cluster barriers, and
# the rows of the tile that M fills).
Q1_BLOCK_US = {True: (3.8, 0.008), False: (2.9, 0.0088)}  # by gathered: (us, + per column)
Q1_STEP_US = {True: (0.40, 0.0016), False: (0.12, 0.0018)}
Q1_SPLIT_US = (1.0, 0.022)  # + per column of bn and filled row share
# clusters of more than two blocks do not all fit on the card at once beyond
# this many blocks (on an H100, 128 blocks in clusters of 8 ran in two waves:
# PERF.md)
MAX_CLUSTERED_BLOCKS = 64


def gathered(kh: int, kw: int, stride: int, padding: int) -> bool:
    """Whether Q1 gathers the activation's im2col rows (cp.async): every
    product but a 1 x 1, stride-1, unpadded one, whose activation is a plain
    [M, K] matrix loaded by TMA."""
    return not (kh == kw == 1 and stride == 1 and padding == 0)


def conv_schedule(m: int, n: int, k: int, gather: bool = True,
                  sms: int = 132) -> Tuple[int, int, int]:
    """Q1's tile width and split of K for an (M, N, K) product: (bn, splits,
    steps a split), every split holding at least one 128-byte step. Of the
    widths, and of the splits that keep the launch within one wave of the
    card (at least MIN_SPLIT_STEPS steps each, at most MAX_SPLITS, and at
    most MAX_CLUSTERED_BLOCKS blocks in clusters of more than two), the one
    that Q1's time model says is fastest: waves x (a block's start and
    epilogue + its steps + the splits' sum through the cluster). `gather`:
    see `gathered`. Integer sums do not depend on their order, so any
    schedule gives the same bits."""
    steps = -(-k // CONV_BK)
    rows = min(1.0, m / CONV_BM)
    (b0, b1), (s0, s1) = Q1_BLOCK_US[gather], Q1_STEP_US[gather]
    best = None
    for bn in CONV_BN:
        tiles = -(-m // CONV_BM) * -(-n // bn)
        most = max(1, min(steps // MIN_SPLIT_STEPS, sms // tiles, MAX_SPLITS))
        for want in range(1, most + 1):
            per = -(-steps // want)
            splits = -(-steps // per)
            if splits > 2 and tiles * splits > MAX_CLUSTERED_BLOCKS:
                continue
            block = b0 + b1 * bn + per * (s0 + s1 * bn)
            if splits > 1:
                block += Q1_SPLIT_US[0] + Q1_SPLIT_US[1] * bn * rows
            cost = -(-tiles * splits // sms) * block
            if best is None or cost < best[0]:
                best = (cost, bn, splits, per)
    return best[1:]


# ---- the kernels' wrappers -----------------------------------------------------------

_ENTRIES: dict = {}
_VOIDP, _INT, _I64, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_QUANT_ARGTYPES = [_VOIDP, _INT, _I64, _INT, _INT] + [_VOIDP] * 3 + [_INT, _F32, _VOIDP]
_Q1_TAIL = [_VOIDP, _VOIDP, _VOIDP, _INT, _VOIDP, _INT] + [_INT] * 14 + [_VOIDP]
_CONV_ARGTYPES = [_VOIDP, _VOIDP] + _Q1_TAIL
_SITE_ARGTYPES = [_VOIDP, _INT, _INT] + [_VOIDP] * 3 + [_INT, _F32] + _Q1_TAIL
_SCRATCH: dict = {}


def _entry(name: str, argtypes):
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = getattr(_build.library("w8a8"), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _ENTRIES[name] = fn
    return fn


def _call(fn, device: torch.device, stream: int, *args) -> int:
    if device.index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(device.index):
        return fn(*args, stream)


def _raise_for(err: int, what: str) -> None:
    if err == -1:
        raise ValueError(f"{what}: the kernel does not take these arguments")
    if err == -2:
        raise RuntimeError(f"{what}: the weight's TMA tensor map could not be made")
    if err != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {err}")


def _scratch(device: torch.device) -> Tuple[int, dict]:
    """(the current stream, the kernels' scratch on it), kept across calls:
    Q2's grid-barrier words (zeros before and after every launch, as the
    kernel leaves them), and a site's x8 and stats. Two streams never share
    one."""
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    key = (device.index, stream)
    s = _SCRATCH.get(key)
    if s is None:
        s = _SCRATCH[key] = dict(
            barrier=torch.zeros(4, dtype=torch.int32, device=device),
            stats=torch.empty(2, dtype=torch.float32, device=device),
            x8=torch.empty(0, dtype=torch.int8, device=device),
        )
    return stream, s


def _site_x8(s: dict, n: int) -> torch.Tensor:
    """The stream's x8 scratch, with at least n bytes."""
    if s["x8"].numel() < n:
        s["x8"] = torch.empty(n, dtype=torch.int8, device=s["x8"].device)
    return s["x8"]


def quantize_activation_plain(x2d: torch.Tensor, amax: Amax):
    """Q2's function: x2d [rows, C] -> (x8 [rows, Cp] int8 with zero padding,
    stats [2] float32 = (amax, scale)). `amax`: None (dynamic), a float
    (static), or a float32 tensor holding the amax at [0] (device amax: the
    static path's rounding and clip)."""
    xf = x2d.float()
    if isinstance(amax, torch.Tensor):
        a = amax[0]
        scale = torch.where(a <= 0, torch.ones_like(a), _over_127(a))
        x8, stats = _quantize(xf, scale, True), torch.stack([a, scale])
    else:
        a, scale = _act_scale(xf, amax)
        x8, stats = _quantize(xf, scale, amax is not None), torch.stack([a, scale])
    c = x2d.shape[1]
    return F.pad(x8, (0, _padded(c) - c)), stats


def activation_amax_plain(x2d: torch.Tensor) -> torch.Tensor:
    """Q2's amax-only function: stats [2] float32 = (max |x2d|, 0)."""
    amax = x2d.float().abs().amax()
    return torch.stack([amax, torch.zeros_like(amax)])


def activation_amax(x2d: torch.Tensor) -> torch.Tensor:
    """Q2's amax-only mode on CUDA tensors (one launch), its plain version on
    CPU tensors: stats [2] float32 = (max |x2d| (NaN if it holds one), 0),
    on the device."""
    if x2d.device.type != "cuda":
        _check_device(x2d)
        return activation_amax_plain(x2d)
    x2d = x2d.contiguous()
    head = _q2_args(x2d)
    rows, c = x2d.shape
    dev = x2d.device
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    stats = torch.empty(2, dtype=torch.float32, device=dev)
    err = _call(_entry("quant_act_s8", _QUANT_ARGTYPES), dev, stream, *head, rows, c,
                _padded(c), None, None, stats.data_ptr(), _Q2_AMAX_ONLY, 0.0)
    _raise_for(err, "quant_act_s8 (amax only)")
    launches["act_amax"] += 1
    return stats


def _q2_args(x2d: torch.Tensor) -> list:
    if x2d.dtype not in _DTYPE_CODES:
        raise TypeError(f"quantize_activation takes float32 or bfloat16, got {x2d.dtype}")
    return [x2d.data_ptr(), _DTYPE_CODES[x2d.dtype]]


def quantize_activation(x2d: torch.Tensor, amax: Amax):
    """Q2 on CUDA tensors (one launch), its plain version on CPU tensors.
    `amax` as `quantize_activation_plain`'s; a device amax is a [2] float32
    tensor on x2d's device whose [0] holds it (`activation_amax`'s, reduced):
    the scale is written to its [1] and it is returned as the stats."""
    if x2d.device.type != "cuda":
        _check_device(x2d)
        return quantize_activation_plain(x2d, amax)
    x2d = x2d.contiguous()
    head = _q2_args(x2d)
    rows, c = x2d.shape
    dev = x2d.device
    stream, s = _scratch(dev)
    x8 = torch.empty((rows, _padded(c)), dtype=torch.int8, device=dev)
    static = amax if isinstance(amax, (int, float)) else None
    if isinstance(amax, torch.Tensor):
        if amax.dtype != torch.float32 or amax.numel() != 2 or amax.device != dev \
                or not amax.is_contiguous():
            raise ValueError("amax must be a contiguous [2] float32 tensor on x2d's device")
        stats, mode = amax, _Q2_DEVICE_AMAX
    else:
        stats = torch.empty(2, dtype=torch.float32, device=dev)
        mode = _Q2_DYNAMIC if amax is None else _Q2_STATIC
    err = _call(_entry("quant_act_s8", _QUANT_ARGTYPES), dev, stream, *head, rows, c,
                _padded(c), x8.data_ptr(), s["barrier"].data_ptr(), stats.data_ptr(), mode,
                0.0 if static is None else float(static))
    _raise_for(err, "quant_act_s8")
    key = {_Q2_DEVICE_AMAX: "act_device", _Q2_STATIC: "act_static"}.get(mode, "act_dynamic")
    launches[key] += 1
    return x8, stats


def int8_conv_plain(x8, w8, stats, wscale, bias, dtype, stride: int, padding: int):
    """Q1's function on Q2's layout: x8 [B, H, W, Cp], w8 [O, kh, kw, Cp] ->
    [B, Ho, Wo, O] in dtype (channels-last output), as im2col and a float64
    product: exact, every partial sum is an integer below 2^53, whatever the
    device's algorithms."""
    b, h, w, _ = x8.shape
    o, kh, kw, _ = w8.shape
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (w + 2 * padding - kw) // stride + 1
    cols = F.unfold(x8.permute(0, 3, 1, 2).double(), (kh, kw), padding=padding,
                    stride=stride)  # [B, Cp*kh*kw, L]
    acc = (w8.permute(0, 3, 1, 2).double().reshape(o, -1) @ cols).transpose(1, 2)  # [B, L, O]
    if dtype == torch.int32:  # the accumulators, no epilogue
        return acc.to(torch.int32).reshape(b, ho, wo, o)
    return _rescale(acc, wscale, stats[1], bias, dtype).reshape(b, ho, wo, o)


def _q1_args(bhw, w8, wscale, stats, bias, dtype, stride: int, padding: int):
    """Q1's arguments after x8 and stats, checked, and its output."""
    b, h, w = bhw
    o, kh, kw, cp = w8.shape
    dev = w8.device
    if cp % CHANNEL_PAD or w8.dtype != torch.int8:
        raise ValueError(f"int8_conv takes an int8 w8 [O,kh,kw,Cp], Cp a multiple of "
                         f"{CHANNEL_PAD}: {tuple(w8.shape)}")
    if dtype not in _OUT_CODES:
        raise TypeError(f"int8_conv writes float32, bfloat16 or int32, not {dtype}")
    if bias is not None and (bias.dtype != dtype or bias.shape != (o,) or dtype == torch.int32):
        raise ValueError("bias must be [O] in the output type (none for int32)")
    tensors = [w8, wscale, stats] + ([bias] if bias is not None else [])
    if any(not t.is_contiguous() or t.device != dev for t in tensors):
        raise ValueError("int8_conv's operands must be contiguous on one device")
    if wscale.dtype != torch.float32 or stats.dtype != torch.float32:
        raise TypeError("wscale and stats must be float32")
    ho, wo = (h + 2 * padding - kh) // stride + 1, (w + 2 * padding - kw) // stride + 1
    m = b * ho * wo
    bn, splits, per = conv_schedule(m, o, kh * kw * cp, gathered(kh, kw, stride, padding))
    out = torch.empty((b, ho, wo, o), dtype=dtype, device=dev)
    args = [w8.data_ptr(), wscale.data_ptr(), 0 if bias is None else bias.data_ptr(),
            int(bias is not None), out.data_ptr(), _OUT_CODES[dtype], bn, splits, per,
            b, h, w, cp, o, kh, kw, stride, padding, ho, wo]
    return args, out


def int8_conv(x8: torch.Tensor, w8: torch.Tensor, wscale: torch.Tensor, stats: torch.Tensor,
              bias: Optional[torch.Tensor], dtype: torch.dtype, stride: int,
              padding: int) -> torch.Tensor:
    """Q1 on CUDA tensors (one launch): x8 [B, H, W, Cp] int8, w8 [O, kh, kw,
    Cp] int8, wscale [O] float32, stats [2] float32 (the activation scale at
    [1]), bias [O] in dtype or None -> [B, Ho, Wo, O] in dtype; dtype int32
    gives the accumulators (its int32 mode: no epilogue, no bias). Its plain
    version on CPU tensors."""
    if x8.device.type != "cuda":
        _check_device(x8)
        return int8_conv_plain(x8, w8, stats, wscale, bias, dtype, stride, padding)
    b, h, w, cp = x8.shape
    if cp != w8.shape[3] or x8.dtype != torch.int8 or not x8.is_contiguous() \
            or x8.device != w8.device:
        raise ValueError(f"int8_conv takes a contiguous int8 x8 [B,H,W,Cp] with w8's Cp on its "
                         f"device: {tuple(x8.shape)}, {tuple(w8.shape)}")
    stream = torch._C._cuda_getCurrentRawStream(x8.device.index)
    args, out = _q1_args((b, h, w), w8, wscale, stats, bias, dtype, stride, padding)
    err = _call(_entry("int8_conv_s8", _CONV_ARGTYPES), x8.device, stream, x8.data_ptr(),
                stats.data_ptr(), *args)
    _raise_for(err, "int8_conv_s8")
    launches["conv_acc" if dtype == torch.int32 else "conv"] += 1
    return out


def w8a8_site(x2d: torch.Tensor, bhw, w8: torch.Tensor, wscale: torch.Tensor,
              bias: Optional[torch.Tensor], dtype: torch.dtype, stride: int, padding: int,
              amax_const: Optional[float]):
    """A quantized site, Q2 then Q1: x2d [B*H*W, C] in dtype (bhw = (B, H,
    W)), static when amax_const is given -> (out [B, Ho, Wo, O] in dtype,
    stats [2] float32). On CUDA tensors one call into the library, which
    launches both kernels, with x8 and stats in the stream's scratch (stats
    hold until the stream's next site); on CPU tensors the two wrappers'
    plain versions."""
    b, h, w = bhw
    if x2d.device.type != "cuda":
        x8, stats = quantize_activation(x2d, amax_const)
        return int8_conv(x8.view(b, h, w, w8.shape[3]), w8, wscale, stats, bias, dtype,
                         stride, padding), stats
    x2d = x2d.contiguous()
    head = _q2_args(x2d)
    if x2d.dtype != dtype or x2d.device != w8.device or x2d.shape[0] != b * h * w:
        raise ValueError("w8a8_site takes x2d [B*H*W, C] in the output type on w8's device")
    dev, c, cp = x2d.device, x2d.shape[1], w8.shape[3]
    stream, s = _scratch(dev)
    stats = s["stats"]
    args, out = _q1_args(bhw, w8, wscale, stats, bias, dtype, stride, padding)
    static = amax_const is not None
    err = _call(_entry("w8a8_site_s8", _SITE_ARGTYPES), dev, stream, *head, c,
                _site_x8(s, b * h * w * cp).data_ptr(), s["barrier"].data_ptr(),
                stats.data_ptr(), int(static),
                float(amax_const) if static else 0.0, *args)
    _raise_for(err, "w8a8_site_s8")
    launches["act_static" if static else "act_dynamic"] += 1
    launches["conv"] += 1
    return out, stats
