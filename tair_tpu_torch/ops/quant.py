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

On a CUDA tensor a quantized product is two wrappers, each launching its
kernel (no fallback):

  ``quantize_activation``  ``csrc/quant_act.cu`` (Q2): the per-tensor abs-max
      and the int8 quantize, written channels-innermost with the channels
      padded to a multiple of 16, the layout Q1 reads; the scale stays on the
      device (no host synchronisation on the dynamic path);
  ``int8_conv``            ``csrc/int8_conv.cu`` (Q1): the s8 x s8 -> s32
      implicit-GEMM convolution (3 x 3 stride 1 or 2, 1 x 1; a dense layer is
      a 1 x 1 convolution over its tokens) on ``mma.sync`` with the rescale and
      the bias in its epilogue.

The weight's int8 copy and scales are made once per parameter version by
``WeightCache`` (tensor ops; JAX gets the same from XLA hoisting the quantize
out of the sampler's scan). Both devices run this one composition: on CPU
tensors each wrapper runs its plain version, whose integer product is exact
in float64.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

_state = threading.local()

# kernel launches made by the wrappers (never by a plain version): Q2's abs-max
# reduce and its quantize pass, Q1's product and its split-K reduce
launches = {"act_absmax": 0, "act_quantize": 0, "conv": 0, "conv_reduce": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
CHANNEL_PAD = 16  # Q1 reads 16-byte pieces of one tap: channels padded to 16


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


def _selective_skip(x: torch.Tensor, w: torch.Tensor) -> bool:
    r = min_weight_act_ratio()
    return r is not None and w.numel() < r * x.numel()


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


def _quant_weight(w: torch.Tensor, reduce_dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8: (w8, scale[out]). The output channel
    is the one dimension not in `reduce_dims`. Zero channels get scale 1 and
    an all-zero w8."""
    wf = w.float()
    amax = wf.abs().amax(dim=reduce_dims, keepdim=True)
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

    def get(self, w: torch.Tensor, dtype: torch.dtype):
        key = (w.data_ptr(), w._version, w.dtype, tuple(w.shape), w.device, dtype)
        if key != self.key:
            self.key, self.value = None, None  # a failed build leaves no stale entry
            self.value = _prepare_weight(w.to(dtype))
            self.key = key
        return self.value


def _prepare_weight(w: torch.Tensor):
    """(w8 in the layout Q1 reads, wscale [O] float32) of an OIHW or
    [out, in] weight."""
    w8, scale = _quant_weight(w.detach(), (1, 2, 3) if w.dim() == 4 else (1,))
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
                cache: Optional[WeightCache] = None) -> torch.Tensor:
    """``F.linear`` (weight [out, in]) run w8a8, a 1 x 1 convolution over the
    tokens; the plain product when the selective gate skips the site."""
    if _selective_skip(x, weight):
        return F.linear(x, weight, bias)
    dtype = torch.promote_types(x.dtype, weight.dtype)
    w8, wscale = (cache or WeightCache()).get(weight, dtype)
    lead, c = x.shape[:-1], x.shape[-1]
    out = _kernel_product(x.to(dtype).reshape(-1, 1, 1, c), w8, wscale, bias, dtype, 1, 0)
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


def _quant_act(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 of the activation x2d [rows, C] through Q2:
    (x8 [rows, Cp], stats = (amax, scale)); static when the scope set an
    amax, else dynamic (recorded under calibration)."""
    amax_const = _static_entry()
    x8, stats = quantize_activation(x2d, amax_const)
    if amax_const is None:
        _record(stats[0])
    return x8, stats


def _kernel_product(x_nhwc, w8, wscale, bias, dtype, stride: int, padding: int):
    """Q2 then Q1 (their plain versions on CPU tensors): x_nhwc [B, H, W, C]
    -> [B, Ho, Wo, O] in dtype."""
    b, h, w, c = x_nhwc.shape
    o, kh, kw, cp = w8.shape
    if cp != _padded(c):
        raise ValueError(f"weight holds {cp} padded input channels, the input {c}")
    x8, stats = _quant_act(x_nhwc.reshape(b * h * w, c))
    if bias is not None:
        bias = bias.to(dtype)
    return int8_conv(x8.view(b, h, w, cp), w8, wscale, stats, bias, dtype, stride, padding)


def _check_device(x: torch.Tensor) -> None:
    if x.device.type != "cpu":
        raise RuntimeError(f"the w8a8 kernels have no version for device {x.device}")


# ---- the kernels' wrappers -----------------------------------------------------------

_ENTRIES: dict = {}
_VOIDP, _INT, _I64, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_QUANT_ARGTYPES = [_VOIDP, _INT, _I64, _INT, _INT, _VOIDP, _VOIDP, _INT, _VOIDP, _INT, _F32,
                   _VOIDP]
_CONV_ARGTYPES = [_VOIDP] * 5 + [_INT, _VOIDP, _INT, _VOIDP, _INT] + [_INT] * 11 + [_VOIDP]
ABSMAX_BLOCKS = 264  # Q2's first pass: partial maxima, folded by every block of the second


def _entry(lib: str, name: str, argtypes):
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = getattr(_build.library(lib), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _ENTRIES[name] = fn
    return fn


def _call(fn, device: torch.device, *args) -> int:
    dev = device.index
    stream = torch._C._cuda_getCurrentRawStream(dev)
    if dev == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(dev):
        return fn(*args, stream)


def _raise_for(err: int, what: str) -> None:
    if err == -1:
        raise ValueError(f"{what}: the kernel does not take these arguments")
    if err != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {err}")


def quantize_activation_plain(x2d: torch.Tensor, amax_const: Optional[float]):
    """Q2's function: x2d [rows, C] -> (x8 [rows, Cp] int8 with zero padding,
    stats [2] float32 = (amax, scale)); static when amax_const is given."""
    xf = x2d.float()
    amax, scale = _act_scale(xf, amax_const)
    x8 = _quantize(xf, scale, amax_const is not None)
    c = x2d.shape[1]
    return F.pad(x8, (0, _padded(c) - c)), torch.stack([amax, scale])


def quantize_activation(x2d: torch.Tensor, amax_const: Optional[float]):
    """Q2 on CUDA tensors (two launches dynamic, one static), its plain
    version on CPU tensors."""
    if x2d.device.type != "cuda":
        _check_device(x2d)
        return quantize_activation_plain(x2d, amax_const)
    if x2d.dtype not in _DTYPE_CODES:
        raise TypeError(f"quantize_activation takes float32 or bfloat16, got {x2d.dtype}")
    if not x2d.is_contiguous():
        x2d = x2d.contiguous()
    rows, c = x2d.shape
    cp = _padded(c)
    dev = x2d.device
    x8 = torch.empty((rows, cp), dtype=torch.int8, device=dev)
    stats = torch.empty(2, dtype=torch.float32, device=dev)
    static = amax_const is not None
    partial = None if static else torch.empty(ABSMAX_BLOCKS, dtype=torch.float32, device=dev)
    fn = _entry("quant_act", "quant_act_s8", _QUANT_ARGTYPES)
    err = _call(fn, dev, x2d.data_ptr(), _DTYPE_CODES[x2d.dtype], rows, c, cp, x8.data_ptr(),
                0 if static else partial.data_ptr(), ABSMAX_BLOCKS, stats.data_ptr(),
                int(static), float(amax_const) if static else 0.0)
    _raise_for(err, "quant_act_s8")
    if not static:
        launches["act_absmax"] += 1
    launches["act_quantize"] += 1
    return x8, stats


def split_k(m: int, n: int, k: int, sms: int = 132) -> int:
    """Q1's split of K over blocks: one split when the output tiles (64 x 64)
    fill the card; otherwise enough splits for about two blocks an SM, each
    over at least four 64-deep steps. Integer sums do not depend on the
    order, so any split gives the same bits."""
    tiles = -(-m // 64) * -(-n // 64)
    steps = -(-k // 64)
    if tiles >= sms or steps < 8:
        return 1
    per = max(4, -(-steps // -(-2 * sms // tiles)))
    return -(-steps // per)


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
    return _rescale(acc, wscale, stats[1], bias, dtype).reshape(b, ho, wo, o)


def int8_conv(x8: torch.Tensor, w8: torch.Tensor, wscale: torch.Tensor, stats: torch.Tensor,
              bias: Optional[torch.Tensor], dtype: torch.dtype, stride: int,
              padding: int) -> torch.Tensor:
    """Q1 on CUDA tensors: x8 [B, H, W, Cp] int8, w8 [O, kh, kw, Cp] int8,
    wscale [O] float32, stats [2] float32 (the activation scale at [1]),
    bias [O] in dtype or None -> [B, Ho, Wo, O] in dtype. Its plain version
    on CPU tensors."""
    if x8.device.type != "cuda":
        _check_device(x8)
        return int8_conv_plain(x8, w8, stats, wscale, bias, dtype, stride, padding)
    b, h, w, cp = x8.shape
    o, kh, kw, cpw = w8.shape
    if cp != cpw or cp % CHANNEL_PAD or x8.dtype != torch.int8 or w8.dtype != torch.int8:
        raise ValueError(f"int8_conv takes int8 x8 [B,H,W,Cp] and w8 [O,kh,kw,Cp] with one Cp, "
                         f"a multiple of {CHANNEL_PAD}: {tuple(x8.shape)}, {tuple(w8.shape)}")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"int8_conv writes float32 or bfloat16, not {dtype}")
    if bias is not None and (bias.dtype != dtype or bias.shape != (o,)):
        raise ValueError("bias must be [O] in the output type")
    tensors = [x8, w8, wscale, stats] + ([bias] if bias is not None else [])
    if any(not t.is_contiguous() or t.device != x8.device for t in tensors):
        raise ValueError("int8_conv's operands must be contiguous on one device")
    if wscale.dtype != torch.float32 or stats.dtype != torch.float32:
        raise TypeError("wscale and stats must be float32")
    ho, wo = (h + 2 * padding - kh) // stride + 1, (w + 2 * padding - kw) // stride + 1
    out = torch.empty((b, ho, wo, o), dtype=dtype, device=x8.device)
    m, k = b * ho * wo, kh * kw * cp
    splits = split_k(m, o, k)
    ws = torch.empty((splits, m, o), dtype=torch.int32, device=x8.device) if splits > 1 else None
    fn = _entry("int8_conv", "int8_conv_s8", _CONV_ARGTYPES)
    err = _call(fn, x8.device, x8.data_ptr(), w8.data_ptr(), wscale.data_ptr(),
                stats.data_ptr(), 0 if bias is None else bias.data_ptr(), int(bias is not None),
                out.data_ptr(), _DTYPE_CODES[dtype], 0 if ws is None else ws.data_ptr(), splits,
                b, h, w, cp, o, kh, kw, stride, padding, ho, wo)
    _raise_for(err, "int8_conv_s8")
    launches["conv"] += 1
    if splits > 1:
        launches["conv_reduce"] += 1
    return out
