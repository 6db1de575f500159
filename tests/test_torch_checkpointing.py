"""Gradient checkpointing of the port (``UNetConfig.use_checkpoint``,
``TESTRConfig.use_checkpoint``) against its own gradients without it and
against the JAX package's ``nn.remat`` on the same units, float32 on the CPU.

Three parts, each a fixed weighted sum of its outputs differentiated with
respect to every parameter: a ControlNet feeding its UNet (the noise
prediction and the decoder taps; two levels of one residual block each,
attention at the second, so every kind of checkpointed block is there, with
and without attention, at a compile the test budget affords), and the spotter of ``tests/test_spotter.py::TINY``
(one encoder layer) dense and under ``enc_topk`` (every output, final,
auxiliary and encoder). Every parameter is seeded noise. The JAX gradients of the three come from one
``jax.jit``, compiled once for the module.
"""

import dataclasses
from functools import partial

import jax
import numpy as np
import pytest
import torch

from tair_tpu.models import unet as jax_unet
from tair_tpu.spotter import TESTR as JaxTESTR
from tair_tpu_torch.models.layers import checkpoint_block
from tair_tpu_torch.models.unet import ControlNet, UNetConfig, UNetModel
from tair_tpu_torch.pipeline import build_tiny_model
from tair_tpu_torch.spotter.testr import TESTR, TESTRConfig
from tair_tpu_torch.weights.convert import convert_tree, module_param_shapes, to_jax_tree
from test_spotter import TINY
from test_torch_common import (  # noqa: F401
    compiling, jax_fast_compiles, jax_shapes, noise_params, torch_single_thread,
)

UNET = dict(model_channels=32, num_res_blocks=1, attention_resolutions=(2,),
            channel_mult=(1, 2), num_head_channels=16, context_dim=64)
# tests/test_spotter.py's TINY with one encoder layer: each kind of
# recomputed layer, at the least tracing for the JAX reference
TESTR_CFG = dataclasses.replace(TINY, num_encoder_layers=1)
LEVELS = ((2, 2), (4, 4), (8, 8), (8, 8))
ENC_TOPK = 50  # of S = 148 tokens
PARTS = ("cldm", "testr_dense", "testr_topk")


def _weights(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


def _testr_leaves(out):
    """The spotter's outputs in a fixed order."""
    keys = ("pred_logits", "pred_ctrl_points", "pred_texts")
    leaves = [out[k] for k in keys]
    for aux in out["aux_outputs"]:
        leaves += [aux[k] for k in keys]
    return leaves + [out["enc_outputs"]["pred_logits"], out["enc_outputs"]["pred_boxes"]]


def _port_cfg(**fields) -> TESTRConfig:
    names = {f.name for f in dataclasses.fields(TESTRConfig)} - set(fields)
    return TESTRConfig(**{f: getattr(TESTR_CFG, f) for f in names}, **fields)


class _ControlledUNet(torch.nn.Module):
    """The ControlNet's residuals into the UNet, as ``ControlLDM.apply``
    feeds them (control scales 1)."""

    def __init__(self):
        super().__init__()
        self.unet = UNetModel(UNetConfig(**UNET))
        self.controlnet = ControlNet(UNetConfig(**UNET))

    def set_use_checkpoint(self, on):
        self.unet.use_checkpoint = self.controlnet.use_checkpoint = on

    def forward(self, x, t, cond):
        control = self.controlnet(x, cond["c_img"], t, cond["c_txt"])
        return self.unet(x, t, cond["c_txt"], control=control, extract_features=True)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(181)
    tm = _ControlledUNet()
    params = {k: noise_params(module_param_shapes(getattr(tm, k)), seed)
              for k, seed in (("unet", 182), ("controlnet", 185))}
    for k in params:
        getattr(tm, k).load_state_dict(convert_tree(params[k]), strict=True)
    cldm_in = dict(
        x=rng.standard_normal((2, 8, 8, 4), dtype=np.float32),
        t=np.array([17, 803]),
        c_txt=rng.standard_normal((2, 77, 64), dtype=np.float32),
        c_img=rng.standard_normal((2, 8, 8, 4), dtype=np.float32),
    )
    feats = tuple(rng.standard_normal((2, h, w, c), dtype=np.float32)
                  for (h, w), c in zip(LEVELS, TESTR_CFG.in_channels))
    testr_params = noise_params(jax_shapes(JaxTESTR(TESTR_CFG).init, feats)["params"], 183)
    return tm, params, cldm_in, feats, testr_params


def _port_cldm_out(tm, cldm_in):
    cond = dict(c_txt=torch.from_numpy(cldm_in["c_txt"]), c_img=torch.from_numpy(cldm_in["c_img"]))
    eps, taps = tm(torch.from_numpy(cldm_in["x"]), torch.from_numpy(cldm_in["t"]), cond)
    return [eps, *taps]


def _port_testr(params, enc_topk, use_checkpoint):
    model = TESTR(_port_cfg(enc_topk=enc_topk, use_checkpoint=use_checkpoint))
    model.load_state_dict(convert_tree(params), strict=True)
    return model.train()


def _port_grads(setup, part, use_checkpoint):
    """{JAX-layout path: gradient} of one part, as numpy."""
    tm, params, cldm_in, feats, testr_params = setup
    if part == "cldm":
        tm.set_use_checkpoint(use_checkpoint)
        modules = {"unet": tm.unet, "controlnet": tm.controlnet}
        for m in modules.values():
            m.zero_grad(set_to_none=True)
        outs = _port_cldm_out(tm, cldm_in)
        like = {k: params[k] for k in modules}
    else:
        model = _port_testr(testr_params, ENC_TOPK if part == "testr_topk" else 0, use_checkpoint)
        modules = {"testr": model}
        outs = _testr_leaves(model(tuple(torch.from_numpy(f) for f in feats)))
        like = {"testr": testr_params}
    ws = _weights([tuple(o.shape) for o in outs], 184)
    sum((o * torch.from_numpy(wt)).sum() for o, wt in zip(outs, ws)).backward()
    return {
        key: to_jax_tree({n: p.grad for n, p in m.named_parameters()}, like[key])
        for key, m in modules.items()
    }


@pytest.fixture(scope="module")
def jax_programs(setup):
    """The three parts' gradients under ``nn.remat``, one program each,
    traced here and each compiling in a thread (`compiling`) from the moment
    it is traced, while the next is traced and the port's gradients are
    taken."""
    tm, params, cldm_in, feats, testr_params = setup
    unet_cfg = jax_unet.UNetConfig(**UNET, use_checkpoint=True)
    unet, controlnet = jax_unet.UNetModel(unet_cfg), jax_unet.ControlNet(unet_cfg)
    testr = {k: JaxTESTR(dataclasses.replace(TESTR_CFG, use_checkpoint=True, enc_topk=k))
             for k in (0, ENC_TOPK)}
    with torch.no_grad():
        cldm_ws = _weights([tuple(o.shape) for o in _port_cldm_out(tm, cldm_in)], 184)
        testr_ws = _weights(
            [tuple(o.shape) for o in _testr_leaves(
                _port_testr(testr_params, 0, False)(tuple(torch.from_numpy(f) for f in feats)))],
            184,
        )

    def weighted(outs, ws):
        return sum((o * wt).sum() for o, wt in zip(outs, ws))

    def cldm_loss(p):
        x, t, c_txt = cldm_in["x"], cldm_in["t"], cldm_in["c_txt"]
        control = controlnet.apply({"params": p["controlnet"]}, x, cldm_in["c_img"], t, c_txt)
        eps, taps = unet.apply({"params": p["unet"]}, x, t, c_txt, control=control,
                               extract_features=True)
        return weighted([eps, *taps], cldm_ws)

    def testr_loss(p, k):
        return weighted(_testr_leaves(testr[k].apply({"params": p}, feats)), testr_ws)

    args = {"cldm": {k: params[k] for k in ("unet", "controlnet")},
            "testr_dense": testr_params, "testr_topk": testr_params}
    losses = {"cldm": cldm_loss, "testr_dense": partial(testr_loss, k=0),
              "testr_topk": partial(testr_loss, k=ENC_TOPK)}
    compiled = {}
    for part in PARTS:  # each compiles while the next is traced
        compiled.update(compiling({part: jax.jit(jax.grad(losses[part])).lower(args[part])}))
    return args, compiled


@pytest.fixture(scope="module")
def port_grads(setup, jax_programs):
    return {(part, ck): _port_grads(setup, part, ck) for part in PARTS for ck in (False, True)}


@pytest.fixture(scope="module")
def jax_grads(jax_programs):
    """{part: its gradient tree under ``nn.remat``} (JAX layout, numpy)."""
    args, compiled = jax_programs
    grads = {part: jax.tree.map(np.asarray, compiled[part].result()(args[part]))
             for part in PARTS}
    return {"cldm": grads["cldm"], "testr_dense": {"testr": grads["testr_dense"]},
            "testr_topk": {"testr": grads["testr_topk"]}}


def _flat(tree, prefix=""):
    for key, node in tree.items():
        if isinstance(node, dict):
            yield from _flat(node, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", node


@pytest.mark.parametrize("part", PARTS)
def test_gradients_with_and_without_checkpointing_are_equal(port_grads, part):
    without = dict(_flat(port_grads[(part, False)]))
    with_ = dict(_flat(port_grads[(part, True)]))
    assert set(with_) == set(without)
    for path, want in without.items():
        np.testing.assert_allclose(with_[path], want, rtol=0, atol=1e-6, err_msg=path)


@pytest.mark.parametrize("part", PARTS)
def test_checkpointed_gradients_match_jax_remat(port_grads, jax_grads, part):
    got = dict(_flat(port_grads[(part, True)]))
    want = dict(_flat(jax_grads[part]))
    assert set(got) == set(want)
    largest = max(np.abs(g).max() for g in want.values())
    for path, w in want.items():
        # the tolerances of test_torch_train_step.py's gradients
        np.testing.assert_allclose(
            got[path], w, rtol=2e-3, atol=2e-4 * np.abs(w).max() + 1e-6 * largest, err_msg=path,
        )


def test_blocks_run_again_in_the_backward_and_once_without_gradients(setup):
    """The body of each unit that ``nn.remat`` wraps runs twice in a training
    pass with checkpointing (the forward, then the recomputation in the
    backward) and once without it or under ``no_grad``; the hooks of the
    unit's own call (where FSDP gathers its parameters) and the rest of the
    model run once."""
    tm, _, cldm_in, _, _ = setup
    calls = {}
    units = {name: m for name, m in tm.named_modules()
             if type(m).__name__ in ("EncoderBlock", "MiddleBlock", "DecoderBlock")}
    # pre-hooks on each unit and on its children: the recomputation runs the
    # body from its first child on and stops once it has what the backward needs
    watched = [(name, m) for name, m in units.items()]
    watched += [(f"{name}/{c}", child) for name, m in units.items()
                for c, child in m.named_children()]
    watched.append(("unet.in_conv", tm.unet.in_conv))
    hooks = [m.register_forward_pre_hook(lambda m, i, n=name: calls.update({n: calls.get(n, 0) + 1}))
             for name, m in watched]
    try:
        for ck, grad, want in ((True, True, 2), (False, True, 1), (True, False, 1)):
            calls.clear()
            tm.set_use_checkpoint(ck)
            with torch.set_grad_enabled(grad):
                outs = _port_cldm_out(tm, cldm_in)
                if grad:
                    sum(o.sum() for o in outs).backward()
            body = {max(calls.get(f"{n}/{c}", 0) for c, _ in m.named_children())
                    for n, m in units.items()}
            assert body == {want}, (ck, grad)
            assert {calls[n] for n in units} == {1}, (ck, grad)
            assert calls["unet.in_conv"] == 1
    finally:
        for h in hooks:
            h.remove()
        tm.set_use_checkpoint(False)
    # the UNet's and the ControlNet's 2 encoder blocks and middle, the UNet's 4 decoder blocks
    kinds = [type(m).__name__ for m in units.values()]
    assert [kinds.count(k) for k in ("EncoderBlock", "MiddleBlock", "DecoderBlock")] == [4, 2, 4]


def test_a_checkpointed_block_refuses_a_generator():
    block = torch.nn.Linear(2, 2)
    x = torch.ones(1, 2, requires_grad=True)
    with pytest.raises(TypeError, match="Generator"):
        checkpoint_block(block, x, torch.Generator())


def test_testr_overrides_turn_checkpointing_on():
    """The JAX package's advice for memory-bound training builds."""
    model = build_tiny_model(
        device="cpu", training=True,
        testr_overrides={"use_checkpoint": True, "enc_msda_q_chunk": 2048},
    )
    assert model.testr.cfg.use_checkpoint and model.testr.transformer.use_checkpoint
    assert not model.cldm.unet.use_checkpoint and not model.cldm.controlnet.use_checkpoint
    model.set_use_checkpoint(True)
    assert model.cldm.unet.use_checkpoint and model.cldm.controlnet.use_checkpoint
