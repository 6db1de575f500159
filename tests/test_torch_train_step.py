"""The training slice as a whole: one stage-3 (``all_modules``) optimizer step
of the port against the JAX package on the tiny model, float32 on the CPU.

Both sides get the same parameters (every leaf seeded noise), the same batch
and the same random draws: the VAE sample noise, the timesteps and the
diffusion noise are made from the JAX keys as ``diffusion_loss_fn`` splits
them and handed to the port as tensors. The JAX side runs its default
on-device Jonker-Volgenant matcher; the port solves the same assignment on the
host.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tair_tpu.diffusion import Diffusion as JaxDiffusion
from tair_tpu.train.stages import trainable_mask as jax_trainable_mask
from tair_tpu.train.step import diffusion_loss_fn as jax_loss_fn
from tair_tpu.train.step import make_optimizer as jax_make_optimizer
from tair_tpu_torch.diffusion.diffusion import Diffusion
from tair_tpu_torch.train import step as tstep
from tair_tpu_torch.train.stages import count_trainable, trainable_mask
from tair_tpu_torch.weights.convert import from_jax_params, to_jax_params
from test_torch_common import tiny_pair, torch_single_thread  # noqa: F401

LR = 1e-4
OCR_WEIGHT = 0.01
B, HW, M = 2, 64, 3


def _batch(seed=61):
    rng = np.random.default_rng(seed)
    inst_mask = np.array([[True, True, False], [True, False, False]])
    cxcy = rng.uniform(0.25, 0.75, (B, M, 2))
    wh = rng.uniform(0.1, 0.4, (B, M, 2))
    return dict(
        gt=rng.random((B, HW, HW, 3), dtype=np.float32) * 2 - 1,
        lq=rng.random((B, HW, HW, 3), dtype=np.float32),
        tokens=rng.integers(1, 1000, (B, 77)).astype(np.int32),
        inst_mask=inst_mask,
        boxes=np.concatenate([cxcy, wh], -1).astype(np.float32),
        ctrl_points=rng.uniform(0.1, 0.9, (B, M, 16, 2)).astype(np.float32),
        texts=rng.integers(0, 97, (B, M, 25)).astype(np.int32),
    )


def _torch_batch(batch, rows=slice(None)):
    out = {k: torch.from_numpy(np.ascontiguousarray(v[rows])) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


def _draws(jm, params, batch, rng):
    """The three draws of the JAX loss function for this key, as numpy."""
    k_vae, k_t, k_p = jax.random.split(rng, 3)
    shape = (B, HW // 8, HW // 8, 4)
    return dict(
        vae_noise=np.array(jax.random.normal(k_vae, shape, jnp.float32)),
        t=np.array(jax.random.randint(k_t, (B,), 0, jm.schedule.num_timesteps)),
        noise=np.array(jax.random.normal(k_p, shape, jnp.float32)),
    )


@pytest.fixture(scope="module")
def setup():
    jm, params, tm = tiny_pair(seed=60)
    batch = _batch()
    rng = jax.random.PRNGKey(62)
    return jm, params, tm, batch, rng


@pytest.fixture(scope="module")
def jax_side(setup):
    """aux, gradients and the parameters after one AdamW step, from one
    compiled function that repeats the body of the JAX train step."""
    jm, params, _, batch, rng = setup
    diffusion = JaxDiffusion(schedule=jm.schedule, parameterization="v")
    tx = jax_make_optimizer(params, "stage3", LR)
    spot = jm.spotter_loss_fn()

    def ref_step(p, opt_state, b, key):
        (_, aux), grads = jax.value_and_grad(
            partial(jax_loss_fn, jm, diffusion), has_aux=True
        )(p, b, key, spotter_loss_fn=spot, ocr_loss_weight=OCR_WEIGHT)
        updates, _ = tx.update(grads, opt_state, p)
        return aux, grads, optax.apply_updates(p, updates)

    args = (params, tx.init(params), {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    # the function runs once: compile it without LLVM's expensive passes
    compiled = jax.jit(ref_step).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
    })
    aux, grads, new_params = compiled(*args)
    return (
        {k: float(v) for k, v in aux.items()},
        jax.tree.map(np.array, grads),       # copies: writable, as torch.from_numpy wants
        jax.tree.map(np.array, new_params),
    )


@pytest.fixture(scope="module")
def torch_side(setup):
    """aux, gradients by name (read just before the update) and the state
    after one step of the port."""
    jm, params, tm, batch, rng = setup
    tm.train()
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    state = tstep.create_train_state(tm, "stage3", LR)
    step = tstep.make_train_step(
        tm, Diffusion(tm.schedule), spotter_loss_fn=tm.spotter_loss_fn(),
        ocr_loss_weight=OCR_WEIGHT,
    )
    grads = {}
    hook = state.optimizer.register_step_pre_hook(
        lambda *_: grads.update(
            {n: p.grad.clone() for n, p in tm.named_parameters() if p.grad is not None}
        )
    )
    draws = {k: torch.from_numpy(v) for k, v in _draws(jm, params, batch, rng).items()}
    state, aux = step(state, _torch_batch(batch), draws=draws)
    hook.remove()
    return {k: float(v) for k, v in aux.items()}, grads, before, state


def test_every_aux_entry_matches(jax_side, torch_side):
    aux_j, aux_t = jax_side[0], torch_side[0]
    assert set(aux_t) == set(aux_j) and "loss_ocr_texts" in aux_t
    for key, want in aux_j.items():
        # float32 through the whole forward of both packages
        np.testing.assert_allclose(aux_t[key], want, rtol=2e-4, err_msg=key)
    np.testing.assert_allclose(
        aux_t["loss_total"], aux_t["loss_diffusion"] + OCR_WEIGHT * aux_t["loss_ocr"], rtol=1e-6
    )


def _flat(tree, prefix=""):
    for key, node in tree.items():
        if isinstance(node, dict):
            yield from _flat(node, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", node


def test_gradients_match_leaf_by_leaf(setup, jax_side, torch_side):
    _, params, tm, _, _ = setup
    grads_j = dict(_flat(jax_side[1]))
    grads_t = dict(_flat(to_jax_params(torch_side[1], params)))
    mask = dict(_flat(jax_trainable_mask(params, "stage3")))
    assert set(grads_t) == set(grads_j)
    largest = max(np.abs(g).max() for path, g in grads_j.items() if mask[path])
    checked = 0
    for path, want in grads_j.items():
        got = grads_t[path]
        if not mask[path]:
            assert got is None, f"frozen leaf {path} has a gradient"
            continue
        assert got is not None, f"trained leaf {path} has no gradient"
        # float32 both sides; the absolute part scales with the leaf's own
        # largest gradient, for elements that cancel to near zero, and with
        # the largest gradient of all, for leaves whose true gradient is zero
        # (a bias in front of a one-channel-per-group norm) and hold only
        # rounding noise on both sides
        np.testing.assert_allclose(
            got, want, rtol=2e-3, atol=2e-4 * np.abs(want).max() + 1e-6 * largest,
            err_msg=path,
        )
        checked += 1
    assert checked == count_trainable(trainable_mask(tm, "stage3"))
    # the named leaves: trained ones carry a gradient that is not all zero,
    # frozen ones none
    for path in (
        "controlnet/in_conv/kernel",
        "unet/in_1/attn/block_0/attn1/to_q/kernel",
        "testr/transformer/enc_0/self_attn/sampling_offsets/kernel",
        "testr/transformer/dec_1/attn_cross_text/value_proj/kernel",
    ):
        assert np.abs(grads_t[path]).max() > 0, path
    for path in ("unet/in_1/res/in_conv/kernel", "vae/quant_conv/kernel"):
        assert grads_t[path] is None, path


def test_parameters_after_one_adamw_step(setup, jax_side, torch_side):
    _, params, tm, _, _ = setup
    before, state = torch_side[2], torch_side[3]
    assert state.step == 1
    after = tm.state_dict()
    want = from_jax_params(jax_side[2])
    grads_j = from_jax_params(jax_side[1])
    mask = trainable_mask(tm, "stage3")
    moved = 0
    for name, p in tm.named_parameters():
        if not mask[name]:
            assert torch.equal(after[name], before[name]), f"frozen {name} changed"
            continue
        # Adam's first update is lr * g / (|g| + eps): lr in size whatever the
        # gradient's. Where the gradient stands clear of float32 noise the two
        # updates agree to a tenth of lr; where it is noise (|g| < 1e-6) its
        # sign is noise too, and both sides still moved by at most lr
        solid = grads_j[name].abs().numpy() >= 1e-6
        err = np.abs(after[name].numpy() - want[name].numpy())
        assert (err[solid] <= 0.1 * LR).all(), (name, err[solid].max())
        assert (err <= 2.1 * LR).all(), (name, err.max())
        moved += int(not torch.equal(after[name], before[name]))
    assert moved == count_trainable(mask)


@pytest.mark.parametrize("stage", ["stage1", "stage2", "stage3"])
def test_trainable_mask_equals_jax_mask(setup, stage):
    _, params, tm, _, _ = setup
    mask_t = trainable_mask(tm, stage)
    filled = {
        name: torch.full(p.shape, float(mask_t[name])) for name, p in tm.named_parameters()
    }
    ours = dict(_flat(to_jax_params(filled, params)))
    theirs = dict(_flat(jax_trainable_mask(params, stage)))
    assert set(ours) == set(theirs)
    for path, want in theirs.items():
        assert bool(ours[path].all()) == bool(ours[path].any()) == bool(want), path
    assert count_trainable(mask_t) == sum(theirs.values()) > 0


def test_adamw_hyperparameters_match_optax_over_steps():
    """make_optimizer's AdamW against optax.adamw (its defaults are the JAX
    package's) over five steps with given gradients."""
    rng = np.random.default_rng(63)
    p0 = rng.standard_normal((7, 5)).astype(np.float32)
    grads = [rng.standard_normal((7, 5)).astype(np.float32) for _ in range(5)]

    class Toy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.testr = torch.nn.ParameterDict({"w": torch.nn.Parameter(torch.from_numpy(p0.copy()))})
            self.swinir = torch.nn.ParameterDict({"w": torch.nn.Parameter(torch.from_numpy(p0.copy()))})

    toy = Toy()
    opt = tstep.make_optimizer(toy, "stage2", 1e-2)
    assert [p is toy.testr["w"] for g in opt.param_groups for p in g["params"]] == [True]
    assert not toy.swinir["w"].requires_grad
    tx = optax.adamw(1e-2)
    pj = jnp.asarray(p0)
    st = tx.init(pj)
    for g in grads:
        toy.testr["w"].grad = torch.from_numpy(g.copy())
        opt.step()
        updates, st = tx.update(jnp.asarray(g), st, pj)
        pj = optax.apply_updates(pj, updates)
    np.testing.assert_allclose(toy.testr["w"].detach().numpy(), np.asarray(pj), atol=1e-6)
    np.testing.assert_array_equal(toy.swinir["w"].detach().numpy(), p0)


def test_two_accumulated_calls_equal_one_step_on_the_mean_gradient(setup):
    """grad_accum=2: the first call moves nothing, the second applies AdamW to
    the mean of the two micro-batch gradients."""
    from tair_tpu_torch.pipeline import build_tiny_model

    jm, params, tm, batch, rng = setup
    draws = {k: torch.from_numpy(v) for k, v in _draws(jm, params, batch, rng).items()}
    micro = [
        (_torch_batch(batch, slice(i, i + 1)), {k: v[i : i + 1] for k, v in draws.items()})
        for i in range(B)
    ]
    start = from_jax_params(params)

    def fresh():
        model = build_tiny_model(device="cpu", training=True)
        model.load_state_dict(start, strict=True)
        return model

    kwargs = dict(ocr_loss_weight=OCR_WEIGHT)
    a = fresh()
    state = tstep.create_train_state(a, "stage3", LR, grad_accum=2)
    step = tstep.make_train_step(
        a, Diffusion(a.schedule), spotter_loss_fn=a.spotter_loss_fn(), **kwargs
    )
    state, _ = step(state, micro[0][0], draws=micro[0][1])
    assert state.step == 1
    assert all(torch.equal(v, start[k]) for k, v in a.state_dict().items())
    state, _ = step(state, micro[1][0], draws=micro[1][1])
    assert state.step == 2

    b = fresh()
    opt = tstep.make_optimizer(b, "stage3", LR)
    losses = [
        tstep.diffusion_loss_fn(
            b, Diffusion(b.schedule), mb, draws=d, spotter_loss_fn=b.spotter_loss_fn(), **kwargs
        )[0]
        for mb, d in micro
    ]
    (sum(losses) / len(losses)).backward()
    opt.step()
    sa, sb = a.state_dict(), b.state_dict()
    for name in sa:
        # the same gradients summed in another order, through Adam's normalisation
        np.testing.assert_allclose(sa[name].numpy(), sb[name].numpy(), atol=0.05 * LR, err_msg=name)
    assert any(not torch.equal(sa[k], start[k]) for k in sa)


def test_timestep_max_beyond_the_schedule_raises(setup):
    _, _, tm, batch, _ = setup
    with pytest.raises(ValueError, match="timestep_max"):
        tstep.diffusion_loss_fn(tm, Diffusion(tm.schedule), _torch_batch(batch), timestep_max=1001)
