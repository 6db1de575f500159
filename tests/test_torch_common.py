"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

Both packages get the same parameters: the JAX model's parameter tree is
traced abstractly (``jax.eval_shape`` of its ``init``: structure and shapes,
no compute), and EVERY leaf is then filled with seeded numpy noise, so no
leaf keeps an init value of zero or a constant (zero convs, ``proj_out``,
``sampling_offsets``...) that would hide a wrong transposition or lane order.
The port loads the tree through ``weights.convert`` with ``strict=True``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tair_tpu_torch.weights.convert import BUNDLE_KEYS, convert_tree


@pytest.fixture(autouse=True, scope="module")
def torch_single_thread():
    """The suite runs several workers at once; PyTorch's intra-op thread pool
    in each of them oversubscribes the cores and slows these tiny models
    a hundredfold. Import this fixture into a test module to pin it to one
    thread for that module's tests."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def noise_params(shapes, seed: int):
    """Nested dict of numpy float32 arrays for a tree of ShapeDtypeStructs."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = path[-1].key
        shape = tuple(s.shape)
        noise = rng.standard_normal(shape, dtype=np.float32)
        if leaf == "kernel":
            return noise * np.float32(1.0 / np.sqrt(np.prod(shape[:-1])))
        if leaf == "scale":
            return np.float32(1.0) + np.float32(0.1) * noise
        if leaf == "bias":
            return np.float32(0.1) * noise
        return np.float32(0.5) * noise  # embeddings, bias tables

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return jax.tree.map(np.asarray, tree)


def jax_shapes(init_fn, *args):
    """Abstract trace of `init_fn(key, *args)`; static arguments are closed over."""
    return jax.eval_shape(init_fn, jax.random.PRNGKey(0), *args)


@functools.lru_cache(maxsize=None)
def _tiny_shapes(part: str):
    """Parameter shapes of one sub-model of the JAX tiny bundle (traced once
    per worker process, whichever test file asks first)."""
    from tair_tpu.pipeline import build_tiny_model as jax_tiny

    jm = jax_tiny()
    x = jnp.zeros((1, 8, 8, 4))
    t = jnp.zeros((1,), jnp.int32)
    ctx = jnp.zeros((1, 77, 64))
    img = jnp.zeros((1, 64, 64, 3))
    init = {
        "unet": lambda k: jm.cldm.unet.init(k, x, t, ctx),
        "controlnet": lambda k: jm.cldm.controlnet.init(k, x, x, t, ctx),
        "vae": lambda k: jm.cldm.vae.init(k, img),
        "clip": lambda k: jm.cldm.clip.init(k, jnp.zeros((1, 77), jnp.int32)),
        "swinir": lambda k: jm.swinir.init(k, img),
        "testr": lambda k: jm.testr.init(k, jm._dummy_feats(8)),
    }[part]
    return jax.eval_shape(init, jax.random.PRNGKey(0))["params"]


def tiny_pair(seed: int = 0, parts=BUNDLE_KEYS):
    """(JAX tiny TeReDiff, noise-filled params of `parts`, the port's tiny
    TeReDiff holding the same parameters in those parts), float32 on the CPU.
    Each part is loaded with ``strict=True``; parts left out keep the port's
    own initial values and must not be used by the test."""
    from tair_tpu.pipeline import build_tiny_model as jax_tiny
    from tair_tpu_torch.pipeline import build_tiny_model as torch_tiny

    params = noise_params({part: _tiny_shapes(part) for part in parts}, seed)
    tm = torch_tiny(device="cpu")
    for part in parts:
        holder = tm if part in ("swinir", "testr") else tm.cldm
        getattr(holder, part).load_state_dict(convert_tree(params[part]), strict=True)
    return jax_tiny(), params, tm


def load_module(module: torch.nn.Module, tree) -> torch.nn.Module:
    module.load_state_dict(convert_tree(tree), strict=True)
    return module.eval()


def t2n(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().float().numpy()


def test_noise_params_leave_no_constant_leaf():
    from tair_tpu.spotter.ms_deform_attn import MSDeformAttn

    mod = MSDeformAttn(d_model=32, n_levels=2, n_heads=4, n_points=2, core="flatlanes")
    shapes = jax_shapes(
        lambda key, *args: mod.init(key, *args, ((2, 2), (4, 4))),
        jnp.zeros((1, 3, 32)), jnp.zeros((1, 3, 2, 2)), jnp.zeros((1, 20, 32)),
    )["params"]
    params = noise_params(shapes, 0)
    for leaf in jax.tree.leaves(params):
        assert leaf.dtype == np.float32 and np.std(leaf) > 0
