"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

Both packages get the same parameters: the JAX model's parameter tree
(structure and shapes; for the tiny bundle worked out from the port's modules
by ``weights.convert.jax_param_shapes``, which equals the abstract trace of
the JAX ``init``) has EVERY leaf filled with seeded numpy noise, so no leaf
keeps an init value of zero or a constant (zero convs, ``proj_out``,
``sampling_offsets``...) that would hide a wrong transposition or lane order.
The port loads the tree through ``weights.convert`` with ``strict=True``.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tair_tpu_torch.weights.convert import BUNDLE_KEYS, convert_tree, jax_param_shapes


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


@pytest.fixture(autouse=True, scope="module")
def jax_fast_compiles():
    """Import this fixture into a test module whose JAX references cost more
    to compile than to run: they compile without XLA's costly passes for that
    module's tests (`jax_compiles_fast`)."""
    with jax_compiles_fast():
        yield


@contextlib.contextmanager
def jax_compiles_fast():
    """JAX programs compiled without XLA's costly optimisation passes
    (``jax_disable_most_optimizations``): the same float32 program, most of
    whose cost at the tests' tiny shapes is its compilation. JAX's caches are
    cleared after, so no program compiled so stays in them."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", before)
        jax.clear_caches()


def compiling(lowered: dict) -> dict:
    """{name: a future of the executable} of {name: ``jax.jit(...).lower(...)``},
    each compiling in a thread of its own from now on: XLA's compiler
    releases the GIL, so the programs compile together and beside whatever
    the test does meanwhile, and a module's references cost the longest
    compilation, not the sum."""
    import concurrent.futures

    pool = concurrent.futures.ThreadPoolExecutor(max(1, len(lowered)))
    futures = {name: pool.submit(low.compile) for name, low in lowered.items()}
    pool.shutdown(wait=False)
    return futures


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
    """Parameter shapes of one sub-model of the JAX tiny bundle, by an
    abstract trace of its JAX ``init`` (traced once per worker process)."""
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


@functools.lru_cache(maxsize=None)
def tiny_bundle_shapes():
    """The JAX tiny bundle's parameter tree, worked out from the port's tiny
    model: leaf for leaf the tree of `_tiny_shapes`, without tracing the JAX
    ``init`` (``test_torch_config_checkpoint.py::test_port_export_loads_into_jax``
    holds the two equal)."""
    from tair_tpu_torch.pipeline import build_tiny_model

    return jax_param_shapes(build_tiny_model(device="cpu"))


def tiny_pair(seed: int = 0, parts=BUNDLE_KEYS):
    """(JAX tiny TeReDiff, noise-filled params of `parts`, the port's tiny
    TeReDiff holding the same parameters in those parts), float32 on the CPU.
    Each part is loaded with ``strict=True``; parts left out keep the port's
    own initial values and must not be used by the test."""
    from tair_tpu.pipeline import build_tiny_model as jax_tiny
    from tair_tpu_torch.pipeline import build_tiny_model as torch_tiny

    params = noise_params({part: tiny_bundle_shapes()[part] for part in parts}, seed)
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


def assert_trees_equal(got, want, path=()):
    """Two parameter trees (nested dicts of arrays) hold the same leaves, bit for bit."""
    assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
    for key, node in want.items():
        if isinstance(node, dict):
            assert_trees_equal(got[key], node, path + (key,))
        else:
            g, w = np.asarray(got[key]), np.asarray(node)
            assert g.shape == w.shape, (path + (key,), g.shape, w.shape)
            np.testing.assert_array_equal(g, w, err_msg="/".join(path + (key,)))


def save_checkpoint(path, sd) -> str:
    """{name: numpy array} saved as PyTorch tensors with ``torch.save``."""
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)
    return str(path)


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


def iqa_checkpoints(root, names=("lpips", "dists", "clipiqa", "maniqa", "musiq")) -> dict:
    """{metric: its ``val.<name>_weights`` entry}: a checkpoint of each learned
    IQA metric of `names`, written under `root` by the port's exporter from
    seeded parameters in the published layouts, at geometries that both
    packages' readers infer from the shapes: LPIPS and DISTS at their fixed
    widths; CLIP-IQA's tiny RN50 (stem 8, 64 x 64 grid, text width 8, 2
    layers); MANIQA's ViT at width 64, depth 10 on 32 x 32 (the published
    extract blocks 6-9 and Swin settings); MUSIQ at hidden 16, 2 layers, the
    published two resize scales."""
    from pathlib import Path

    from tair_tpu.models.clip import CLIPTextConfig as JaxTextConfig
    from tair_tpu.models.clip import CLIPTextTower as JaxTextTower
    from tair_tpu.utils import clipiqa as jclip
    from tair_tpu.utils import dists as jdists
    from tair_tpu.utils import lpips as jlpips
    from tair_tpu.utils import maniqa as jmaniqa
    from tair_tpu.utils import musiq as jmusiq
    from tair_tpu_torch.models.clip import CLIPTextConfig
    from tair_tpu_torch.utils import clipiqa, maniqa, musiq
    from tair_tpu_torch.weights import export as tx

    root = Path(root)
    x64 = jnp.zeros((1, 64, 64, 3))

    def lpips():
        params = noise_params(jax_shapes(jlpips.LPIPS().init, x64, x64)["params"], 201)
        alex, lin = tx.export_lpips(params)
        return (f"{save_checkpoint(root / 'alexnet.pth', alex)}:"
                f"{save_checkpoint(root / 'lpips_lin.pth', lin)}")

    def dists():
        params = noise_params(jax_shapes(jdists.DISTS().init, x64, x64)["params"], 202)
        for name in ("alpha", "beta"):
            params[name] = np.abs(params[name]) + np.float32(0.1)
        vgg, weights = tx.export_dists(params)
        return (f"{save_checkpoint(root / 'vgg16.pth', vgg)}:"
                f"{save_checkpoint(root / 'dists_weights.pt', weights)}")

    def clip():
        visual = dict(layers=(1, 1, 1, 1), width=8, embed_dim=16, heads=4, image_size=64)
        text = dict(width=8, heads=1, layers=2, layer="last", act="quick_gelu")
        tree = {
            "visual": noise_params(jax_shapes(jclip.ModifiedResNet(
                jclip.ModifiedResNetConfig(**visual)).init, x64)["params"], 203),
            "text": noise_params(jax_shapes(JaxTextTower(JaxTextConfig(**text)).init,
                                            jnp.zeros((1, 77), jnp.int32))["params"], 204),
            "text_projection": np.random.default_rng(205).standard_normal((8, 16),
                                                                          dtype=np.float32),
            "logit_scale": np.asarray(np.log(5.0), np.float32),
        }
        positive_variances(tree["visual"])
        sd = tx.export_clipiqa(tree, clipiqa.ModifiedResNetConfig(**visual),
                               CLIPTextConfig(**text))
        return save_checkpoint(root / "RN50.pt", sd)

    def maniqa_():
        vit = dict(img_size=32, patch_size=8, dim=64, depth=10, heads=1)
        jcfg = jmaniqa.MANIQAConfig(vit=jmaniqa.ViTConfig(**vit), embed_dim=16)
        params = noise_params(
            jax_shapes(jmaniqa.MANIQA(jcfg).init, jnp.zeros((1, 32, 32, 3)))["params"], 206)
        sd = tx.export_maniqa(params, maniqa.MANIQAConfig(vit=maniqa.ViTConfig(**vit),
                                                          embed_dim=16))
        return save_checkpoint(root / "ckpt_koniq10k.pt", sd)

    def musiq_():
        geometry = dict(hidden=16, layers=2, heads=1, mlp=24, root_width=8, hash_grid=4)
        params = noise_params(jax_shapes(jmusiq.MUSIQ(jmusiq.MUSIQConfig(**geometry)).init,
                                         x64)["params"], 207)
        return save_checkpoint(root / "musiq.pth",
                               tx.export_musiq(params, musiq.MUSIQConfig(**geometry)))

    build = {"lpips": lpips, "dists": dists, "clipiqa": clip, "maniqa": maniqa_,
             "musiq": musiq_}
    return {name: build[name]() for name in names}


def positive_variances(tree) -> None:
    """Every batch-norm variance (a leaf ``var``) of the tree made positive, in place."""
    for key, node in tree.items():
        if isinstance(node, dict):
            positive_variances(node)
        elif key == "var":
            tree[key] = np.abs(node) + np.float32(0.5)
