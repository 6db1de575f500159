"""``weights.convert.from_jax_params``: every JAX leaf is consumed, the result
loads with ``strict=True``, shapes and layouts are right, unknown leaves raise."""

import jax
import numpy as np
import pytest
import torch

from tair_tpu.weights.convert import t_conv_inv
from tair_tpu_torch.weights.convert import BUNDLE_KEYS, convert_tree, from_jax_params
from test_torch_common import tiny_pair, torch_single_thread  # noqa: F401


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=61)


def test_every_leaf_consumed_and_strict_load(pair):
    _, params, tm = pair
    state = from_jax_params(params)
    assert set(params) == set(BUNDLE_KEYS)
    assert len(state) == len(jax.tree.leaves(params))
    assert set(state) == set(tm.state_dict())
    for name, value in tm.state_dict().items():
        assert tuple(state[name].shape) == tuple(value.shape), name
        assert torch.equal(state[name], value), name
    total = sum(int(np.prod(l.shape)) for l in jax.tree.leaves(params))
    assert total == sum(p.numel() for p in tm.parameters())


def test_layouts(pair):
    _, params, _ = pair
    state = from_jax_params(params)
    conv = params["unet"]["in_1"]["res"]["in_conv"]["kernel"]
    np.testing.assert_array_equal(
        state["cldm.unet.in_1.res.in_conv.weight"].numpy(), t_conv_inv(conv)
    )
    dense = params["unet"]["in_1"]["attn"]["block_0"]["attn1"]["to_q"]["kernel"]
    np.testing.assert_array_equal(
        state["cldm.unet.in_1.attn.blocks.0.attn1.to_q.weight"].numpy(), dense.T
    )
    gn = params["unet"]["in_1"]["res"]["in_norm"]["GroupNorm_0"]["scale"]
    np.testing.assert_array_equal(state["cldm.unet.in_1.res.in_norm.weight"].numpy(), gn)
    q = params["clip"]["block_0"]["attn"]["query"]  # kernel [in, H, D], bias [H, D]
    np.testing.assert_array_equal(
        state["cldm.clip.blocks.0.attn.query.weight"].numpy(),
        q["kernel"].reshape(q["kernel"].shape[0], -1).T,
    )
    np.testing.assert_array_equal(
        state["cldm.clip.blocks.0.attn.query.bias"].numpy(), q["bias"].reshape(-1)
    )
    o = params["clip"]["block_0"]["attn"]["out"]["kernel"]  # [H, D, out]
    np.testing.assert_array_equal(
        state["cldm.clip.blocks.0.attn.out.weight"].numpy(), o.reshape(-1, o.shape[-1]).T
    )
    np.testing.assert_array_equal(
        state["cldm.clip.token_embedding.weight"].numpy(),
        params["clip"]["token_embedding"]["embedding"],
    )
    np.testing.assert_array_equal(
        state["swinir.layers.0.blocks.1.attn.rel_pos_bias_table"].numpy(),
        params["swinir"]["layer_0"]["block_1"]["attn"]["rel_pos_bias_table"],
    )
    np.testing.assert_array_equal(
        state["testr.transformer.level_embed"].numpy(),
        params["testr"]["transformer"]["level_embed"],
    )


def test_cross_check_against_the_jax_exporters(pair):
    """The JAX package writes its params out under the original checkpoint
    names; values must agree with this converter tensor by tensor."""
    from tair_tpu.weights import export

    jm, params, _ = pair
    state = from_jax_params(params)
    sd = export.export_vae(params["vae"], jm.cldm.vae.cfg)
    np.testing.assert_array_equal(
        sd["encoder.conv_in.weight"], state["cldm.vae.encoder.conv_in.weight"].numpy()
    )
    np.testing.assert_array_equal(
        sd["decoder.mid.attn_1.q.weight"], state["cldm.vae.decoder.mid_attn.q.weight"].numpy()
    )


def test_unknown_leaf_and_unknown_tree_raise():
    with pytest.raises(ValueError, match="no rule"):
        convert_tree({"layer": {"mystery": np.zeros((2, 2), np.float32)}})
    with pytest.raises(ValueError, match="no rule"):
        convert_tree({"layer": {"kernel": np.zeros((2, 2, 2, 2, 2), np.float32)}})
    with pytest.raises(ValueError, match="unknown top-level"):
        from_jax_params({"ram": {}})


def test_dtype_argument(pair):
    _, params, _ = pair
    state = from_jax_params({"swinir": params["swinir"]}, dtype=torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for v in state.values())
    assert all(k.startswith("swinir.") for k in state)


@pytest.mark.parametrize("cleaner", ["rrdbnet", "scunet"])
def test_cleaner_trees_round_trip(cleaner):
    """The cleaners load through `convert_tree` (they are not parts of the
    bundle); `module_param_shapes` gives the JAX tree of each from the port's
    modules alone, and `to_jax_tree` inverts the conversion leaf by leaf, the
    transposed convolution of SCUNet ([kh, kw, out, in] in JAX) included."""
    import jax.numpy as jnp

    from tair_tpu.models import cleaners as jc
    from tair_tpu_torch.models import cleaners as tc
    from tair_tpu_torch.weights.convert import module_param_shapes, to_jax_tree
    from test_torch_common import jax_shapes, noise_params

    if cleaner == "scunet":
        cfg = dict(dim=16, config=(1, 1, 1, 1, 1, 1, 1), head_dim=8)
        jmod, tmod = jc.SCUNet(jc.SCUNetConfig(**cfg)), tc.SCUNet(tc.SCUNetConfig(**cfg))
    else:
        cfg = dict(nf=8, nb=2, gc=4, sf=4)
        jmod, tmod = jc.RRDBNet(jc.RRDBNetConfig(**cfg)), tc.RRDBNet(tc.RRDBNetConfig(**cfg))
    shapes = jax_shapes(jmod.init, jnp.zeros((1, 64, 64, 3)))["params"]
    params = noise_params(shapes, 62)
    state = convert_tree(params)
    tmod.load_state_dict(state, strict=True)
    like = module_param_shapes(tmod)
    assert jax.tree.map(lambda s: tuple(s.shape), like) == jax.tree.map(
        lambda s: tuple(s.shape), shapes)
    back = to_jax_tree(tmod.state_dict(), like)
    for (path, got), want in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree.leaves(params)):
        np.testing.assert_array_equal(got, want, err_msg=jax.tree_util.keystr(path))
    if cleaner == "scunet":
        kernel = params["up1_conv"]["kernel"]  # [kh, kw, out, in]
        assert tuple(state["up1_conv.weight"].shape) == (kernel.shape[3], kernel.shape[2], 2, 2)
        np.testing.assert_array_equal(state["up1_conv.weight"].numpy(),
                                      kernel.transpose(3, 2, 0, 1))
