"""The sparse encoder update of the port's spotter (``TESTRConfig.enc_topk``)
against the JAX TESTR at ``tests/test_spotter.py::TINY``, float32 on the CPU.

The feature maps are TINY's four levels with the last one 2 x 64, so that
proposals exist whose centre falls within 0.01 of the image's edge: those are
invalid (``proposal_grid``), score -inf and are selected only when
``enc_topk`` exceeds the valid count. S = 4 + 16 + 64 + 128 = 212 tokens, of
which 208 are valid. Every parameter is seeded noise (``noise_params``).

- the TESTR outputs, final and aux, within the dense path's ``TOL`` of
  ``test_torch_spotter.py`` at ``enc_topk`` below the valid count, between it
  and S, and at S and above (the exact path);
- ``enc_topk`` 0, S and above: the port's outputs bit-equal to its dense path;
- the tie rule: among equal saliences the lower index wins, as
  ``jax.lax.top_k`` chooses (zeroed salience head: the first valid tokens;
  more than the valid count: the first invalid ones); the same rule, in
  ``jax.lax.top_k``'s descending order, for the two-stage proposals;
- an encoder layer's unselected tokens pass through bit for bit, and the
  parameter tree does not depend on ``enc_topk``;
- ``val`` / ``val_patches`` serve with ``--enc-topk`` on the CPU.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tair_tpu.spotter import TESTR as JaxTESTR
from tair_tpu_torch.spotter.testr import TESTR, TESTRConfig
from tair_tpu_torch.spotter.transformer import (
    EncoderLayer, encoder_reference_points, proposal_grid, proposal_indices,
)
from tair_tpu_torch.weights.convert import convert_tree, module_param_shapes
from test_spotter import TINY
from test_torch_common import (  # noqa: F401
    compiling, jax_fast_compiles, jax_shapes, noise_params, t2n, torch_single_thread,
)
from test_torch_spotter import TOL

ROOT = Path(__file__).resolve().parents[1]
LEVELS = ((2, 2), (4, 4), (8, 8), (2, 64))
S = sum(h * w for h, w in LEVELS)
VALID = int(proposal_grid(LEVELS)[1].sum())
BELOW_VALID, ABOVE_VALID = 50, VALID + 2
TOPKS = (0, BELOW_VALID, ABOVE_VALID, S)
KEYS = ("pred_logits", "pred_ctrl_points", "pred_texts")


def _port_cfg(enc_topk: int = 0) -> TESTRConfig:
    fields = {f.name for f in dataclasses.fields(TESTRConfig)} - {"enc_topk"}
    return TESTRConfig(**{f: getattr(TINY, f) for f in fields}, enc_topk=enc_topk)


@pytest.fixture(scope="module")
def feats():
    rng = np.random.default_rng(141)
    return tuple(
        rng.standard_normal((2, h, w, c), dtype=np.float32)
        for (h, w), c in zip(LEVELS, TINY.in_channels)
    )


@pytest.fixture(scope="module")
def params(feats):
    return noise_params(jax_shapes(JaxTESTR(TINY).init, feats)["params"], 142)


def _port(params, enc_topk: int) -> TESTR:
    model = TESTR(_port_cfg(enc_topk))
    model.load_state_dict(convert_tree(params), strict=True)
    return model.eval()


def _port_out(params, feats, enc_topk: int):
    with torch.no_grad():
        return _port(params, enc_topk)(tuple(torch.from_numpy(f) for f in feats))


@pytest.fixture(scope="module")
def runs(params, feats):
    """{enc_topk: (JAX outputs, port outputs)}; each JAX TESTR jit-compiled
    once, all of them together (`compiling`) while the port's run."""
    compiled = {}
    for k in TOPKS:  # each compiles while the next is traced
        jm = JaxTESTR(dataclasses.replace(TINY, enc_topk=k))
        compiled.update(compiling(
            {k: jax.jit(lambda p, f, jm=jm: jm.apply({"params": p}, f)).lower(params, feats)}))
    ports = {k: _port_out(params, feats, k) for k in TOPKS}
    return {k: (compiled[k].result()(params, feats), ports[k]) for k in TOPKS}


def test_geometry_has_invalid_proposals():
    assert (S, VALID) == (212, 208)
    assert 0 < BELOW_VALID < VALID < ABOVE_VALID < S


@pytest.mark.parametrize("enc_topk", TOPKS)
def test_outputs_match_jax(runs, enc_topk):
    want, got = runs[enc_topk]
    for key in KEYS:
        np.testing.assert_allclose(t2n(got[key]), np.asarray(want[key]), atol=TOL, err_msg=key)
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == TINY.num_decoder_layers - 1
    for a_t, a_j in zip(got["aux_outputs"], want["aux_outputs"]):
        for key in KEYS:
            np.testing.assert_allclose(t2n(a_t[key]), np.asarray(a_j[key]), atol=TOL, err_msg=key)
    for key in ("pred_logits", "pred_boxes"):
        np.testing.assert_allclose(
            t2n(got["enc_outputs"][key]), np.asarray(want["enc_outputs"][key]), atol=TOL
        )


def test_sparse_update_changes_the_outputs(runs):
    """The sparse settings are not the dense path in disguise."""
    dense = runs[0][1]["pred_logits"]
    for k in (BELOW_VALID, ABOVE_VALID):
        assert not torch.equal(runs[k][1]["pred_logits"], dense)


@pytest.mark.parametrize("enc_topk", [S, S + 100])
def test_topk_at_or_above_s_is_the_dense_path_bit_for_bit(params, feats, runs, enc_topk):
    got = _port_out(params, feats, enc_topk)
    dense = runs[0][1]
    for key in KEYS:
        assert torch.equal(got[key], dense[key]), key
    for key in ("pred_logits", "pred_boxes"):
        assert torch.equal(got["enc_outputs"][key], dense["enc_outputs"][key])


def _salience_inputs(params, feats):
    """(the port's transformer, its flattened encoder input, validity mask)."""
    model = _port(params, BELOW_VALID)
    srcs = [getattr(model, f"diff_feat_proj_{i}")(torch.from_numpy(f)) for i, f in enumerate(feats)]
    src_flat = torch.cat([s.reshape(2, -1, TINY.d_model) for s in srcs], dim=1)
    return model.transformer, src_flat, torch.from_numpy(proposal_grid(LEVELS)[1])


def _jax_choice(sal: np.ndarray, k: int) -> np.ndarray:
    return np.sort(np.asarray(jax.lax.top_k(jnp.asarray(sal), k)[1]), axis=1)


@pytest.mark.parametrize("enc_topk", [BELOW_VALID, ABOVE_VALID])
def test_selection_follows_jax_top_k_with_ties(params, feats, enc_topk):
    """With the salience head zeroed every valid token ties at 0 and every
    invalid one at -inf: the port selects what ``jax.lax.top_k`` selects, the
    lowest indices first (below the valid count, the first valid tokens; above
    it, every valid token and the first invalid ones)."""
    transformer, src_flat, valid = _salience_inputs(params, feats)
    transformer.enc_topk = enc_topk
    with torch.no_grad():
        transformer.bbox_class_embed.weight.zero_()
        transformer.bbox_class_embed.bias.zero_()
        sel = transformer.select_tokens(src_flat, valid).numpy()
    sal = np.where(valid.numpy(), 0.0, -np.inf).astype(np.float32)
    want = _jax_choice(np.broadcast_to(sal, (2, S)), enc_topk)
    np.testing.assert_array_equal(sel, want)
    first_valid = np.flatnonzero(valid.numpy())[:BELOW_VALID]
    if enc_topk == BELOW_VALID:
        np.testing.assert_array_equal(sel, np.broadcast_to(first_valid, (2, enc_topk)))
    else:
        invalid = np.flatnonzero(~valid.numpy())[: enc_topk - VALID]
        np.testing.assert_array_equal(
            sel, np.broadcast_to(np.sort(np.r_[np.flatnonzero(valid.numpy()), invalid]),
                                 (2, enc_topk)))


def test_selection_of_seeded_saliences_equals_jax(params, feats):
    """On the seeded head the port's choice equals ``jax.lax.top_k`` on the
    same saliences, with the invalid tokens' -inf ties above the valid count."""
    transformer, src_flat, valid = _salience_inputs(params, feats)
    with torch.no_grad():
        sal = transformer.bbox_class_embed(
            transformer.enc_output_norm(transformer.enc_output(src_flat)))[..., 0]
        sal = sal.masked_fill(~valid[None], -torch.inf).numpy()
        for k in (BELOW_VALID, ABOVE_VALID):
            transformer.enc_topk = k
            sel = transformer.select_tokens(src_flat, valid).numpy()
            np.testing.assert_array_equal(sel, _jax_choice(sal, k))


def test_proposals_order_ties_as_jax_top_k(params, feats):
    """The two-stage proposals with the class head zeroed: every valid token
    scores 0, every invalid one -inf. The port's proposals (the decoder's
    reference points) are the tokens ``jax.lax.top_k`` picks from the same
    scores, in its order, the lower index first among ties: the first
    ``num_proposals`` valid tokens."""
    model = _port(params, 0)
    captured = []
    model.transformer.register_forward_hook(lambda mod, args, out: captured.append(out))
    with torch.no_grad():
        model.transformer.bbox_class_embed.weight.zero_()
        model.transformer.bbox_class_embed.bias.zero_()
        model(tuple(torch.from_numpy(f) for f in feats))
    _, _, reference_points, enc_class, enc_coord_unact = captured[-1]
    valid = proposal_grid(LEVELS)[1]
    scores = np.where(valid[None], t2n(enc_class[..., 0]), -np.inf).astype(np.float32)
    assert set(np.unique(scores)) == {0.0, -np.inf}
    want = np.asarray(jax.lax.top_k(jnp.asarray(scores), TINY.num_proposals)[1])
    np.testing.assert_array_equal(
        want, np.broadcast_to(np.flatnonzero(valid)[: TINY.num_proposals], want.shape))
    idx = torch.from_numpy(want.astype(np.int64))[..., None].expand(-1, -1, 4)
    assert torch.equal(reference_points, torch.sigmoid(torch.gather(enc_coord_unact, 1, idx)))


def test_proposal_indices_equal_jax_top_k_with_inf_ties():
    """``proposal_indices`` against ``jax.lax.top_k`` on rows with tied
    finite scores and more -inf scores than the k asks past them."""
    scores = np.array([[0.5, -np.inf, 0.5, 0.0, -np.inf, 0.5, -np.inf],
                       [-np.inf, 0.0, -np.inf, 0.0, 1.0, -np.inf, 0.0]], np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(scores), 6)[1])
    got = proposal_indices(torch.from_numpy(scores), 6).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1], [4, 1, 3, 6, 0, 2])


def test_unselected_tokens_pass_through_bit_for_bit():
    shapes = ((2, 3), (4, 6))
    s = sum(h * w for h, w in shapes)
    rng = np.random.default_rng(143)
    layer = EncoderLayer(d_model=16, d_ffn=32, n_levels=2, n_heads=4, n_points=2).eval()
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.from_numpy(0.3 * rng.standard_normal(p.shape, dtype=np.float32)))
    src = torch.from_numpy(rng.standard_normal((2, s, 16), dtype=np.float32))
    pos = torch.from_numpy(rng.standard_normal((2, s, 16), dtype=np.float32))
    ref = torch.from_numpy(encoder_reference_points(shapes))[None].expand(2, -1, -1, -1)
    idx = np.sort(np.stack([rng.choice(s, 7, replace=False) for _ in range(2)]), axis=1)
    before = src.clone()
    with torch.no_grad():
        out = layer(src, pos, ref, shapes, torch.from_numpy(idx))
        dense = layer(src, pos, ref, shapes)
    assert torch.equal(src, before)  # the layer's input is not written
    for b in range(2):
        keep = np.setdiff1d(np.arange(s), idx[b])
        assert torch.equal(out[b, keep], src[b, keep])
        # a selected token's update is the dense path's for it (both read src)
        torch.testing.assert_close(out[b, idx[b]], dense[b, idx[b]], rtol=0, atol=1e-5)


def test_parameter_tree_does_not_depend_on_enc_topk():
    trees = [module_param_shapes(TESTR(_port_cfg(k))) for k in (0, BELOW_VALID, S)]
    shapes = [jax.tree.map(lambda s: tuple(s.shape), t) for t in trees]
    assert shapes[0] == shapes[1] == shapes[2]
    states = [TESTR(_port_cfg(k)).state_dict() for k in (0, BELOW_VALID)]
    assert {k: v.shape for k, v in states[0].items()} == {k: v.shape for k, v in states[1].items()}


def test_negative_enc_topk_raises():
    with pytest.raises(ValueError, match="enc_topk"):
        TESTR(_port_cfg(-1))


def _config(tmp_path: Path) -> Path:
    """configs/val_smoke.yaml (the tiny model) with absolute image paths, the
    spotter in the loop of val_patches, and an output directory under tmp_path."""
    text = (ROOT / "configs" / "val_smoke.yaml").read_text()
    text = text.replace("./assets", str(ROOT / "assets"))
    text = text.replace("./results/smoke", str(tmp_path / "out"))
    text = text.replace("tiled_ocr_loop: false", "tiled_ocr_loop: true")
    path = tmp_path / "val.yaml"
    path.write_text(text)
    return path


@pytest.mark.parametrize("entry", ["val", "val_patches"])
def test_entry_points_serve_with_enc_topk(tmp_path, entry, monkeypatch):
    """``--enc-topk`` reaches the spotter of the served model: the tiny model's
    encoder has fewer tokens than the 64-pixel images give it, so 8 selects a
    subset and the sparse branch runs."""
    import importlib

    from tair_tpu_torch.spotter import transformer as tt

    seen = []
    select = tt.DeformableTransformer.select_tokens
    monkeypatch.setattr(tt.DeformableTransformer, "select_tokens",
                        lambda self, *a: seen.append(self.enc_topk) or select(self, *a))
    main = importlib.import_module(f"tair_tpu_torch.{entry}").main
    extra = ["--fused", "--image-size", "64"] if entry == "val" else []
    main(["--config", str(_config(tmp_path)), "--device", "cpu", "--steps", "1",
          "--enc-topk", "8", *extra])
    assert seen and set(seen) == {8}
    written = sorted(p.name for p in (tmp_path / "out").iterdir())
    assert any(name.startswith("restored_") for name in written)
