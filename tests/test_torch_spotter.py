"""Port's TESTR spotter against the JAX module at the tiny geometry: every
output of the full forward and the fixed-shape inference decode. Every
parameter is seeded noise, so the msda offset/weight projections and the last
layer of ``ctrl_point_coord`` carry signal."""

import jax
import numpy as np
import pytest
import torch

from tair_tpu.spotter.testr import spotter_inference as jax_inference
from tair_tpu_torch.spotter.testr import spotter_inference
from test_torch_common import jax_fast_compiles, t2n, tiny_pair, torch_single_thread  # noqa: F401

TOL = 1e-4  # float32 on both sides; summation order only


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=31, parts=("testr",))


@pytest.fixture(scope="module")
def feats():
    rng = np.random.default_rng(32)
    return tuple(
        rng.standard_normal((2, s, s, c), dtype=np.float32)
        for s, c in ((2, 128), (4, 128), (8, 64), (8, 32))
    )


@pytest.fixture(scope="module")
def outputs(pair, feats):
    jm, params, tm = pair
    out_j = jax.jit(lambda p, f: jm.spotter_apply(p, f))(params, feats)
    with torch.no_grad():
        out_t = tm.spotter_apply(tuple(torch.from_numpy(f) for f in feats))
    return out_j, out_t


@pytest.mark.parametrize("key", ["pred_logits", "pred_ctrl_points", "pred_texts"])
def test_testr_final_layer_outputs(outputs, key):
    out_j, out_t = outputs
    assert tuple(out_t[key].shape) == tuple(out_j[key].shape)
    np.testing.assert_allclose(t2n(out_t[key]), np.asarray(out_j[key]), atol=TOL)


def test_testr_aux_and_encoder_outputs(outputs):
    out_j, out_t = outputs
    assert len(out_t["aux_outputs"]) == len(out_j["aux_outputs"]) == 1
    for a_t, a_j in zip(out_t["aux_outputs"], out_j["aux_outputs"]):
        for key in ("pred_logits", "pred_ctrl_points", "pred_texts"):
            np.testing.assert_allclose(t2n(a_t[key]), np.asarray(a_j[key]), atol=TOL)
    for key in ("pred_logits", "pred_boxes"):
        np.testing.assert_allclose(
            t2n(out_t["enc_outputs"][key]), np.asarray(out_j["enc_outputs"][key]), atol=TOL
        )


def _set_msda(testr, **fields):
    from tair_tpu_torch.spotter.ms_deform_attn import MSDeformAttn

    mods = [m for m in testr.modules() if isinstance(m, MSDeformAttn)]
    before = [{k: getattr(m, k) for k in fields} for m in mods]
    for m in mods:
        for k, v in fields.items():
            setattr(m, k, v)
    return mods, before


def test_spotter_on_flatpatch_with_the_patchify_kernel_is_the_same_function(pair, feats, outputs):
    """Every deformable attention of the tiny spotter on the `flatpatch` core
    with the packed table from the patchify kernel's plain version: equal to
    the spotter on its default `flatlanes` core (1e-5: the same sums in another
    order) and to the JAX spotter."""
    _, _, tm = pair
    out_j, out_lanes = outputs
    mods, before = _set_msda(tm.testr, core="flatpatch", patchify="kernel")
    assert len(mods) == 1 + 2 * 2  # tiny: 1 encoder layer, 2 decoder layers x 2 branches
    try:
        with torch.no_grad():
            out_patch = tm.spotter_apply(tuple(torch.from_numpy(f) for f in feats))
    finally:
        for m, fields in zip(mods, before):
            for k, v in fields.items():
                setattr(m, k, v)
    for key in ("pred_logits", "pred_ctrl_points", "pred_texts"):
        np.testing.assert_allclose(t2n(out_patch[key]), t2n(out_lanes[key]), atol=1e-5)
        np.testing.assert_allclose(t2n(out_patch[key]), np.asarray(out_j[key]), atol=TOL)
    for key in ("pred_logits", "pred_boxes"):
        np.testing.assert_allclose(
            t2n(out_patch["enc_outputs"][key]), t2n(out_lanes["enc_outputs"][key]), atol=1e-5
        )


def test_enc_msda_q_chunk_reaches_the_encoder_layers_only(pair, feats, outputs):
    import dataclasses

    from tair_tpu_torch.spotter.testr import TESTR

    _, _, tm = pair
    cfg = dataclasses.replace(tm.testr.cfg, enc_msda_q_chunk=7)
    chunked = TESTR(cfg)
    chunked.load_state_dict(tm.testr.state_dict(), strict=True)
    tr = chunked.transformer
    assert tr.enc_0.self_attn.q_chunk == 7 and tr.dec_0.attn_cross.q_chunk == 16384
    assert tm.testr.transformer.enc_0.self_attn.q_chunk == 16384
    with torch.no_grad():
        out = chunked.eval()(tuple(torch.from_numpy(f) for f in feats))
    # S = 148 tokens in blocks of 7: the same sums, block by block
    for key in ("pred_logits", "pred_ctrl_points", "pred_texts"):
        np.testing.assert_allclose(t2n(out[key]), t2n(outputs[1][key]), atol=1e-5)


def test_spotter_inference_decode(outputs):
    out_j, out_t = outputs
    res_j = jax_inference(out_j, 0.5, image_size=64)
    res_t = spotter_inference(out_t, 0.5, image_size=64)
    for key in ("scores", "polygons", "rec_scores"):
        np.testing.assert_allclose(t2n(res_t[key]), np.asarray(res_j[key]), atol=64 * TOL)
    # discrete outputs: equal wherever the JAX decision is not a near-tie
    scores = np.asarray(res_j["scores"])
    clear = np.abs(scores - 0.5) > 1e-3
    np.testing.assert_array_equal(
        res_t["keep"].numpy()[clear], np.asarray(res_j["keep"])[clear]
    )
    top2 = np.sort(np.asarray(res_j["rec_scores"]), axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-3
    np.testing.assert_array_equal(
        res_t["recs"].numpy()[clear], np.asarray(res_j["recs"])[clear]
    )


def test_static_embeddings_and_grids_match_jax():
    from tair_tpu.spotter import transformer as jt
    from tair_tpu_torch.spotter import transformer as tt

    shapes = ((2, 2), (4, 4), (8, 8), (8, 8))
    np.testing.assert_array_equal(
        tt.encoder_reference_points(shapes), jt.encoder_reference_points(shapes)
    )
    for a, b in zip(tt.proposal_grid(shapes), jt.proposal_grid(shapes)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tt.sine_pos_embed_2d(4, 6, 16), jt.sine_pos_embed_2d(4, 6, 16))
    np.testing.assert_array_equal(tt.sine_pos_embed_1d(25, 32), jt.sine_pos_embed_1d(25, 32))
    boxes = np.random.default_rng(33).standard_normal((2, 5, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tt.proposal_pos_embed(torch.from_numpy(boxes)).numpy(),
        np.asarray(jt.proposal_pos_embed(boxes)), atol=1e-5,
    )


def test_charset_copy_matches_jax():
    from tair_tpu.spotter import charset as jc
    from tair_tpu_torch.spotter import charset as tc

    assert tc.CTLABELS == jc.CTLABELS and tc.PAD_ID == jc.PAD_ID
    assert tc.VOC_SIZE == jc.VOC_SIZE and tc.MAX_WORD_LEN == jc.MAX_WORD_LEN
    np.testing.assert_array_equal(tc.encode_text("Stop!"), jc.encode_text("Stop!"))
    assert tc.decode_text(tc.encode_text("Stop!")) == "Stop!"
