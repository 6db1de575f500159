"""The port's readers of the released PyTorch checkpoints
(``tair_tpu_torch/weights/convert.py``), its exporters (``weights/export.py``)
and ``python -m tair_tpu_torch.convert_weights`` against the JAX package's, on
the CPU at the tiny geometry.

Every checkpoint is built from seeded parameters (``tiny_pair``'s noise), under
the reference's names: by the JAX exporters where the JAX package has one, and
for the ControlNet, BSRNet and SCUNet (which it has none for) by the port's
exporters, which the JAX converters read back to the seeded tree. The same
dict goes through the JAX converter and the port's: every leaf equal, and the
same ``missing`` and ``unused()`` keys. Each file also carries a tensor that no table reads, so
``unused()`` is not empty. No checkpoint is downloaded.
"""

import pickle
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tair_tpu.models import cleaners as jax_cleaners
from tair_tpu.weights import convert as jc
from tair_tpu.weights import export as jx
from tair_tpu_torch.models import cleaners as torch_cleaners
from tair_tpu_torch.weights import convert as tc
from tair_tpu_torch.weights import export as tx
from test_torch_common import jax_shapes, noise_params, tiny_pair, torch_single_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
BUNDLE = ("unet", "controlnet", "vae", "clip", "swinir", "testr")
RRDB_TINY = dict(nf=8, nb=2, gc=4, sf=4)
SCUNET_TINY = dict(dim=16, config=(1, 1, 1, 1, 1, 1, 1), head_dim=8)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=151)


def _cleaner_params(name: str):
    if name == "bsrnet":
        jmod = jax_cleaners.RRDBNet(jax_cleaners.RRDBNetConfig(**RRDB_TINY))
        seed = 152
    else:
        jmod = jax_cleaners.SCUNet(jax_cleaners.SCUNetConfig(**SCUNET_TINY))
        seed = 153
    return noise_params(jax_shapes(jmod.init, jnp.zeros((1, 64, 64, 3)))["params"], seed)


@pytest.fixture(scope="module")
def cleaners():
    return {name: _cleaner_params(name) for name in ("bsrnet", "scunet")}


# ---- the cases --------------------------------------------------------------

def _cfgs(jm, tm, part):
    """(the JAX config, the port's config) of a part."""
    if part == "bsrnet":
        return (jax_cleaners.RRDBNetConfig(**RRDB_TINY), torch_cleaners.RRDBNetConfig(**RRDB_TINY))
    if part == "scunet":
        return (jax_cleaners.SCUNetConfig(**SCUNET_TINY),
                torch_cleaners.SCUNetConfig(**SCUNET_TINY))
    holder_j = jm if part in ("swinir", "testr") else jm.cldm
    holder_t = tm if part in ("swinir", "testr") else tm.cldm
    return getattr(holder_j, part).cfg, getattr(holder_t, part).cfg


# part -> (the exporter that builds its file: JAX's where there is one, JAX
# converter, port converter, the file's prefix, a tensor no table reads)
CASES = {
    "unet": (jx.export_unet, jc.convert_unet, tc.convert_unet, "", "label_emb.0.0.weight"),
    "controlnet": (tx.export_controlnet, jc.convert_controlnet, tc.convert_controlnet, "",
                   "input_hint_block.0.weight"),
    "vae": (jx.export_vae, jc.convert_vae, tc.convert_vae, "", "loss.logvar"),
    "clip": (jx.export_clip, jc.convert_clip, tc.convert_clip, "", "text_projection"),
    "swinir": (jx.export_swinir, jc.convert_swinir, tc.convert_swinir, "module.",
               "module.conv_first.0.weight"),
    "bsrnet": (tx.export_bsrnet, jc.convert_bsrnet, tc.convert_bsrnet, "module.",
               "module.upconv3.weight"),
    "scunet": (tx.export_scunet, jc.convert_scunet, tc.convert_scunet, "", "m_extra.weight"),
    "testr": (jx.export_testr, jc.convert_testr, tc.convert_testr, "",
              "testr.backbone.0.body.conv1.weight"),
}


def reference_dict(pair, cleaners, part):
    """The reference-layout checkpoint of `part`, as the released file names it."""
    jm, params, tm = pair
    tree = cleaners[part] if part in cleaners else params[part]
    export, _, _, prefix, extra = CASES[part]
    sd = {prefix + k: v for k, v in export(tree, _cfgs(jm, tm, part)[0]).items()}
    if part == "clip":  # the block after the penultimate one, which the tower skips
        last = _cfgs(jm, tm, part)[0].layers - 1
        sd.update({k.replace(".0.", f".{last}.", 1): v for k, v in sd.items()
                   if k.startswith("transformer.resblocks.0.")})
    sd[extra] = np.ones((3,), np.float32)
    return sd


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def assert_trees_equal(got, want):
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("part", list(CASES))
def test_converter_matches_jax(pair, cleaners, part):
    """The same checkpoint through the JAX converter and the port's: the same
    tree leaf for leaf (which is the seeded tree it was exported from), the
    same used, missing and unused keys; and without one of its tensors both
    raise for that name."""
    jm, params, tm = pair
    sd = reference_dict(pair, cleaners, part)
    cfg_j, cfg_t = _cfgs(jm, tm, part)
    _, jax_convert, port_convert, _, extra = CASES[part]
    want, r_j = jax_convert(sd, cfg_j)
    got, r_t = port_convert(sd, cfg_t)
    assert_trees_equal(got, want)
    assert_trees_equal(got, cleaners[part] if part in cleaners else params[part])
    assert (r_t.used, r_t.missing, r_t.unused()) == (r_j.used, r_j.missing, r_j.unused())
    assert extra.removeprefix("module.") in r_t.unused()  # read with the prefix stripped

    first = sorted(r_t.used)[0]  # read under this name (``module.`` stripped)
    short = {k: v for k, v in sd.items() if k not in (first, "module." + first)}
    with pytest.raises(KeyError) as raised_j:
        jax_convert(short, cfg_j)
    with pytest.raises(KeyError) as raised_t:
        port_convert(short, cfg_t)
    assert raised_t.value.args == raised_j.value.args


@pytest.mark.parametrize("part", list(CASES))
def test_exporter_matches_jax(pair, cleaners, part):
    """The port's exporters write what the JAX exporters write; for the
    ControlNet, BSRNet and SCUNet, which JAX has no exporter for, a dict that
    the JAX converter reads whole (nothing missing, nothing unused) and turns
    back into the tree exported."""
    jm, params, tm = pair
    cfg_j, cfg_t = _cfgs(jm, tm, part)
    tree = cleaners[part] if part in cleaners else params[part]
    got = getattr(tx, f"export_{part}")(tree, cfg_t)
    if hasattr(jx, f"export_{part}"):
        want = getattr(jx, f"export_{part}")(tree, cfg_j)
        assert list(got) == list(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        return
    back, r_j = CASES[part][1](got, cfg_j)
    assert (r_j.missing, r_j.unused(), r_j.used) == (set(), set(), set(got))
    assert_trees_equal(back, tree)


def test_sd_bundle_matches_jax(pair):
    """``load_pretrained_sd_bundle``: the SD-2.1 bundle's three prefixes into
    an init tree; the other parts of the tree are left as they were."""
    jm, params, tm = pair
    sd = {}
    for part, prefix in tc.SD_BUNDLE_PREFIX.items():
        sd.update(getattr(jx, f"export_{part}")(params[part], _cfgs(jm, tm, part)[0], prefix))
    sd["model_ema.decay"] = np.float32(0.9999)
    sd["cond_stage_model.model.text_projection"] = np.ones((4, 4), np.float32)
    init = noise_params(jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), params), 154)
    want = jc.load_pretrained_sd_bundle(init, sd, jm)
    got = tc.load_pretrained_sd_bundle(init, sd, tm)
    assert_trees_equal(got, jax.tree.map(np.asarray, want))
    for part in ("unet", "vae", "clip"):
        assert_trees_equal(got[part], params[part])
    for part in ("controlnet", "swinir", "testr"):
        assert got[part] is init[part]


def test_controlnet_from_unet_matches_jax_and_zero_pads_the_hint(pair):
    jm, params, tm = pair
    want = jc.controlnet_from_unet(params["unet"], params["controlnet"])
    got = tc.controlnet_from_unet(params["unet"], params["controlnet"])
    assert_trees_equal(got, jax.tree.map(np.asarray, want))
    kernel, unet_kernel = got["in_conv"]["kernel"], params["unet"]["in_conv"]["kernel"]
    n_in = unet_kernel.shape[2]  # [kh, kw, in, out]: the latent's channels, then the hint's
    assert kernel.shape[2] == n_in + jm.cldm.controlnet.cfg.hint_channels
    np.testing.assert_array_equal(kernel[:, :, :n_in], unet_kernel)
    assert not kernel[:, :, n_in:].any()
    zero = [k for k in got if k.startswith("zero_")] + ["middle_out"]
    assert len(zero) == 13
    for k in zero:  # the zero convolutions keep the ControlNet's values
        assert got[k]["kernel"] is params["controlnet"][k]["kernel"]
    np.testing.assert_array_equal(got["middle"]["res1"]["in_conv"]["kernel"],
                                  params["unet"]["middle"]["res1"]["in_conv"]["kernel"])


@pytest.fixture(scope="module")
def converted_model(pair, cleaners):
    """The port's tiny model built from the reference-layout dicts alone,
    through the port's converters and ``from_jax_params`` with strict=True,
    and the cleaners from theirs through ``convert_tree``."""
    from tair_tpu_torch.pipeline import build_tiny_model

    jm, _, tm = pair
    trees = {part: CASES[part][2](reference_dict(pair, cleaners, part), _cfgs(jm, tm, part)[1])[0]
             for part in BUNDLE}
    model = build_tiny_model(device="cpu")
    model.load_state_dict(tc.from_jax_params(trees), strict=True)
    mods = {}
    for part, cls, kw in (("bsrnet", torch_cleaners.RRDBNet, RRDB_TINY),
                          ("scunet", torch_cleaners.SCUNet, SCUNET_TINY)):
        cfg = getattr(torch_cleaners, f"{cls.__name__}Config")(**kw)
        tree = CASES[part][2](reference_dict(pair, cleaners, part), cfg)[0]
        loaded, seeded = cls(cfg), cls(cfg)
        loaded.load_state_dict(tc.convert_tree(tree), strict=True)
        seeded.load_state_dict(tc.convert_tree(cleaners[part]), strict=True)
        mods[part] = (loaded.eval(), seeded.eval())
    return model.eval(), mods


def _forward(model, part, rng):
    x = torch.from_numpy(rng.standard_normal((1, 8, 8, 4), dtype=np.float32))
    t = torch.tensor([321], dtype=torch.int32)
    ctx = torch.from_numpy(rng.standard_normal((1, 77, 64), dtype=np.float32))
    img = torch.from_numpy(rng.random((1, 64, 64, 3), dtype=np.float32))
    if part == "unet":
        return model.cldm.unet(x, t, ctx)
    if part == "controlnet":
        return torch.cat([c.flatten() for c in model.cldm.controlnet(x, x, t, ctx)])
    if part == "vae":
        return model.cldm.vae_decode(model.cldm.vae_encode(img * 2 - 1, sample=False))
    if part == "clip":
        return model.cldm.clip_encode_tokens(torch.from_numpy(rng.integers(0, 1000, (1, 77))))
    if part == "swinir":
        return model.swinir(img)
    feats = [torch.from_numpy(rng.standard_normal((1, s, s, c), dtype=np.float32))
             for s, c in ((2, 128), (4, 128), (8, 64), (8, 32))]
    out = model.spotter_apply(feats)
    return torch.cat([out[k].flatten() for k in ("pred_logits", "pred_ctrl_points", "pred_texts")])


@pytest.mark.parametrize("part", list(BUNDLE) + ["bsrnet", "scunet"])
def test_converted_weights_forward_as_the_seeded_model(pair, converted_model, part):
    """The model read from the checkpoints computes what ``tiny_pair``'s
    model, fed the same seeded parameters, computes: bit for bit."""
    _, _, tm = pair
    model, cleaner_mods = converted_model
    with torch.no_grad():
        if part in cleaner_mods:
            loaded, seeded = cleaner_mods[part]
            img = torch.from_numpy(np.random.default_rng(155).random((1, 32, 32, 3), dtype=np.float32))
            got, want = loaded(img), seeded(img)
        else:
            got = _forward(model, part, np.random.default_rng(155))
            want = _forward(tm, part, np.random.default_rng(155))
    assert torch.equal(got, want)


# ---- files ------------------------------------------------------------------

def _tensors(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def _write(path: Path, sd, layout: str) -> None:
    """`sd` written as a released checkpoint of kind `layout`."""
    if layout == "lightning":  # a Lightning .ckpt: the weights under state_dict
        torch.save({"state_dict": _tensors(sd), "global_step": 7, "epoch": 1}, path)
    elif layout == "model":  # torch.save({"model": ...})
        torch.save({"model": _tensors(sd), "optimizer": {}}, path)
    elif layout == "detectron2":  # AdetCheckpointer: numpy arrays under model
        with open(path, "wb") as f:
            pickle.dump({"model": dict(sd), "__author__": "test"}, f)
    else:
        torch.save(_tensors(sd), path)


@pytest.mark.parametrize("suffix,layout", [(".ckpt", "lightning"), (".pth", "model"),
                                           (".pkl", "detectron2"), (".pt", "plain")])
def test_load_torch_file_matches_jax(tmp_path, suffix, layout):
    rng = np.random.default_rng(156)
    sd = {"a.weight": rng.standard_normal((3, 2), dtype=np.float32),
          "b.bias": rng.standard_normal((4,), dtype=np.float32),
          "model.c": rng.standard_normal((2,), dtype=np.float32)}
    path = tmp_path / f"ck{suffix}"
    _write(path, sd, layout)
    want, got = jc.load_torch_file(str(path)), tc.load_torch_file(str(path))
    assert sorted(got) == sorted(want) == sorted(sd)
    for k in sd:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], sd[k])


def test_load_torch_file_reads_bfloat16_as_float32(tmp_path):
    """A bfloat16 tensor in a PyTorch checkpoint: the JAX package's reader
    fails on it (``Tensor.numpy()`` has no bfloat16), the port's reads it as
    float32, exactly; `_cast_like` then gives the init's dtype."""
    w = torch.randn(5, 3, generator=torch.Generator().manual_seed(157)).to(torch.bfloat16)
    path = tmp_path / "bf16.pth"
    torch.save({"w": w, "b": torch.zeros(3)}, path)
    with pytest.raises(TypeError, match="BFloat16"):
        jc.load_torch_file(str(path))
    got = tc.load_torch_file(str(path))
    assert got["w"].dtype == np.float32
    np.testing.assert_array_equal(got["w"], w.float().numpy())
    cast = tc._cast_like({"w": got["w"]}, {"w": np.zeros((5, 3), np.float16)})
    assert cast["w"].dtype == np.float16


def test_cast_like_keeps_init_checks_shape_and_follows_init_dtype():
    like = {"a": {"kernel": np.zeros((2, 3), np.float32), "bias": np.ones((3,), np.float32)},
            "b": np.full((4,), 2.0, np.float16)}
    src = {"a": {"kernel": np.arange(6, dtype=np.float64).reshape(2, 3)},
           "b": np.arange(4, dtype=np.float32), "extra": np.zeros(1)}
    want = jc._cast_like(src, like)
    got = tc._cast_like(src, like)
    assert_trees_equal(got, jax.tree.map(np.asarray, want))
    assert got["a"]["bias"] is like["a"]["bias"]  # missing from src: the init
    assert got["a"]["kernel"].dtype == np.float32 and got["b"].dtype == np.float16
    bad = {"a": {"kernel": np.zeros((3, 2), np.float32)}}
    with pytest.raises(AssertionError):
        jc._cast_like(bad, like)
    with pytest.raises(ValueError, match="a/kernel"):
        tc._cast_like(bad, like)


# ---- python -m tair_tpu_torch.convert_weights --------------------------------

def _tiny_tool(monkeypatch):
    """The entry point with the tiny model and tiny cleaners substituted for
    the full-width ones, as the serving tests substitute the tiny preset."""
    from tair_tpu_torch import pipeline

    monkeypatch.setattr(pipeline, "build_default_model",
                        lambda dtype, device: pipeline.build_tiny_model(dtype=dtype, device=device))
    monkeypatch.setattr(torch_cleaners, "RRDBNetConfig",
                        partial(torch_cleaners.RRDBNetConfig, **RRDB_TINY))
    monkeypatch.setattr(torch_cleaners, "SCUNetConfig",
                        partial(torch_cleaners.SCUNetConfig, **SCUNET_TINY))


@pytest.mark.parametrize("controlnet", ["file", "from_unet"])
def test_convert_weights_entry_point(tmp_path, monkeypatch, capsys, pair, cleaners, controlnet):
    """The tool on the reference files: the npz keys and values are the
    converted trees bit for bit; what no file gave (SwinIR in the second
    case) keeps the port's init from seed 0; the cleaners' npz files hold
    their converted trees; the bundle loads with ``val --ckpt``."""
    from tair_tpu_torch.config import load_config
    from tair_tpu_torch.convert_weights import main
    from tair_tpu_torch.pipeline import build_tiny_model
    from tair_tpu_torch.train.checkpoint import flat_items
    from tair_tpu_torch.val import load_model

    jm, params, tm = pair
    _tiny_tool(monkeypatch)
    sd = {}
    for part, prefix in tc.SD_BUNDLE_PREFIX.items():
        sd.update(getattr(tx, f"export_{part}")(params[part], _cfgs(jm, tm, part)[1], prefix))
    files = {"sd": tmp_path / "sd21.ckpt", "testr": tmp_path / "testr.pkl",
             "bsrnet": tmp_path / "bsrnet.pth", "scunet": tmp_path / "scunet.pth"}
    _write(files["sd"], sd, "lightning")
    _write(files["testr"], reference_dict(pair, cleaners, "testr"), "detectron2")
    _write(files["bsrnet"], reference_dict(pair, cleaners, "bsrnet"), "plain")
    _write(files["scunet"], reference_dict(pair, cleaners, "scunet"), "plain")
    if controlnet == "file":
        files["controlnet"] = tmp_path / "controlnet.pt"
        files["swinir"] = tmp_path / "swinir.pth"
        _write(files["controlnet"], reference_dict(pair, cleaners, "controlnet"), "plain")
        _write(files["swinir"], reference_dict(pair, cleaners, "swinir"), "plain")
    out = tmp_path / "tair.npz"
    argv = ["--out", str(out), *(a for k, p in files.items() for a in (f"--{k}", str(p)))]
    main(argv + ["--device", "cpu"] + (["--controlnet-from-unet"] if controlnet == "from_unet" else []))

    printed = capsys.readouterr().out.splitlines()
    assert f"loaded SD bundle from {files['sd']}" in printed
    assert f"loaded TESTR from {files['testr']} (missing=0)" in printed
    assert f"wrote {tmp_path / 'tair_bsrnet.npz'} (missing=0)" in printed
    assert printed[-1] == f"wrote {out}"
    init_model = build_tiny_model(device="cpu").init_parameters(torch.Generator().manual_seed(0))
    init = tc.to_jax_params(init_model.state_dict(), tc.jax_param_shapes(init_model))
    want = {part: params[part] for part in ("unet", "vae", "clip", "testr")}
    if controlnet == "file":
        assert f"loaded ControlNet from {files['controlnet']} (missing=0, unused=1)" in printed
        want.update(controlnet=params["controlnet"], swinir=params["swinir"])
    else:
        assert "initialized ControlNet from UNet weights (hint channels zeroed)" in printed
        want.update(controlnet=jax.tree.map(np.asarray, jc.controlnet_from_unet(
            params["unet"], init["controlnet"])), swinir=init["swinir"])
    with np.load(out) as data:
        stored = {k: data[k] for k in data.files}
    expected = dict(flat_items(want))
    assert sorted(stored) == sorted(expected)
    for key, value in expected.items():
        assert stored[key].dtype == np.float32, key
        np.testing.assert_array_equal(stored[key], value, err_msg=key)
    for name in ("bsrnet", "scunet"):
        with np.load(tmp_path / f"tair_{name}.npz") as data:
            assert sorted(data.files) == sorted(dict(flat_items(cleaners[name])))
            for key, value in flat_items(cleaners[name]):
                np.testing.assert_array_equal(data[key], value, err_msg=key)

    config = (ROOT / "configs" / "val_smoke.yaml").read_text()
    (tmp_path / "val.yaml").write_text(config)
    served = load_model(load_config(str(tmp_path / "val.yaml")), torch.device("cpu"), str(out))
    state = served.state_dict()
    for name, value in tc.from_jax_params(want).items():
        assert torch.equal(state[name], value), name


def test_convert_weights_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    """Without ``--device cpu`` the tool draws its parameters on the CUDA
    device, and raises where there is none, before it reads any file."""
    from tair_tpu_torch.convert_weights import _parser, main

    assert _parser().parse_args(["--out", "w.npz"]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        main(["--out", str(tmp_path / "w.npz"), "--sd", str(tmp_path / "absent.ckpt")])
    assert not (tmp_path / "w.npz").exists()
