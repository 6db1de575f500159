"""Tensor- and sequence-parallel serving and training of the port
(``parallel/tp.py``, ``TESTRConfig.enc_sp_axis``, ``parallel/fsdp.py`` on a
2-D mesh) on four gloo ranks, against one process and against the JAX
package, float32 on the CPU.

One group of four spawned processes (``torch_tp_worker.py``) on a 2 x 2
("data", "model") mesh runs every multi-rank case once for the module, its
serving cases on a data row's two model ranks (w8a8's dynamic and static
cases on ranks 2 and 3, the others on ranks 0 and 1), while this process
computes the references:

- the placement rule equals JAX's ``tensor_parallel_specs`` and
  ``count_sharded`` leaf for leaf on the tiny bundle's shapes at n_model 1, 2
  and 4 and on the full-width model's (built on the meta device), on the
  torch axis that holds the JAX axis; indivisible shapes stay replicated; the
  JAX test's hand-made tree gives the same specs (no process group needed);
- the tiny restore under TP and under TP + SP equals the one-process restore
  at the same seed (the JAX TP test's bound: atol 2e-4, rtol 1e-3; tokens
  equal with ``score_threshold`` above 1), the same on both model ranks;
  ``tests/test_torch_pipeline.py`` holds that one-process restore against JAX;
- the tiny restore in a quantized scope with the UNet's and the ControlNet's
  dense layers cut (dynamic, static after a calibration under TP, selective)
  equals the one-process w8a8 restore bit for bit, and so does the
  calibration record;
- attention whose shard boundary falls inside a head (gathered) and on a
  head boundary (local heads) equals the unsharded block;
- one ``EncoderLayer`` under SP, dense and sparse, on an even and an uneven
  token count, equals JAX's unconstrained layer (atol 2e-5, the JAX SP test's);
- two stage-3 steps DP x TP x SP and two FSDP x TP on the 2 x 2 mesh equal
  the one-process global-batch step of ``torch_parallel_worker.py`` (which
  ``test_torch_train_step.py`` holds to the JAX step) with the bounds of
  ``test_torch_data_parallel.py``: losses at rtol 2e-4 (the JAX DP x TP
  test's), every trained leaf's gradient of the first step and its value
  after the second within 1e-5 wherever the gradient stands clear of float32
  noise, frozen leaves bit-equal;
- the FSDP x TP checkpoint loads bit for bit into one process, and a
  one-process checkpoint resumes on the 2 x 2 mesh and gathers back to
  itself.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as pw
import torch_tp_worker as w
from tair_tpu.parallel import tp as jtp
from tair_tpu.spotter.transformer import EncoderLayer as JaxEncoderLayer
from tair_tpu.spotter.transformer import encoder_reference_points
from tair_tpu_torch.parallel import tp
from tair_tpu_torch.spotter.transformer import EncoderLayer
from tair_tpu_torch.weights.convert import module_param_shapes
from test_torch_common import noise_params, tiny_bundle_shapes, torch_single_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
WORLD, N_MODEL = 4, 2  # a 2 x 2 mesh
SERVING = slice(0, 2)  # data row 0's ranks (row 1's run w8a8's dynamic and static cases)
# the geometries of the SP layer: the JAX SP test's 40 tokens, and 19 (uneven over 2)
ENCODER_SHAPES = {"even": ((2, 4), (4, 8)), "uneven": ((3, 3), (2, 5))}


def _encoder_cases():
    """{name: layer parameters (JAX layout, seeded noise), inputs, selected
    tokens} for each geometry."""
    shapes_tree = module_param_shapes(EncoderLayer(16, 32, 2, 4, 2))
    cases = {}
    for i, (name, shapes) in enumerate(ENCODER_SHAPES.items()):
        s = sum(h * w_ for h, w_ in shapes)
        rng = np.random.default_rng(190 + i)
        ref = np.broadcast_to(encoder_reference_points(shapes)[None], (2, s, 2, 2))
        cases[name] = dict(
            params=noise_params(shapes_tree, 191 + i), shapes=shapes,
            src=rng.standard_normal((2, s, 16), dtype=np.float32),
            pos=rng.standard_normal((2, s, 16), dtype=np.float32),
            ref=np.ascontiguousarray(ref, np.float32),
            sel=np.sort(np.stack([rng.choice(s, s // 2 + 1, replace=False) for _ in range(2)]), 1),
        )
    return cases


def _jax_encoder(case):
    layer = JaxEncoderLayer(d_model=16, d_ffn=32, n_levels=2, n_heads=4, n_points=2)
    shapes = case["shapes"]

    @jax.jit
    def run(p, src, pos, ref, sel):
        variables = {"params": p}
        return (layer.apply(variables, src, pos, ref, shapes),
                layer.apply(variables, src, pos, ref, shapes, sel))

    dense, sparse = run(case["params"], *(jnp.asarray(case[k]) for k in ("src", "pos", "ref", "sel")))
    return dict(dense=np.asarray(dense), sparse=np.asarray(sparse))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results, the one-process references)."""
    from tair_tpu_torch.models.attention import SpatialTransformer

    out = tmp_path_factory.mktemp("tp_ranks")
    cases = _encoder_cases()
    torch.save(cases, out / "encoder_cases.pt")
    blocks = {}
    for heads in (4, 5):
        torch.manual_seed(heads)
        blocks[heads] = SpatialTransformer(40, heads, 40 // heads, 16).eval()
        with torch.no_grad():
            for p in blocks[heads].parameters():
                p.add_(0.1 * torch.randn(p.shape))
        torch.save(blocks[heads].state_dict(), out / f"attention_{heads}.pt")
    gen = torch.Generator().manual_seed(192)
    x = dict(x=torch.randn((1, 40, 3, 5), generator=gen),
             context=torch.randn((1, 7, 16), generator=gen))
    torch.save(x, out / "attention_input.pt")

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests")]),
               OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_tp_worker.py"), str(r), str(WORLD),
             str(out / "store"), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r in range(WORLD)
    ]
    try:
        from tair_tpu_torch.train.checkpoint import save_checkpoint

        # first the one-process checkpoint, which the ranks resume when they get to it
        grads = {}
        aux, state, (model_sd, _), least = pw.run_steps(pw.tiny_model(), grads=grads)
        save_checkpoint(str(out / "one"), state, pw.STEPS)
        del state
        ref = dict(steps=(aux, model_sd, least, grads), w8a8=w.w8a8_restores())
        with torch.no_grad():
            ref.update(
                restore=w.restore(w.tiny_model()),
                attention={h: blocks[h](x["x"], x["context"]) for h in (4, 5)},
                jax_encoder={name: _jax_encoder(case) for name, case in cases.items()},
            )
        logs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err[-4000:]
    ranks = [torch.load(out / f"tp_rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return ranks, ref, out


def _jax_specs(tree, n_model):
    specs = {}
    jax.tree_util.tree_map_with_path(
        lambda kp, spec: specs.update({"/".join(k.key for k in kp): tuple(spec)}),
        jtp.tensor_parallel_specs(tree, n_model),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec),
    )
    return specs


def _placement_equals_jax(model, tree, n_model):
    from tair_tpu_torch.parallel.fsdp import jax_leaf_shapes
    from tair_tpu_torch.weights.convert import torch_axes

    want = _jax_specs(tree, n_model)
    leaves = jax_leaf_shapes(model)
    assert len(leaves) == len(want)
    got = tp.tensor_parallel_specs({p: s for p, s in leaves.values()}, n_model)
    assert got == want
    dims = tp.shard_dims(model, n_model)
    n_sharded = 0
    for name, (path, shape) in leaves.items():
        if "model" in want[path]:
            axis = torch_axes(tuple(path.split("/")), len(shape))[want[path].index("model")]
            assert dims[name] == axis, name
            assert model.get_parameter(name).shape[axis] % n_model == 0, name
            n_sharded += 1
        else:
            assert dims[name] is None, name
    itemsize = {p: (s, 4) for p, s in leaves.values()}
    assert tp.count_sharded(itemsize, n_model) == jtp.count_sharded(tree, n_model)
    return n_sharded


@pytest.fixture(scope="module")
def tiny_and_tree():
    from tair_tpu_torch.pipeline import build_tiny_model

    tree = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32),
                        tiny_bundle_shapes())
    return build_tiny_model(device="cpu"), tree


@pytest.fixture(scope="module")
def full_width_and_tree():
    """The full-width bundle on the meta device (shapes only) and its JAX tree."""
    from tair_tpu_torch.pipeline import build_default_model
    from tair_tpu_torch.weights.convert import jax_param_shapes

    with torch.device("meta"):
        model = build_default_model(dtype=torch.float32, device="meta")
    tree = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32),
                        jax_param_shapes(model))
    return model, tree


@pytest.mark.parametrize("n_model", [1, 2, 4])
def test_placement_equals_jax_leaf_for_leaf_tiny(tiny_and_tree, n_model):
    assert _placement_equals_jax(*tiny_and_tree, n_model) > 0


@pytest.mark.parametrize("n_model", [2, 4])
def test_placement_equals_jax_leaf_for_leaf_full_width(full_width_and_tree, n_model):
    assert _placement_equals_jax(*full_width_and_tree, n_model) > 500


def test_spec_rules_and_indivisible_shapes():
    """The JAX tests' hand-made trees through both rule tables."""
    shapes = {
        "unet/attn1/to_q/kernel": (64, 64), "unet/ff/geglu/proj/kernel": (64, 512),
        "unet/ff/out/kernel": (256, 64), "unet/ff/out/bias": (64,),
        "unet/res/in_conv/kernel": (3, 3, 64, 64), "unet/norm1/scale": (64,),
        "clip/attn/query/kernel": (64, 4, 16), "clip/attn/out/kernel": (4, 16, 64),
        "a/to_q/kernel": (8, 6),
    }
    for n_model in (2, 4):
        got = tp.tensor_parallel_specs(shapes, n_model)
        for path, shape in shapes.items():
            assert got[path] == tuple(jtp._spec_for(path, shape, n_model)), (path, n_model)
    specs = tp.tensor_parallel_specs(shapes, 2)
    assert specs["unet/ff/out/kernel"] == ("model", None)
    assert specs["clip/attn/query/kernel"] == (None, "model", None)
    assert specs["unet/res/in_conv/kernel"] == specs["unet/ff/out/bias"] == ()
    assert tp.tensor_parallel_specs(shapes, 4)["a/to_q/kernel"] == ()  # 6 % 4 != 0
    n, sz, tot = tp.count_sharded({p: (s, 4) for p, s in shapes.items()}, 2)
    assert n == 6 and 0 < sz < tot  # the JAX test's 5, and a/to_q


@pytest.mark.parametrize("mode", ["tp", "tp_sp"])
def test_tiny_restore_equals_one_process(runs, mode):
    ranks, ref, _ = runs
    want = ref["restore"]
    assert ranks[0]["n_model"] == N_MODEL and ranks[0]["sharded_layers"] > 100
    for r in ranks[SERVING]:
        got = r[mode]
        np.testing.assert_allclose(got["image"].numpy(), want["image"].numpy(),
                                   atol=2e-4, rtol=1e-3)
        assert torch.equal(got["tokens"], want["tokens"])
        np.testing.assert_allclose(got["scores"].numpy(), want["scores"].numpy(), atol=1e-4)
    assert torch.equal(ranks[0][mode]["image"], ranks[1][mode]["image"])


@pytest.mark.parametrize("heads", [4, 5])
def test_attention_split_inside_and_on_head_boundaries(runs, heads):
    """5 heads of 8 over two ranks cut head 3: q, k and v are gathered and
    every head runs on each rank; 4 heads of 10 split on a boundary: each
    rank runs its 2 heads."""
    ranks, ref, _ = runs
    for r in ranks[SERVING]:
        out, local_heads = r["attention"][heads]
        assert local_heads == (5 if heads == 5 else 2)
        np.testing.assert_allclose(out.numpy(), ref["attention"][heads].numpy(), atol=1e-5)


def test_unet_attention_runs_local_heads(runs):
    ranks, _, _ = runs
    # the tiny UNet's levels have 2, 4 and 8 heads of 16: each rank runs half
    assert ranks[0]["local_heads"] == [1, 2, 4]


@pytest.mark.parametrize("geometry", list(ENCODER_SHAPES))
@pytest.mark.parametrize("branch", ["dense", "sparse"])
def test_sequence_parallel_encoder_layer_equals_jax(runs, geometry, branch):
    ranks, ref, _ = runs
    want = ref["jax_encoder"][geometry][branch]
    for r in ranks[SERVING]:
        got = r["encoder"][geometry][branch].numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("scope", ["dynamic", "static", "selective"])
def test_w8a8_under_tensor_parallelism_equals_one_process(runs, scope):
    """Every quantized dense site of the UNet and the ControlNet cut over two
    model ranks: the restore equals one process's w8a8 restore bit for bit
    (the row-parallel sites take the axis' scales and sum their int32
    products before the rescale), and so does the calibration record (the
    axis' maximum at every site)."""
    ranks, ref, _ = runs
    want = ref["w8a8"][scope]
    holders = [r["w8a8"] for r in ranks if scope in r["w8a8"]]
    assert len(holders) == N_MODEL  # one data row's model ranks
    for got in holders:
        if scope == "static":
            assert got["record"] == ref["w8a8"]["record"]
        for key, value in want.items():
            assert torch.equal(got[scope][key], value), (scope, key)
    assert not torch.equal(ref["w8a8"][scope]["image"], ref["restore"]["image"])
    if scope == "selective":  # the gate skips some sites
        assert not torch.equal(want["image"], ref["w8a8"]["dynamic"]["image"])


def _gradient_err(got, want, least):
    """Largest |got - want| where the gradient stands clear of float32 noise."""
    solid = least.numpy() >= 1e-6
    err = np.abs(got.numpy() - want.numpy())
    return float(err[solid].max()) if solid.any() else 0.0


@pytest.mark.parametrize("mode", ["dp_tp_sp", "fsdp_tp"])
def test_tp_steps_equal_the_one_process_global_batch_step(runs, mode):
    ranks, ref, _ = runs
    want_aux, want_sd, least, want_grads = ref["steps"]
    assert ranks[0][mode]["aux"] == ranks[1][mode]["aux"] == ranks[3][mode]["aux"]
    for got, want in zip(ranks[0][mode]["aux"], want_aux):
        assert set(got) == set(want) and "loss_ocr_texts" in got
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=2e-4, err_msg=key)
    for r in ranks:  # frozen leaves bit-equal on every rank
        assert r[mode]["frozen_changed"] == []
    for r in ranks[:2]:  # both model ranks
        got = r[mode]
        assert set(got["grads"]) == set(want_grads) == set(least) == set(got["trained"])
        for name, g in want_grads.items():
            assert got["grads"][name].shape == g.shape, name
            assert _gradient_err(got["grads"][name], g, least[name]) <= 1e-5, name
            err = np.abs(got["trained"][name].numpy() - want_sd[name].detach().numpy())
            solid = least[name].numpy() >= 1e-6
            assert (err[solid] <= 1e-5).all(), (name, err[solid].max())
            assert (err <= 2.1 * pw.LR * pw.STEPS).all(), (name, err.max())


def test_tp_checkpoint_loads_bit_for_bit_into_one_process(runs):
    from tair_tpu_torch.train import step as tstep
    from tair_tpu_torch.train.checkpoint import restore_checkpoint, state_dicts

    ranks, _, _ = runs
    state = restore_checkpoint(ranks[0]["tp_checkpoint"],
                               tstep.create_train_state(pw.tiny_model(), pw.STAGE, pw.LR))
    assert state.step == pw.STEPS
    (gm, go), wo = state_dicts(state), ranks[0]["fsdp_tp_optimizer"]
    trained, fresh = ranks[0]["fsdp_tp"]["trained"], pw.tiny_model().state_dict()
    assert set(gm) == set(fresh) and set(trained) < set(gm)
    for name, value in gm.items():  # the TP run's parameters, gathered; frozen ones as made
        assert torch.equal(value, trained[name] if name in trained else fresh[name]), name
    assert go["param_groups"] == wo["param_groups"]
    assert set(go["state"]) == set(wo["state"]) and len(wo["state"]) > 100
    for i, s in wo["state"].items():
        for key, value in s.items():
            assert torch.equal(go["state"][i][key], value), (i, key)


def test_one_process_checkpoint_resumes_on_the_mesh(runs):
    """Every rank resumes its part; rank 0 gathers it back and compares."""
    ranks, _, _ = runs
    got = ranks[0]["one_process_resume"]
    assert got["step"] == pw.STEPS and got["n_moments"] > 100
    assert got["differ"] == []


def test_sequence_parallel_without_a_group_raises():
    layer = EncoderLayer(16, 32, 2, 4, 2, sp_axis="model")
    shapes = ENCODER_SHAPES["even"]
    s = sum(h * w_ for h, w_ in shapes)
    ref = torch.from_numpy(encoder_reference_points(shapes))[None]
    with pytest.raises(RuntimeError, match="no process group"):
        layer(torch.zeros(1, s, 16), torch.zeros(1, s, 16), ref, shapes)


def test_a_tensor_parallel_layer_without_a_group_raises():
    """The axis' collectives take no default group (the world's is not the
    axis'): a layer cut without one refuses to run."""
    block = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Linear(16, 8))
    assert tp.shard_layers(block, {"0.weight": 0, "1.weight": 1}, None, 1, 0) == 2
    with pytest.raises(ValueError, match="process group"):
        block(torch.zeros(2, 8))
