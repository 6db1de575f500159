"""Data-parallel and FSDP training of the port on two gloo ranks, against one
process on the global batch and against the JAX package, float32 on the CPU.

One group of two spawned processes (``torch_parallel_worker.py``) runs every
multi-rank case once for the module, while this process computes the
one-process references from the same helpers. The global batch of 2 has 2
text instances in its first row and none in its second, so the two ranks'
criteria normalise by counts that differ from their own:

- DP and FSDP: two steps' losses equal the one-process global-batch step's
  (rtol 2e-4, the bound of ``tests/test_fsdp.py``) and the parameters after
  them within 1e-5 wherever the gradient stands clear of float32 noise; so
  do FSDP's two steps with ``use_checkpoint`` (the one-process step runs
  without it: ``test_torch_checkpointing.py`` holds the two equal) and
  FSDP's two micro-steps with ``grad_accum`` 2 (reduced on the update only)
  against one process's;
  that one-process step is held to the JAX step by
  ``test_torch_train_step.py``;
- a checkpoint written under FSDP loads bit for bit into one process, and a
  sharded resume of it gathers back to the same state;
- the criterion's global normalisation equals JAX's ``set_criterion`` on the
  global batch;
- the trainer runs ``configs/train_smoke_fsdp.yaml`` on two ranks with the
  losses of a one-process run of its global batch, and ``val_patches`` with
  the patch batch sharded writes one process's image;
- a mesh the group cannot hold raises, on two ranks and in one process (a
  model axis too: `test_torch_tensor_parallel.py` runs one);
- the FSDP placement rule equals JAX's ``fsdp_specs`` / ``fraction_for`` leaf
  for leaf and byte for byte on the tiny bundle's shapes, on a data axis
  alone and with a model axis (no mesh, no init).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as w
from tair_tpu.parallel.fsdp import fraction_for as jax_fraction_for
from tair_tpu.parallel.fsdp import fsdp_specs as jax_fsdp_specs
from tair_tpu.spotter import losses as jl
from test_torch_common import (  # noqa: F401
    jax_fast_compiles, tiny_bundle_shapes, torch_single_thread,
)

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank 0's results, rank 1's, the one-process references, the
    directory): the two ranks run while the references are computed here."""
    from tair_tpu_torch.train.__main__ import main as train_main
    from tair_tpu_torch.utils.image_io import save_image
    from tair_tpu_torch.val_patches import main as val_patches_main

    out = tmp_path_factory.mktemp("two_ranks")
    (out / "lq").mkdir()
    # 28 x 28 with 16-pixel patches overlapping by 4: a 2 x 2 grid of patches
    save_image(str(out / "lq" / "img.png"), np.random.default_rng(175).random((28, 28, 3)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests")]),
               OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_parallel_worker.py"), str(r), str(WORLD),
             str(out / "store"), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r in range(WORLD)
    ]
    try:
        ref = {"steps": w.run_steps(w.tiny_model()),
               "accum": w.run_steps(w.tiny_model(), grad_accum=2)}
        one = out / "one"
        cfg = w.trainer_config(out / "train_one.yaml", one / "trainer", fsdp=False,
                               batch_size=WORLD)
        train_main(["--config", str(cfg), "--device", "cpu", "--max-steps", str(w.STEPS)])
        vp = w.val_patches_config(out / "vp_one.yaml", out / "lq", one / "val_patches")
        val_patches_main(["--config", str(vp), "--device", "cpu"])
        logs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err[-4000:]
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return ranks[0], ranks[1], ref, out


@pytest.mark.parametrize("mode", ["dp", "fsdp", "fsdp_ckpt", "fsdp_accum"])
def test_steps_equal_the_one_process_global_batch_step(runs, mode):
    r0, r1, ref, _ = runs
    want_aux, _, (want_sd, _), least_grad = ref["accum" if mode == "fsdp_accum" else "steps"]
    assert r0[mode] == r1[mode]  # every rank reports the group's mean
    for got, want in zip(r0[mode], want_aux):
        assert set(got) == set(want) and "loss_ocr_texts" in got
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=2e-4, err_msg=key)
    got_sd = {"dp": r0["dp_state"], "fsdp": r0["fsdp_state"][0],
              "fsdp_ckpt": r0["fsdp_ckpt_state"], "fsdp_accum": r0["fsdp_accum_state"]}[mode]
    assert set(got_sd) == set(want_sd)
    for name, value in want_sd.items():
        err = np.abs(got_sd[name].numpy() - value.detach().numpy())
        if name not in least_grad:  # frozen
            assert err.max() == 0, name
            continue
        # Adam moves every element by about LR whatever its gradient: where
        # the gradient is float32 noise (|g| < 1e-6, summed in another order
        # over the ranks) so is the sign of its move
        solid = least_grad[name].numpy() >= 1e-6
        assert (err[solid] <= 1e-5).all(), (name, err[solid].max())
        assert (err <= 2.1 * w.LR * w.STEPS).all(), (name, err.max())


def _assert_states_equal(got, want):
    (gm, go), (wm, wo) = got, want
    assert set(gm) == set(wm)
    for name in wm:
        assert torch.equal(gm[name], wm[name]), name
    assert go["param_groups"] == wo["param_groups"] and set(go["state"]) == set(wo["state"])
    for i, s in wo["state"].items():
        for key, value in s.items():
            assert torch.equal(go["state"][i][key], value), (i, key)


def test_fsdp_checkpoint_loads_bit_for_bit_into_one_process(runs):
    from tair_tpu_torch.train import step as tstep
    from tair_tpu_torch.train.checkpoint import restore_checkpoint, state_dicts

    r0, _, _, _ = runs
    state = restore_checkpoint(r0["fsdp_checkpoint"],
                               tstep.create_train_state(w.tiny_model(), w.STAGE, w.LR))
    assert state.step == w.STEPS
    _assert_states_equal(state_dicts(state), r0["fsdp_state"])


def test_sharded_resume_gathers_back_to_the_saved_state(runs):
    r0, _, _, _ = runs
    _assert_states_equal(r0["resumed_state"], r0["fsdp_state"])


def test_criterion_normalises_by_the_global_batch_as_jax(runs):
    outputs, targets = w.criterion_case()
    want = jax.jit(jl.set_criterion)(w.tree_map(jnp.asarray, outputs),
                                    w.tree_map(jnp.asarray, targets))
    for got in (runs[0]["criterion"], runs[1]["criterion"]):
        assert set(got) == set(want)
        for key, value in want.items():
            np.testing.assert_allclose(got[key], float(value), rtol=2e-5, err_msg=key)


def _train_losses(exp):
    records = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    return [{k: v for k, v in r.items() if k.startswith("train/loss")}
            for r in records if "train/loss_total" in r]


def test_trainer_runs_the_fsdp_config_on_two_ranks(runs):
    from tair_tpu_torch.train import step as tstep
    from tair_tpu_torch.train.checkpoint import restore_checkpoint

    _, _, _, out = runs
    got, want = _train_losses(out / "trainer"), _train_losses(out / "one" / "trainer")
    assert len(got) == len(want) == w.STEPS
    for g, v in zip(got, want):
        assert set(g) == set(v)
        for key in v:
            np.testing.assert_allclose(g[key], v[key], rtol=2e-4, err_msg=key)
    # its gathered checkpoint resumes a one-process run
    path = out / "trainer" / "checkpoints" / f"step_{w.STEPS:08d}"
    state = restore_checkpoint(str(path), tstep.create_train_state(w.tiny_model(), w.STAGE, w.LR))
    assert state.step == w.STEPS


def test_val_patches_on_two_ranks_writes_one_process_image(runs):
    from tair_tpu_torch.utils.image_io import load_image

    _, _, _, out = runs
    got = load_image(str(out / "val_patches" / "restored_img.png"))
    want = load_image(str(out / "one" / "val_patches" / "restored_img.png"))
    assert got.shape == want.shape == (112, 112, 3)
    # 8-bit images: the rows restored at another batch size may round the
    # other way, by one level at most
    assert np.abs(got - want).max() <= 1 / 255 + 1e-6
    assert (got != want).mean() < 0.01


def test_a_mesh_the_group_cannot_hold_raises(runs):
    from tair_tpu_torch.parallel.mesh import create_mesh

    assert runs[0]["larger_mesh_raised"] and runs[1]["larger_mesh_raised"]
    with pytest.raises(ValueError, match="impossible with 1 devices"):
        create_mesh(2, device_type="cpu")
    with pytest.raises(ValueError, match="mesh 1x2 impossible with 1 devices"):
        create_mesh(1, 2, device_type="cpu")


@pytest.mark.parametrize("n_data,n_model", [(2, 1), (4, 1), (8, 1), (2, 2), (4, 2), (2, 4)],
                         ids=["2", "4", "8", "2x2", "4x2", "2x4"])
def test_fsdp_placement_equals_jax_leaf_for_leaf(n_data, n_model):
    """The rule on the port's parameters against JAX's ``fsdp_specs`` on the
    tiny bundle's JAX shapes (ShapeDtypeStructs: no mesh, no init), on a
    data axis alone and on a ("data", "model") mesh, where the model axis
    claims its axis first: the same leaves sharded on the data axis, on the
    torch axis that holds the JAX axis, the same specs on both axes, and the
    same (sharded, total, per-device) bytes, with and without stage 3's
    AdamW moments."""
    from tair_tpu_torch.parallel.fsdp import fsdp_specs
    from tair_tpu_torch.parallel.fsdp import jax_leaf_shapes, shard_dims, sharded_fraction
    from tair_tpu_torch.pipeline import build_tiny_model
    from tair_tpu_torch.train.stages import trainable_mask
    from tair_tpu_torch.weights.convert import torch_axes

    model = build_tiny_model(device="cpu", training=True)
    tree = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32),
                        tiny_bundle_shapes())
    specs = {}
    jax.tree_util.tree_map_with_path(
        lambda kp, spec: specs.update({"/".join(k.key for k in kp): tuple(spec)}),
        jax_fsdp_specs(tree, n_data, n_model),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec),
    )
    leaves = jax_leaf_shapes(model)
    dims = shard_dims(model, n_data, n_model)
    assert len(leaves) == len(specs)
    assert fsdp_specs(dict(leaves.values()), n_data, n_model) == specs
    n_sharded = 0
    for name, (path, shape) in leaves.items():
        spec = specs[path]
        if "data" in spec:
            axis = torch_axes(tuple(path.split("/")), len(shape))[spec.index("data")]
            assert dims[name] == axis, name
            assert model.get_parameter(name).shape[axis] % n_data == 0, name
            n_sharded += 1
        else:
            assert dims[name] is None, name
    assert n_sharded > 0

    if n_model > 1:
        assert any("model" in spec and "data" in spec for spec in specs.values())
    assert sharded_fraction(model, n_data, n_model=n_model) == jax_fraction_for(
        tree, n_data, n_model)
    mask = trainable_mask(model, "stage3")
    trained = [p for name, p in model.named_parameters() if mask[name]]
    moment = {path: jax.ShapeDtypeStruct(shape, jnp.float32)
              for name, (path, shape) in leaves.items() if mask[name]}
    state = {"params": tree, "mu": moment, "nu": moment}
    assert sharded_fraction(model, n_data, moments=trained, n_model=n_model) == \
        jax_fraction_for(state, n_data, n_model)
