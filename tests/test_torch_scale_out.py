"""The port's scale-out library (``bde2vid_tpu_torch/parallel`` and the
data-parallel serving bundles) on one gloo group of four CPU ranks, held to
the JAX package's ``parallel`` on ``make_mesh(4, 1)`` of the virtual CPU
devices and to the port's own one-process results.

One group (``tests/torch_scale_out_ranks.py``) runs every case: the mesh and
its placements, ``eval_chunks_sharded`` of a step model, a ragged FireNet
and a small BDE2VID, ``make_dp_train_step`` without and with BatchNorm, and
data-parallel bundles (a BDE2VID at ``data_parallel`` 4, an E2VIDRecurrent
at 2 over the four ranks). The weights come from a numpy seed in the JAX
package's layout and reach the port through ``state_dict_from_jax``.
"""

import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from bde2vid_tpu.models import build_model as jax_build
from bde2vid_tpu.models.api import ModelSpec as JaxSpec
from bde2vid_tpu.parallel.mesh import make_mesh as jax_make_mesh
from bde2vid_tpu.parallel.sharded_eval import eval_chunks_sharded as jax_eval_chunks_sharded
from bde2vid_tpu.parallel.sharded_train import make_dp_train_step as jax_make_dp_train_step
from bde2vid_tpu.train.trainer import SequenceLossComputer as JaxLoss
from bde2vid_tpu_torch.eval.checkpoint import load_state_dict_checked, state_dict_from_jax
from bde2vid_tpu_torch.models import ModelSpec, build_model, run_sequence, run_sequence_chunked
from bde2vid_tpu_torch.serving import export_spec_bundle, run_voxels, save_bundle, serving_mesh
from bde2vid_tpu_torch.train import SequenceLossComputer, train_step
from tests.test_torch_e2vid import nchw, seeded_tree
from tests.test_torch_parallel_nwindow import concrete_gathers  # noqa: F401  (a fixture)
from tests.torch_scale_out_ranks import RANKS, spawn_group
from tests.torch_threads import one_thread  # noqa: F401  (autouse: torch on one thread, as in the ranks)

B = 5
SMALL = {"num_bins": B, "num_encoders": 2, "base_num_channels": 8, "num_residual_blocks": 1}
FIRE = {"num_bins": B, "base_num_channels": 8, "num_residual_blocks": 2}
BDE2VID = {"generator": {"num_bins": B, "basechannels": 8, "num_encoders": 2, "ks": 3,
                         "num_res_blocks": 1, "buffer_index": [-1, 0, 1], "depths": [2, 2],
                         "num_heads": 4, "window_size": [7, 7], "drop_path_rate": 0.0}}
# name: (family, config, num_encoders, (T, H, W), chunk)
EVAL_CASES = {
    "E2VIDRecurrent": ("E2VIDRecurrent", SMALL, 2, (16, 32, 32), 2),
    "FireNet-ragged": ("FireNet", FIRE, 0, (11, 32, 32), 2),
    "BDE2VID": ("BDE2VID", BDE2VID, 2, (9, 28, 28), 2),
}
# name: (config, Adam's eps). Adam's first step is lr * sign(g): a gradient
# component near zero that the two packages round to opposite signs moves a
# weight by 2 lr. BN gradients differ by up to ~1e-5 between the packages
# (ReLU ties), so with BN an eps of 1e-2 keeps the step Lipschitz in the
# gradient and the weights hold at the same 1e-5.
STEP_CASES = {"E2VIDRecurrent": (SMALL, 1e-8), "E2VIDRecurrent-BN": (dict(SMALL, norm="BN"), 1e-2)}
T_STEP, H_STEP = 3, 32
# name: (family, data_parallel, voxels (T, N, B, H, W))
SERVING_CASES = {"BDE2VID": ("BDE2VID", 4, (2, 4, B, 28, 28)),
                 "E2VIDRecurrent": ("E2VIDRecurrent", 2, (4, 4, B, 32, 32))}


@functools.lru_cache(maxsize=None)
def _jax_shapes(name, cfg_json, h, w, train):
    """The flax module and its variables' shapes (``jax.eval_shape``)."""
    jm = jax_build(name, json.loads(cfg_json), train=train)
    if name == "BDE2VID":
        return jm, jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((2, 1, h, w, B)))
    v = jnp.zeros((1, h, w, B))
    return jm, jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), v, jm.initial_state(1, h, w)))


def _jax_variables(name, cfg, shape, seed, train=False):
    _, h, w = shape
    jm, shapes = _jax_shapes(name, json.dumps(cfg, sort_keys=True), h, w, train)
    return jm, seeded_tree(shapes, seed)


def _port(name, cfg, variables, train=False):
    model = build_model(name, cfg, device="cpu", train=train)
    load_state_dict_checked(model, state_dict_from_jax(variables))
    return model


def _write_model(folder, key, name, cfg, variables, **meta):
    torch.save(state_dict_from_jax(variables), folder / f"{key}.pt")
    (folder / f"{key}.json").write_text(json.dumps({"name": name, "config": cfg, **meta}))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Inputs for every case, the one group's run, and what the parent
    needs to hold its results: {case: {key: ...}}."""
    work = tmp_path_factory.mktemp("scale_out")
    rng = np.random.default_rng(24)
    inputs = {"eval": {}, "dp_step": {}, "serving": {}}

    folder = work / "eval"
    folder.mkdir()
    for seed, (key, (name, cfg, n_enc, shape, chunk)) in enumerate(EVAL_CASES.items()):
        jm, variables = _jax_variables(name, cfg, shape, seed)
        t, h, w = shape
        voxels = rng.normal(size=(t, 1, h, w, B)).astype(np.float32)
        _write_model(folder, key, name, cfg, variables, num_encoders=n_enc, chunk=chunk,
                     is_sequence_model=name == "BDE2VID")
        torch.save(nchw(voxels), folder / f"{key}_voxels.pt")
        inputs["eval"][key] = (jm, variables, voxels)
    (folder / "keys.json").write_text(json.dumps(list(EVAL_CASES)))

    folder = work / "dp_step"
    folder.mkdir()
    for seed, (key, (cfg, eps)) in enumerate(STEP_CASES.items()):
        jm, variables = _jax_variables("E2VIDRecurrent", cfg, (T_STEP, H_STEP, H_STEP), 10 + seed,
                                       train=True)
        voxels = rng.normal(size=(T_STEP, RANKS, H_STEP, H_STEP, B)).astype(np.float32)
        frames = rng.uniform(size=(T_STEP, RANKS, H_STEP, H_STEP, 1)).astype(np.float32)
        _write_model(folder, key, "E2VIDRecurrent", cfg, variables, train=True, eps=eps)
        torch.save({"voxels": nchw(voxels), "frames": nchw(frames)}, folder / f"{key}_batch.pt")
        inputs["dp_step"][key] = (jm, variables, voxels, frames)
    (folder / "keys.json").write_text(json.dumps(list(STEP_CASES)))

    folder = work / "serving"
    folder.mkdir()
    for seed, (key, (name, dp, shape)) in enumerate(SERVING_CASES.items()):
        cfg = BDE2VID if name == "BDE2VID" else SMALL
        t, n, _, h, w = shape
        _, variables = _jax_variables(name, cfg, (t, h, w), 20 + seed)
        model = _port(name, cfg, variables).eval()
        spec = ModelSpec(name=name, module=model, num_bins=B, num_encoders=2,
                         is_sequence_model=name == "BDE2VID")
        bundle = export_spec_bundle(spec, h, w, seq_len=t, batch=n, platforms=("cpu",),
                                    data_parallel=dp)
        save_bundle(str(folder / f"{key}.zip"), bundle)
        voxels = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        torch.save(voxels, folder / f"{key}_voxels.pt")
        inputs["serving"][key] = (spec, bundle, voxels)
    (folder / "keys.json").write_text(json.dumps(list(SERVING_CASES)))

    (work / "mesh").mkdir()
    spawn_group(work, ["mesh", "eval", "dp_step", "serving"])
    got = {case: [torch.load(work / case / f"rank{r}.pt", weights_only=False)
                  for r in range(RANKS)] for case in ("mesh", "eval", "dp_step", "serving")}
    return inputs, got


def test_mesh_placements_and_row_blocks(group):
    _, got = group
    for r, g in enumerate(got["mesh"]):
        assert g["shape"] == (RANKS, 1) and g["names"] == ("data", "spatial")
        assert tuple(g["coordinate"]) == (r, 0)
        assert "needs 8x1=8 ranks, found 4" in g["too_many"]
        x = torch.arange(RANKS * 2 * 3).reshape(RANKS * 2, 3)
        torch.testing.assert_close(g["rows"], x[2 * r:2 * r + 2], rtol=0, atol=0)
        torch.testing.assert_close(g["rows_b"], 2 * x[2 * r:2 * r + 2], rtol=0, atol=0)
        torch.testing.assert_close(g["cols"], x.T[:, 2 * r:2 * r + 2], rtol=0, atol=0)
        assert g["n"] == 7
        assert g["placements"] == ["Shard(dim=1)", "Replicate()", "Replicate()", "Replicate()",
                                   "Shard(dim=1)", "Shard(dim=2)"]


@pytest.mark.parametrize("key", list(EVAL_CASES))
def test_eval_chunks_sharded_matches_jax_and_the_one_process_chunks(group, key):
    inputs, got = group
    name, cfg, n_enc, (t, h, w), chunk = EVAL_CASES[key]
    jm, variables, voxels = inputs["eval"][key]
    seq = name == "BDE2VID"
    images = [g[key] for g in got["eval"]]
    for other in images[1:]:  # every rank returns all T
        torch.testing.assert_close(other, images[0], rtol=0, atol=0)
    assert images[0].shape == (t, 1, 1, h, w)

    spec = JaxSpec(name=name, module=jm, params=variables, num_bins=B, num_encoders=n_enc,
                   is_sequence_model=seq)
    want_jax = np.asarray(jax_eval_chunks_sharded(spec, jnp.asarray(voxels), chunk,
                                                  mesh=jax_make_mesh(RANKS, 1)))
    np.testing.assert_allclose(images[0].numpy(), np.moveaxis(want_jax, -1, 2), atol=1e-5)

    model = _port(name, cfg, variables).eval()
    x = nchw(voxels)
    with torch.no_grad():
        if seq:
            want = torch.cat([model(x[s:s + chunk])["image"] for s in range(0, t, chunk)])
        else:
            want = run_sequence_chunked(model, x, model.initial_state(1, h, w), chunk)
    assert (images[0] - want).abs().max().item() <= 1e-6


def _moments(opt_state, key):
    """optax Adam's mu / nu in the port's state-dict layout."""
    adam = opt_state[0]
    return state_dict_from_jax(getattr(adam, key))


@pytest.mark.parametrize("key", list(STEP_CASES))
def test_dp_train_step_matches_jax_make_dp_train_step(group, key):
    inputs, got = group
    jm, variables, voxels, frames = inputs["dp_step"][key]
    cfg, eps = STEP_CASES[key]
    tx = optax.adam(1e-3, eps=eps)
    step = jax_make_dp_train_step(jm, tx, JaxLoss([{"type": "L1Loss"}]), jax_make_mesh(RANKS, 1),
                                  is_sequence_model=False, donate=False)
    new_vars, opt_state, loss = step(variables, tx.init(variables), jax.random.PRNGKey(7),
                                     jnp.asarray(voxels), jnp.asarray(frames), None)
    want_state = state_dict_from_jax(new_vars)
    mu, nu = _moments(opt_state, "mu"), _moments(opt_state, "nu")
    results = [g[key] for g in got["dp_step"]]
    for res in results[1:]:  # the ranks stay equal
        for k, v in res["state"].items():
            torch.testing.assert_close(v, results[0]["state"][k], rtol=0, atol=0)
    res = results[0]
    assert abs(res["loss"]["loss"] - float(loss["loss"])) <= 1e-6
    for k, v in res["state"].items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(v.numpy(), want_state[k].numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    assert res["exp_avg"].keys() <= mu.keys()
    for k in res["exp_avg"]:
        np.testing.assert_allclose(res["exp_avg"][k].numpy(), mu[k].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(res["exp_avg_sq"][k].numpy(), nu[k].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    if "BN" in key:  # the averaged running statistics moved
        assert any(k.endswith("running_var") for k in res["state"])
        return

    # no BatchNorm: the one-process step on the concatenated batch
    model = _port("E2VIDRecurrent", cfg, variables, train=True)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    one = train_step(model, opt, SequenceLossComputer([{"type": "L1Loss"}]), nchw(voxels),
                     nchw(frames))
    assert abs(float(one["loss"]) - res["loss"]["loss"]) <= 1e-6
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(res["state"][k].numpy(), v.numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    names = {p: n for n, p in model.named_parameters()}
    for p, s in opt.state.items():
        np.testing.assert_allclose(res["exp_avg"][names[p]].numpy(), s["exp_avg"].numpy(),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("key", list(SERVING_CASES))
def test_dp_bundle_matches_the_live_unsharded_forward(group, key):
    inputs, got = group
    spec, bundle, voxels = inputs["serving"][key]
    assert bundle.meta["data_parallel"] == SERVING_CASES[key][1]
    assert bundle.meta["batch"] == voxels.shape[1]
    with torch.no_grad():
        if spec.is_sequence_model:
            want = spec.module(voxels)["image"]
        else:
            want = run_sequence(spec.module, voxels, spec.initial_state(*voxels.shape[1:2],
                                                                        *voxels.shape[-2:]))[0]
    for g in got["serving"]:  # every rank returns the whole batch
        np.testing.assert_allclose(g[key].numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    # one process holds too few ranks for it
    with pytest.raises(ValueError, match="data parallelism"):
        run_voxels(bundle, voxels)


def test_serving_mesh_needs_data_parallel_ranks(group):
    _, got = group
    for g in got["serving"]:
        assert g["mesh"] == ((RANKS,), ("data",))
        assert "8-way data parallelism but only 4 rank(s)" in g["too_few"]
    with pytest.raises(ValueError, match="2-way data parallelism but only 1 rank"):
        serving_mesh(2)
    assert serving_mesh(1) is None


def test_export_refuses_a_batch_that_does_not_divide(group):
    inputs, _ = group
    spec = inputs["serving"]["E2VIDRecurrent"][0]
    with pytest.raises(ValueError, match="batch=3 does not divide over data_parallel=2"):
        export_spec_bundle(spec, 32, 32, batch=3, platforms=("cpu",), data_parallel=2)
