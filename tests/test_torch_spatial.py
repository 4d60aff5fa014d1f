"""The port's row-sharded forward and train step (``bde2vid_tpu_torch/
parallel/spatial.py``, the counterpart of the JAX package's
``spatial_sharding``) on one gloo group of four CPU ranks, held to the JAX
package and to the port's own unsharded forward and step.

One group (``tests/torch_spatial_ranks.py``) runs every case: ``halo_rows``
on three of the ranks; ``spatial_forward`` of an E2VIDRecurrent over 4 row
bands (the config of ``tests/test_sharded_eval.py:83``), of a BDE2VID with
plain and dilated 7x7 blocks on 2 bands and on 4 uneven ones (``:110``), of
the 8x8 config on 2, and of the other configurations the path takes; the
families it refuses; and ``make_dp_train_step`` on a (2, 2) mesh (the
configs of ``tests/test_sharded_train.py:109, :140``). The JAX references
run in this process while the ranks run. The weights come from a numpy seed
in the JAX package's layout and reach the port through
``state_dict_from_jax``.

Tolerances: the sharded port against the unsharded port 1e-5 (images,
losses and weights); the port against JAX 2e-4, the bar of the port's
parity tests (``tests/test_torch_e2vid.py``, ``tests/test_bde2vid.py``);
gradients sharded against unsharded 1e-6 abs / 1e-5 rel, the JAX test's,
and against JAX 5e-5 abs / 1e-3 rel, the bar of
``tests/test_torch_train_grads.py``.
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
from bde2vid_tpu.models.api import run_sequence as jax_run_sequence
from bde2vid_tpu.parallel.mesh import make_mesh as jax_make_mesh
from bde2vid_tpu.parallel.mesh import spatial_sharding as jax_spatial_sharding
from bde2vid_tpu.train.trainer import SequenceLossComputer as JaxLoss
from bde2vid_tpu.train.trainer import make_train_step as jax_make_train_step
from bde2vid_tpu_torch.eval.checkpoint import load_state_dict_checked, state_dict_from_jax
from bde2vid_tpu_torch.models import build_model, run_sequence
from bde2vid_tpu_torch.parallel import RowPlan
from bde2vid_tpu_torch.train import SequenceLossComputer, train_step
from tests.test_torch_e2vid import nchw, seeded_tree
from tests.test_torch_parallel_nwindow import concrete_gathers  # noqa: F401  (autouse)
from tests.torch_spatial_ranks import CASES, RANKS, start_group, wait
from tests.torch_threads import one_thread  # noqa: F401  (autouse: torch on one thread)

B = 5
SMALL = {"num_bins": B, "num_encoders": 2, "base_num_channels": 8, "num_residual_blocks": 1}
GEN = {"num_bins": B, "basechannels": 8, "num_encoders": 2, "ks": 3, "num_res_blocks": 1,
       "buffer_index": [-1, 0, 1], "depths": [2, 2], "num_heads": 4, "window_size": [7, 7],
       "drop_path_rate": 0.0}
BDE2VID = {"generator": GEN}
EIGHT = {"generator": dict(GEN, window_size=[8, 8])}
THREE = dict(GEN, num_encoders=3, depths=[2, 0, 2])  # a depth-0 level: norm-free resblocks

# key: (family, config, (T, N, H, W), (data, spatial) mesh, held to JAX)
FORWARD = {
    "E2VIDRecurrent": ("E2VIDRecurrent", SMALL, (4, 1, 64, 32), (1, 4), True),
    "E2VIDRecurrent-2x2": ("E2VIDRecurrent", SMALL, (4, 2, 64, 32), (2, 2), False),
    "BDE2VID-2": ("BDE2VID", BDE2VID, (5, 1, 56, 56), (1, 2), True),
    "BDE2VID-4": ("BDE2VID", BDE2VID, (5, 1, 56, 56), (1, 4), True),
    "BDE2VID-4-kernel": ("BDE2VID", dict(BDE2VID, use_pallas_attention=True), (5, 1, 56, 56),
                         (1, 4), True),
    "8x8-kernel": ("BDE2VID", dict(EIGHT, use_pallas_attention=True), (3, 1, 64, 64), (1, 2),
                   True),
    "E2VID-transposed-BN": ("E2VID", dict(SMALL, norm="BN", use_upsample_conv=False),
                            (2, 1, 64, 32), (1, 4), False),
    "E2VIDRecurrent-IN-GRU-concat": ("E2VIDRecurrent", dict(SMALL, norm="IN", skip_type="concat",
                                                            recurrent_block_type="convgru"),
                                     (3, 1, 64, 32), (1, 4), False),
    "FireNet": ("FireNet", {"num_bins": B, "base_num_channels": 8}, (3, 1, 30, 32), (1, 3), False),
    "FireNetOrg": ("FireNetOrg", {"num_bins": B, "base_num_channels": 8}, (3, 1, 30, 32), (1, 3),
                   False),
    "FlowNet": ("FlowNet", SMALL, (2, 1, 64, 32), (1, 4), False),
    "BDE2VID-3-BN-concat-GRU": ("BDE2VID", {"generator": dict(THREE, norm="BN", skip_type="concat",
                                                              recurrent_block_type="convgru")},
                                (3, 1, 112, 56), (1, 4), False),
    "BDE2VID-3-IN-kernel": ("BDE2VID", {"use_pallas_attention": True,
                                        "generator": dict(THREE, norm="IN")}, (3, 1, 112, 56),
                            (1, 4), False),
    "BDE2VID-parallel-kernel": ("BDE2VID", {"parallel_attention": True,
                                            "use_pallas_attention": True, "generator": GEN},
                                (3, 1, 56, 56), (1, 2), False),
    "BDE2VID-nwindow": ("BDE2VID", {"generator": dict(GEN, nwindow_size=[2, 2])}, (3, 1, 56, 56),
                        (1, 2), False),
}
# key: (family, config, (T, N, H, W), optimizer, held to JAX)
TRAIN = {
    "E2VIDRecurrent": ("E2VIDRecurrent", SMALL, (3, 2, 64, 32), "adam", True),
    "BDE2VID": ("BDE2VID", BDE2VID, (3, 2, 56, 56), "sgd", True),
    "8x8-kernel": ("BDE2VID", dict(EIGHT, use_pallas_attention=True), (3, 2, 64, 64), "sgd", False),
    "BDE2VID-3-IN-remat-kernel": ("BDE2VID", {"remat": True, "use_pallas_attention": True,
                                              "generator": dict(THREE, norm="IN")},
                                  (3, 2, 112, 56), "sgd", False),
}
# The relative L2 bar of all gradients where the elementwise one cannot
# hold: InstanceNorm on these maps makes the gradients jump at ReLU ties.
# The unsharded step itself moves its gradients by 7.0e-4 and 1.1e-3
# (relative L2) under a 1e-7 relative change of the voxels at 2 of 8 seeds;
# this case's sharded gradients lie 1.66e-3 from the unsharded ones, the
# other seeds' ~2e-6. A missing or doubled row sum misses by O(1).
GRAD_L2 = {"BDE2VID-3-IN-remat-kernel": 5e-3}
REFUSED = {"SPADE-E2VID": ("SPADEE2VID", {"num_bins": B}),
           "EITR": ("EITR", {"num_bins": B}),
           "EVSNN": ("EVSNN", {"num_bins": B}),
           "PAEVSNN": ("PAEVSNN", {"num_bins": B})}
HALO = {"ranks": 3, "height": 24, "levels": 1, "level": 1, "above": [0, 3, 6], "below": [5, 4, 0]}


def _jax_config(name, cfg):
    """The JAX package's config: the kernel switch off (its interpret-mode
    Pallas is the slow path on the CPU; both paths are one function)."""
    cfg = json.loads(json.dumps(cfg))
    cfg.pop("use_pallas_attention", None)
    return cfg


@functools.lru_cache(maxsize=None)
def _jax_shapes(name, cfg_json, h, w, train):
    jm = jax_build(name, json.loads(cfg_json), train=train)
    if name == "BDE2VID":
        return jm, jax.eval_shape(jm.init, {"params": jax.random.PRNGKey(0),
                                            "droppath": jax.random.PRNGKey(1)},
                                  jnp.zeros((2, 1, h, w, B)))
    v = jnp.zeros((1, h, w, B))
    return jm, jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), v, jm.initial_state(1, h, w)))


def _jax_variables(name, cfg, h, w, seed, train=False):
    jm, shapes = _jax_shapes(name, json.dumps(_jax_config(name, cfg), sort_keys=True), h, w, train)
    return jm, seeded_tree(shapes, seed)


def _torch_state(name, cfg, seed):
    """The state dict of a port model that no JAX reference needs, from
    torch's seeded init (the cheaper way: no flax shapes to trace)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build_model(name, cfg, device="cpu").state_dict()


def _write_model(folder, key, name, cfg, state):
    torch.save(state, folder / f"{key}.pt")
    (folder / f"{key}.json").write_text(json.dumps({"name": name, "config": cfg}))


def _inputs(work, rng):
    """Every case's inputs on disk, and what the parent keeps of them."""
    for case in CASES:
        (work / case).mkdir()
    kept = {"forward": {}, "train": {}}
    folder = work / "halo"
    (folder / "spec.json").write_text(json.dumps(HALO))
    whole = torch.from_numpy(rng.normal(size=(2, 12, 3)).astype(np.float32))
    torch.save(whole, folder / "whole.pt")
    weights = []
    for r in range(HALO["ranks"]):
        rows = 4 + HALO["above"][r] + HALO["below"][r]
        weights.append(torch.from_numpy(rng.normal(size=(2, rows, 3)).astype(np.float32)))
        torch.save(weights[-1], folder / f"weight{r}.pt")
    kept["halo"] = (whole, weights)

    folder = work / "forward"
    shared = {}  # one JAX reference for each config and shape, the kernel switch aside
    for seed, (key, (name, cfg, (t, n, h, w), _, held)) in enumerate(FORWARD.items()):
        ref = json.dumps([name, _jax_config(name, cfg), t, n, h, w], sort_keys=True)
        if ref not in shared:
            voxels = rng.normal(size=(t, n, h, w, B)).astype(np.float32)
            variables = _jax_variables(name, cfg, h, w, seed)[1] if held else None
            shared[ref] = (variables, voxels, ref)
        variables, voxels, _ = shared[ref]
        _write_model(folder, key, name, cfg, _torch_state(name, cfg, seed) if variables is None
                     else state_dict_from_jax(variables))
        torch.save(nchw(voxels), folder / f"{key}_voxels.pt")
        kept["forward"][key] = shared[ref]
    (folder / "keys.json").write_text(json.dumps(
        {k: {"name": v[0], "mesh": v[3]} for k, v in FORWARD.items()}))

    (work / "refusals" / "keys.json").write_text(json.dumps(
        {k: {"name": name, "config": cfg, "bins": B, "hw": [32, 32]}
         for k, (name, cfg) in REFUSED.items()}))

    folder = work / "train"
    for seed, (key, (name, cfg, (t, n, h, w), opt, held)) in enumerate(TRAIN.items()):
        variables = _jax_variables(name, cfg, h, w, 30 + seed, train=True)[1] if held else None
        _write_model(folder, key, name, cfg, _torch_state(name, cfg, 30 + seed) if variables is None
                     else state_dict_from_jax(variables))
        voxels = rng.normal(size=(t, n, h, w, B)).astype(np.float32)
        frames = rng.uniform(size=(t, n, h, w, 1)).astype(np.float32)
        torch.save({"voxels": nchw(voxels), "frames": nchw(frames)}, folder / f"{key}_batch.pt")
        kept["train"][key] = (variables, voxels, frames)
    (folder / "keys.json").write_text(json.dumps(
        {k: {"name": v[0], "optimizer": v[3]} for k, v in TRAIN.items()}))
    return kept


def _jax_forward(name, cfg, variables, voxels, spatial=None):
    jm, _ = _jax_shapes(name, json.dumps(_jax_config(name, cfg), sort_keys=True),
                        voxels.shape[2], voxels.shape[3], False)
    if name == "BDE2VID":
        def fwd(v):
            return jm.apply(variables, v)[0]["image"]
    else:
        state0 = jm.initial_state(1, voxels.shape[2], voxels.shape[3])

        def fwd(v):
            return jax_run_sequence(jm, variables, v, state0)[0]
    v = jnp.asarray(voxels)
    if spatial is None:
        return np.asarray(jax.jit(fwd)(v))
    mesh = jax_make_mesh(1, spatial)  # the JAX test's own sharded run
    with mesh:
        return np.asarray(jax.jit(fwd)(jax.device_put(v, jax_spatial_sharding(mesh, 5, 1, 2))))


def _jax_train(key, variables, voxels, frames):
    """JAX's unsharded step: (loss, gradients or None, weights after it) in
    the port's layout. E2VIDRecurrent: ``make_train_step`` with Adam; BDE2VID:
    ``value_and_grad`` of the L1 loss, as the JAX test takes it, and the SGD
    step from it (one compile of the backward instead of two)."""
    name, cfg, _, opt, _ = TRAIN[key]
    jm, _ = _jax_shapes(name, json.dumps(_jax_config(name, cfg), sort_keys=True),
                        voxels.shape[2], voxels.shape[3], True)
    v, f = jnp.asarray(voxels), jnp.asarray(frames)
    if name != "BDE2VID":
        tx = optax.adam(1e-3)
        step = jax_make_train_step(jm, tx, JaxLoss([{"type": "L1Loss"}]), is_sequence_model=False,
                                   donate=False)
        new, _, loss = step(variables, tx.init(variables), jax.random.PRNGKey(3), v, f, None)
        return float(loss["loss"]), None, state_dict_from_jax(new)

    def loss_fn(p):
        out, _ = jm.apply(p, v, rngs={"droppath": jax.random.PRNGKey(3)})
        return jnp.mean(jnp.abs(out["image"] - f))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables)
    new = jax.tree_util.tree_map(lambda p, g: p - 1e-2 * g, variables, grads)
    return float(loss), state_dict_from_jax(grads), state_dict_from_jax(new)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The one group's results and the references: {"got": {case: [rank
    results]}, "jax": ..., "kept": ...}."""
    work = tmp_path_factory.mktemp("spatial")
    kept = _inputs(work, np.random.default_rng(25))
    ranks = start_group(work)
    try:  # the JAX references while the ranks run
        ref = {"forward": {}, "train": {}}
        for key, (name, cfg, _, spatial, held) in FORWARD.items():
            variables, voxels, shared = kept["forward"][key]
            if held and shared not in ref["forward"]:
                ref["forward"][shared] = _jax_forward(name, cfg, variables, voxels)
        variables, voxels, _ = kept["forward"]["E2VIDRecurrent"]
        ref["forward"]["E2VIDRecurrent-sharded"] = _jax_forward("E2VIDRecurrent", SMALL, variables,
                                                                voxels, spatial=4)
        for key, (*_, held) in TRAIN.items():
            if held:
                ref["train"][key] = _jax_train(key, *kept["train"][key])
    finally:
        wait(ranks)
    got = {case: [torch.load(work / case / f"rank{r}.pt", weights_only=False)
                  if (work / case / f"rank{r}.pt").exists() else None for r in range(RANKS)]
           for case in CASES}
    return {"got": got, "jax": ref, "kept": kept, "work": work}


def test_row_plan_bands_and_refusals():
    flagship = RowPlan(184, 3, 4)
    assert flagship.rows(3) == [6, 6, 6, 5] and flagship.rows(0) == [48, 48, 48, 40]
    assert RowPlan(184, 3, 2).rows(0) == [96, 88]
    assert RowPlan(56, 2, 4).rows(2) == [4, 4, 3, 3]
    assert [RowPlan(56, 2, 4).band(r, 1) for r in range(4)] == [(0, 8), (8, 16), (16, 22),
                                                                (22, 28)]
    assert flagship.level_of(3, 10) == 2 and flagship.level_of_height(46) == 2
    with pytest.raises(ValueError, match="a rank would hold no row"):
        RowPlan(24, 3, 4)  # 3 rows at the deepest level
    with pytest.raises(ValueError, match="do not halve"):
        RowPlan(60, 3, 2)


def test_halo_rows_forward_and_backward_on_three_ranks(group):
    whole, weights = group["kept"]["halo"]
    got = group["got"]["halo"]
    assert got[3] is None  # the fourth rank is not in the group
    padded = torch.nn.functional.pad(whole, (0, 0, 8, 8)).requires_grad_()
    total = 0
    for r in range(HALO["ranks"]):
        lo, hi = 4 * r, 4 * r + 4
        want = padded[:, lo - HALO["above"][r] + 8:hi + HALO["below"][r] + 8]
        torch.testing.assert_close(got[r]["out"], want.detach(), rtol=0, atol=0)
        total = total + (want * weights[r]).sum()
        # one exchange forward, one backward; every rank sends rows the others read
        assert got[r]["halo_exchanges"] == 2 and got[r]["halo_bytes"] > 0
    total.backward()
    grad = torch.cat([got[r]["grad"] for r in range(HALO["ranks"])], dim=1)
    torch.testing.assert_close(grad, padded.grad[:, 8:20], rtol=0, atol=1e-6)


def _unsharded(group, key, folder_state):
    name, cfg, (t, n, h, w), _, _ = FORWARD[key]
    _, voxels, _ = group["kept"]["forward"][key]
    model = build_model(name, cfg, device="cpu").eval()
    load_state_dict_checked(model, folder_state)
    with torch.no_grad():
        if name == "BDE2VID":
            return model(nchw(voxels))["image"]
        return run_sequence(model, nchw(voxels), model.initial_state(n, h, w))[0]


@pytest.mark.parametrize("key", list(FORWARD))
def test_spatial_forward_matches_the_unsharded_forward_and_jax(group, key):
    name, cfg, (t, n, h, w), (n_data, spatial), held = FORWARD[key]
    ranks = n_data * spatial
    results = [g[key] for g in group["got"]["forward"][:ranks]]
    assert all(key not in g for g in group["got"]["forward"][ranks:])
    for res in results[1:]:  # every rank returns every row
        torch.testing.assert_close(res["images"], results[0]["images"], rtol=0, atol=0)
    got = results[0]["images"]
    assert got.shape == (t, n, 1, h, w)
    want = _unsharded(group, key, torch.load(group["work"] / "forward" / f"{key}.pt"))
    assert (got - want).abs().max().item() <= 1e-5
    if name == "BDE2VID":  # each rank's band at each attention level: the plan's
        plan = RowPlan(h, cfg["generator"]["num_encoders"], spatial)
        depths = cfg["generator"]["depths"]
        for r, res in enumerate(results):
            want_shapes = sorted((3, 3 if cfg.get("parallel_attention") else 1,
                                  plan.rows(lvl + 1)[r], w >> (lvl + 1), 8 << (lvl + 1))
                                 for lvl, d in enumerate(depths) if d)
            assert res["band_shapes"] == want_shapes
        if key == "BDE2VID-4":  # uneven bands: [4, 4, 3, 3] rows at attention level 1
            assert [res["band_shapes"][0][2] for res in results] == [4, 4, 3, 3]
    if held:
        jax_want = np.moveaxis(group["jax"]["forward"][group["kept"]["forward"][key][2]], -1, 2)
        np.testing.assert_allclose(got.numpy(), jax_want, atol=2e-4, rtol=0)
    if key == "E2VIDRecurrent":  # and JAX's own row-sharded run
        jax_sharded = np.moveaxis(group["jax"]["forward"]["E2VIDRecurrent-sharded"], -1, 2)
        np.testing.assert_allclose(got.numpy(), jax_sharded, atol=2e-4, rtol=0)


@pytest.mark.parametrize("family", list(REFUSED))
def test_families_the_row_sharded_path_does_not_take_refuse_by_name(group, family):
    for g in group["got"]["refusals"]:
        assert family in g[family] and "ROADMAP A16" in g[family]


def _port_step(group, key):
    name, cfg, _, opt, _ = TRAIN[key]
    _, voxels, frames = group["kept"]["train"][key]
    torch.manual_seed(0)  # as the ranks build it
    model = build_model(name, cfg, device="cpu", train=True)
    load_state_dict_checked(model, torch.load(group["work"] / "train" / f"{key}.pt"))
    optimizer = (torch.optim.Adam(model.parameters(), lr=1e-3) if opt == "adam"
                 else torch.optim.SGD(model.parameters(), lr=1e-2))
    loss = train_step(model, optimizer, SequenceLossComputer([{"type": "L1Loss"}]),
                      nchw(voxels), nchw(frames))
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    return float(loss["loss"]), grads, model.state_dict()


@pytest.mark.parametrize("key", list(TRAIN))
def test_row_sharded_train_step_matches_the_unsharded_step_and_jax(group, key):
    results = [g[key] for g in group["got"]["train"]]
    for res in results[1:]:  # the ranks stay equal
        for k, v in res["state"].items():
            torch.testing.assert_close(v, results[0]["state"][k], rtol=0, atol=0)
    res = results[0]
    loss, grads, state = _port_step(group, key)
    assert abs(res["loss"] - loss) <= 1e-5 * abs(loss)
    assert res["grads"].keys() == grads.keys()
    if key in GRAD_L2:  # see GRAD_L2
        diff = sum((res["grads"][k] - g).square().sum() for k, g in grads.items())
        assert (diff / sum(g.square().sum() for g in grads.values())).sqrt() <= GRAD_L2[key]
    else:
        for k, g in grads.items():
            np.testing.assert_allclose(res["grads"][k].numpy(), g.numpy(), atol=1e-6, rtol=1e-5,
                                       err_msg=k)
    for k, v in state.items():
        if v.is_floating_point():
            np.testing.assert_allclose(res["state"][k].numpy(), v.numpy(), atol=1e-5, rtol=1e-5,
                                       err_msg=k)
    if not TRAIN[key][4]:
        return
    jax_loss, jax_grads, jax_state = group["jax"]["train"][key]
    assert abs(res["loss"] - jax_loss) <= 1e-6
    for k, v in jax_state.items():
        np.testing.assert_allclose(res["state"][k].numpy(), v.numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    if jax_grads is not None:
        for k, g in jax_grads.items():
            np.testing.assert_allclose(res["grads"][k].numpy(), g.numpy(), atol=5e-5, rtol=1e-3,
                                       err_msg=k)
