"""The row-sharded forward and train step (``bde2vid_tpu_torch/parallel/
spatial.py``) of SPADE-E2VID, EITR, EVSNN and PAEVSNN on one gloo group of
four CPU ranks, held to the port's unsharded forward and step and to the
JAX package.

One group (``tests/torch_spatial_ranks.py``, ``FAMILY_CASES``) runs every
case: the whole map's reductions these families add (``group_max`` /
``group_min`` with ties on several ranks and none on others, ``group_mean``,
``legacy_norm`` per sample, ``all_tokens`` and its reduce-scatter gradient)
against the same functions of the whole tensor; ``spatial_forward`` of each
family on a (1, 4) mesh over uneven bands (SPADE-E2VID 40 rows: 3, 3, 2, 2
at its level 2; the others 48 rows: 2, 2, 1, 1 at level 3), T=2, batch 2;
and one ``make_dp_train_step`` step of each on the same mesh with SGD. The
JAX references run in this process while the ranks run, built from the
same numpy-seeded torch state dict through the JAX package's
``load_model_from_torch`` (its flax init by shape).

Tolerances: sharded against unsharded port 1e-5 (images, weights) and 1e-5
relative (loss); gradients by the relative L2 of all of them 1e-4; ranks'
weights bit-equal; the port against JAX 2e-4 (images), EITR also against
JAX's own GSPMD row-sharded run (``spatial_sharding`` on four CPU devices).
The reductions 1e-6.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bde2vid_tpu.eval.checkpoint import load_model_from_torch as jax_load
from bde2vid_tpu.models.api import run_sequence as jax_run_sequence
from bde2vid_tpu.parallel.mesh import make_mesh as jax_make_mesh
from bde2vid_tpu.parallel.mesh import spatial_sharding as jax_spatial_sharding
from bde2vid_tpu_torch.models import build_model, run_sequence
from bde2vid_tpu_torch.nn.layers import resize_nearest_torch
from bde2vid_tpu_torch.parallel.spatial import RowPlan, model_levels, shard_rows
from bde2vid_tpu_torch.train import SequenceLossComputer, train_step
from bde2vid_tpu_torch.utils.norm import legacy_norm
from tests.test_torch_e2vid import nchw
from tests.test_torch_lpips import flax_init_by_shape
from tests.torch_spatial_ranks import FAMILY_CASES, RANKS, recorded_spikes, start_group, wait
from tests.torch_threads import one_thread  # noqa: F401  (autouse: torch on one thread)

B = 5
EITR = {"num_bins": B, "norm": "BN", "d_model": 32, "dim_feedforward": 64, "nhead": 4,
        "channels": [8, 16, 32, 32]}
# key: (family, config, (T, N, H, W), row levels); EITR's 44 columns pad to 48
FAMILIES = {
    "SPADE-E2VID": ("SPADEE2VID", {"num_bins": B}, (2, 2, 40, 32), 2),
    "EITR": ("EITR", EITR, (2, 2, 48, 44), 3),
    "EVSNN": ("EVSNN", {"num_bins": B}, (2, 2, 48, 40), 3),
    "PAEVSNN": ("PAEVSNN", {"num_bins": B}, (2, 2, 48, 40), 3),
}
SNN_LIF_CALLS = 9  # LIF firings a bin: the residual block fires its membrane twice


def exchanges(key, t):
    """The collectives a rank's forward makes beyond its halos, T steps:
    SPADE's three bootstrap extremes, EITR's 21 token gathers (9 encoder
    self-attentions, 6 decoder self- and 6 cross-attentions), the SNNs' input
    norm, and PAEVSNN's 8 adaptive leaks a bin (a max and a mean each)."""
    return {"SPADE-E2VID": {"group_extremes": 3 * t}, "EITR": {"token_gathers": 21 * t},
            "EVSNN": {"group_sums": t},
            "PAEVSNN": {"group_sums": t + 8 * B * t, "group_extremes": 8 * B * t}}[key]


def seeded_state(model, seed):
    """The model's state dict from a numpy seed: kernels a fan-in-scaled
    normal, norm scales around 1 (so the spiking units fire), biases around
    0, running means around 0 and variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if not v.is_floating_point():
            out[k] = v
        elif v.ndim > 1:
            out[k] = rng.normal(size=shape) / np.sqrt(np.prod(shape[1:]))
        elif k.endswith("running_var"):
            out[k] = rng.uniform(0.5, 1.5, size=shape)
        else:
            out[k] = (1.0 if k.endswith(".weight") else 0.0) + 0.1 * rng.normal(size=shape)
        if isinstance(out[k], np.ndarray):
            out[k] = torch.from_numpy(out[k].astype(np.float32))
    return out


def _checkpoint(folder, key, name, cfg, state):
    """The state dict in the dialect the JAX package's loader reads for the
    family (SPADE: the generator's, bare; EITR: a template; SNNs: bare)."""
    if name == "SPADEE2VID":
        path, obj = folder / "SPADE_E2VID.pth", {k.removeprefix("generator."): v
                                                 for k, v in state.items()}
    elif name == "EITR":
        path, obj = folder / "eitr.pth", {"arch": "EITR", "state_dict": state,
                                          "config": {"arch": {"args": {"eitr_kwargs": cfg}}}}
    else:
        path, obj = folder / f"{name}_SNN.pth", state
    torch.save(obj, path)
    return str(path)


def _collective_inputs(rng):
    """A (2, 3, 10, 4) map whose extremes tie across bands (3, 3, 2, 2 rows):
    sample 0 channel 0's max on ranks 0 and 2 only, sample 1 channel 2's
    twice on rank 3, the whole map's min on ranks 1 and 3; zeros for
    legacy_norm to skip; the ranks' loss weights."""
    x = rng.normal(size=(2, 3, 10, 4)).astype(np.float32)
    x[x == 0] = 0.5
    x[0, 0, 1, 2] = x[0, 0, 7, 0] = 9.0
    x[1, 2, 8, 1] = x[1, 2, 9, 3] = 7.0
    x[0, 1, 4, 0] = x[1, 0, 9, 2] = -8.0
    x[:, :, 5, :2] = 0.0
    tokens = rng.normal(size=(2, 20, 5)).astype(np.float32)
    weights = {"max": rng.normal(size=(RANKS, 2, 3)), "min": rng.normal(size=(RANKS,)),
               "mean": rng.normal(size=(RANKS, 2, 3)), "norm": rng.normal(size=(RANKS,) + x.shape),
               "tokens": rng.normal(size=(RANKS,) + tokens.shape)}
    return {"x": torch.from_numpy(x), "tokens": torch.from_numpy(tokens),
            "weights": {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in weights.items()}}


def _inputs(work, rng):
    """Every case's inputs on disk, and what this process keeps of them."""
    for case in FAMILY_CASES:
        (work / case).mkdir()
    kept = {"collectives": _collective_inputs(rng)}
    torch.save(kept["collectives"], work / "collectives" / "data.pt")
    for case in ("families", "families_train"):
        (work / case / "keys.json").write_text(json.dumps(list(FAMILIES)))
    for seed, (key, (name, cfg, (t, n, h, w), _)) in enumerate(FAMILIES.items()):
        state = seeded_state(build_model(name, cfg, device="cpu"), 60 + seed)
        voxels = rng.normal(size=(t, n, h, w, B)).astype(np.float32)
        frames = rng.uniform(size=(t, n, h, w, 1)).astype(np.float32)
        for case in ("families", "families_train"):
            torch.save(state, work / case / f"{key}.pt")
            (work / case / f"{key}.json").write_text(json.dumps({"name": name, "config": cfg}))
        torch.save(nchw(voxels), work / "families" / f"{key}_voxels.pt")
        torch.save({"voxels": nchw(voxels), "frames": nchw(frames)},
                   work / "families_train" / f"{key}_batch.pt")
        kept[key] = {"state": state, "voxels": voxels, "frames": frames,
                     "checkpoint": _checkpoint(work, key, name, cfg, state)}
    return kept


def _jax_forward(key, kept, spatial=None):
    """JAX's images (T, N, H, W, 1) of the family through ``run_sequence``;
    with ``spatial``, the voxels' rows sharded over that many CPU devices."""
    with flax_init_by_shape():  # the loader overwrites every tensor of the init
        spec = jax_load(kept["checkpoint"])
    voxels = jnp.asarray(kept["voxels"])
    state0 = spec.module.initial_state(*voxels.shape[1:4])

    def fwd(params, v):
        return jax_run_sequence(spec.module, params, v, state0)[0]

    if spatial is None:
        return np.asarray(jax.jit(fwd)(spec.params, voxels))
    mesh = jax_make_mesh(1, spatial)
    with mesh:
        return np.asarray(jax.jit(fwd)(spec.params,
                                       jax.device_put(voxels, jax_spatial_sharding(mesh, 5, 1, 2))))


def _port(key, state, train=False):
    name, cfg, _, _ = FAMILIES[key]
    model = build_model(name, cfg, device="cpu", train=train)
    model.load_state_dict(state)
    return model


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The group's results and the references: {"got": {case: [rank
    results]}, "jax": {key: images}, "kept": ...}."""
    work = tmp_path_factory.mktemp("spatial_families")
    kept = _inputs(work, np.random.default_rng(26))
    ranks = start_group(work, cases=FAMILY_CASES)
    try:  # the JAX references while the ranks run
        ref = {key: _jax_forward(key, kept[key]) for key in FAMILIES}
        ref["EITR-sharded"] = _jax_forward("EITR", kept["EITR"], spatial=RANKS)
    finally:
        wait(ranks)
    got = {case: [torch.load(work / case / f"rank{r}.pt", weights_only=False)
                  for r in range(RANKS)] for case in FAMILY_CASES}
    return {"got": got, "jax": ref, "kept": kept}


@pytest.mark.parametrize("name,cfg,levels",
                         [v[:2] + v[3:] for v in FAMILIES.values()]
                         + [("BDE2VID", {}, 3), ("E2VIDRecurrent", {"num_bins": B}, 4),
                            ("FireNet", {"num_bins": B}, 0)])
def test_model_levels_are_what_each_model_declares(name, cfg, levels):
    assert model_levels(build_model(name, cfg, device="cpu")) == levels


@pytest.mark.parametrize("height", [40, 44, 184, 720])
def test_spade_nearest_resize_of_a_band_is_the_band_of_the_resize(height):
    """SPADE resizes the level-0 previous prediction to each up block's map:
    on the plan's bands (2 levels over 4 ranks, uneven where they must be)
    the band's resize to the level-1 and level-0 band is the whole map's
    resize cut to that band, so no row crosses a band."""
    x = torch.arange(2 * height * 12, dtype=torch.float32).reshape(1, 2, height, 12)
    plan = RowPlan(height, 2, RANKS)
    for level in (1, 0):
        whole = resize_nearest_torch(x, plan.height(level), 12)
        for r in range(RANKS):
            rows = plan.rows(level)[r]
            band = resize_nearest_torch(shard_rows(x, plan, r), rows, 12)
            assert torch.equal(band, shard_rows(whole, plan, r, level))


def test_group_max_and_min_split_ties_over_the_group_as_amax(group):
    data = group["kept"]["collectives"]
    w = data["weights"]
    x = data["x"].clone().requires_grad_()
    sum((x.amax((2, 3)) * w["max"][r]).sum() + x.amin() * w["min"][r]
        for r in range(RANKS)).backward()
    # torch.amax's split: each of two tied maxima (on ranks 0 and 2) takes
    # half of the ranks' summed weight
    half = w["max"][:, 0, 0].sum() / 2
    torch.testing.assert_close(x.grad[0, 0, [1, 7], [2, 0]], half.expand(2), rtol=0, atol=1e-6)
    full = _reductions_grad(data)  # the same loss with the mean and norm terms
    plan = RowPlan(10, 0, RANKS)
    for r, res in enumerate(group["got"]["collectives"]):
        torch.testing.assert_close(res["out"]["max"], x.amax((2, 3)).detach(), rtol=0, atol=0)
        torch.testing.assert_close(res["out"]["min"], x.amin().detach(), rtol=0, atol=0)
        assert res["counts"]["group_extremes"] == 2
        torch.testing.assert_close(res["grad"], shard_rows(full, plan, r), rtol=0, atol=1e-6)


def _reductions_grad(data):
    """The gradient of the ranks' summed loss of the collectives case,
    taken on the whole map."""
    w = data["weights"]
    x = data["x"].clone().requires_grad_()
    normed = legacy_norm(x, unbiased=True, batched=True)
    loss = sum((x.amax((2, 3)) * w["max"][r]).sum() + x.amin() * w["min"][r]
               + (x.mean((2, 3)) * w["mean"][r]).sum() for r in range(RANKS))
    plan = RowPlan(10, 0, RANKS)
    loss = loss + sum((shard_rows(normed, plan, r) * shard_rows(w["norm"][r], plan, r)).sum()
                      for r in range(RANKS))
    loss.backward()
    return x.grad


def test_group_mean_and_legacy_norm_take_the_whole_map(group):
    data = group["kept"]["collectives"]
    x = data["x"]
    normed = legacy_norm(x, unbiased=True, batched=True)
    plan = RowPlan(10, 0, RANKS)
    for r, res in enumerate(group["got"]["collectives"]):
        torch.testing.assert_close(res["out"]["mean"], x.mean((2, 3)), rtol=0, atol=1e-6)
        torch.testing.assert_close(res["out"]["norm"], shard_rows(normed, plan, r), rtol=0,
                                   atol=1e-6)
        assert res["counts"]["group_sums"] == 2  # the mean, the norm's three sums at once


def test_all_tokens_gradient_is_the_sum_over_every_rank(group):
    """Each rank's loss reads every rank's tokens: a band's gradient is the
    sum over the ranks' losses (a copy kept per rank would be 1/4 of it)."""
    data = group["kept"]["collectives"]
    tokens = data["tokens"].clone().requires_grad_()
    sum((tokens * data["weights"]["tokens"][r]).tanh().sum() for r in range(RANKS)).backward()
    starts = [0, 6, 12, 16, 20]  # bands of 3, 3, 2, 2 rows, two tokens a row
    for r, res in enumerate(group["got"]["collectives"]):
        torch.testing.assert_close(res["out"]["tokens"], data["tokens"], rtol=0, atol=0)
        torch.testing.assert_close(res["tokens_grad"], tokens.grad[:, starts[r]:starts[r + 1]],
                                   rtol=0, atol=1e-6)
        assert res["counts"]["token_gathers"] == 1


def _fire_share(spikes):
    fired = [torch.zeros_like(spikes[k]) for k in range(SNN_LIF_CALLS)]
    for k, spike in enumerate(spikes):
        fired[k % SNN_LIF_CALLS] |= spike
    return sum(int(f.sum()) for f in fired) / sum(f.numel() for f in fired)


@pytest.mark.parametrize("key", list(FAMILIES))
def test_spatial_forward_matches_the_unsharded_forward_and_jax(group, key):
    _, _, (t, n, h, w), _ = FAMILIES[key]
    kept = group["kept"][key]
    results = group["got"]["families"]
    for res in results[1:]:  # every rank returns every row
        torch.testing.assert_close(res[key]["images"], results[0][key]["images"], rtol=0, atol=0)
    got = results[0][key]["images"]
    assert got.shape == (t, n, 1, h, w) and torch.isfinite(got).all()
    model = _port(key, kept["state"]).eval()
    with recorded_spikes() as spikes, torch.no_grad():
        want = run_sequence(model, nchw(kept["voxels"]), model.initial_state(n, h, w))[0]
    assert (got - want).abs().max().item() <= 1e-5
    np.testing.assert_allclose(got.numpy(), np.moveaxis(group["jax"][key], -1, 2), atol=2e-4,
                               rtol=0)
    for res in results:
        counts = res[key]["counts"]
        assert {k: counts.get(k, 0) for k in exchanges(key, t)} == exchanges(key, t)
        assert counts["halo_exchanges"] > 0
    if key in ("EVSNN", "PAEVSNN"):  # the units fire, and the bands fire as the whole map
        assert len(spikes) == t * B * SNN_LIF_CALLS and _fire_share(spikes) >= 0.01
        for k, spike in enumerate(spikes):
            bands = torch.cat([res[key]["spikes"][k] for res in results], dim=2)
            assert bands.shape == spike.shape
            assert torch.equal(bands, spike), f"LIF firing {k}: flipped spikes"


def test_eitr_matches_jax_row_sharded_run(group):
    got = group["got"]["families"][0]["EITR"]["images"]
    np.testing.assert_allclose(got.numpy(), np.moveaxis(group["jax"]["EITR-sharded"], -1, 2),
                               atol=2e-4, rtol=0)


@pytest.mark.parametrize("key", list(FAMILIES))
def test_row_sharded_train_step_matches_the_unsharded_step(group, key):
    results = [g[key] for g in group["got"]["families_train"]]
    for res in results[1:]:  # the ranks' weights stay bit-equal
        for k, v in res["state"].items():
            assert torch.equal(v, results[0]["state"][k]), k
    res = results[0]
    kept = group["kept"][key]
    model = _port(key, kept["state"], train=True)
    optimizer = torch.optim.SGD(model.parameters(), lr=1e-2)
    loss = float(train_step(model, optimizer, SequenceLossComputer([{"type": "L1Loss"}]),
                            nchw(kept["voxels"]), nchw(kept["frames"]))["loss"])
    grads = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    assert abs(res["loss"] - loss) <= 1e-5 * abs(loss)
    assert res["grads"].keys() == grads.keys()
    diff = sum((res["grads"][k] - g).square().sum() for k, g in grads.items())
    assert (diff / sum(g.square().sum() for g in grads.values())).sqrt() <= 1e-4
    for k, v in model.state_dict().items():
        if v.is_floating_point():
            np.testing.assert_allclose(res["state"][k].numpy(), v.numpy(), atol=1e-5, rtol=1e-5,
                                       err_msg=k)
