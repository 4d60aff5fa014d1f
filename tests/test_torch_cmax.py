"""Port parity of contrast maximization (``events/cmax.py``): the warps, the
blur, the IWE and its analytic derivative, every objective's value and
gradient against ``jax.value_and_grad``, and the BFGS loop recovering a
planted velocity in both packages. CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bde2vid_tpu.events import cmax as jc
from bde2vid_tpu.events.voxel import pad_events
from bde2vid_tpu_torch.events import cmax as tc

SENSOR = (64, 64)
PARAMS = ((0.0, 0.0), (15.0, -8.0), (20.0, -12.0))
TRUE_V = (20.0, -12.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def moving_dot_events(rng, vx=20.0, vy=-12.0, n_per=40, steps=50):
    """A cluster of pixels translating at (vx, vy) px/s over 1 s (the JAX
    package's tests/test_cmax.py set)."""
    xs, ys, ts = [], [], []
    base_x = rng.integers(20, 36, n_per)
    base_y = rng.integers(24, 40, n_per)
    for i in range(steps):
        t = i / (steps - 1)
        xs.append(np.clip(base_x + vx * t + rng.normal(0, 0.2, n_per), 0, 63))
        ys.append(np.clip(base_y + vy * t + rng.normal(0, 0.2, n_per), 0, 63))
        ts.append(np.full(n_per, t))
    xs = np.concatenate(xs).astype(np.float32)
    ys = np.concatenate(ys).astype(np.float32)
    ts = np.concatenate(ts).astype(np.float32)
    ps = np.ones_like(ts)
    order = np.argsort(ts, kind="stable")
    return xs[order], ys[order], ts[order], ps[order]


@pytest.fixture(scope="module")
def dots():
    return moving_dot_events(np.random.default_rng(0))


@pytest.fixture(scope="module")
def padded(dots):
    """The moving dots with mixed polarity, padded: (numpy buffers, n)."""
    xs, ys, ts, ps = dots
    ps = np.where(np.arange(len(ps)) % 3 == 0, -1.0, 1.0).astype(np.float32)
    *bufs, n = pad_events(xs, ys, ts, ps)
    return bufs, n


def tensors(bufs):
    return [torch.from_numpy(b) for b in bufs]


def test_warps_and_bounds_mask_exact(padded):
    (xs, ys, ts, _), _ = padded
    for p in PARAMS:
        got = tc.linvel_warp(*tensors((xs, ys, ts)), torch.tensor(p, dtype=torch.float32), t0=ts[-1])
        ref = jc.linvel_warp(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(ts),
                             jnp.asarray(p, jnp.float32), t0=ts[-1])
        for g, r in zip(got, ref):
            assert np.array_equal(g.numpy(), np.asarray(r))
        mask = tc.events_bounds_mask(*got, 0, SENSOR[1], 0, SENSOR[0])
        ref_mask = jc.events_bounds_mask(*ref, 0, SENSOR[1], 0, SENSOR[0])
        assert np.array_equal(mask.numpy(), np.asarray(ref_mask)) and 0 < mask.sum() < len(xs)
    got = tc.linvel_warp_jacobian(torch.from_numpy(ts), t0=0.5)
    for g, r in zip(got, jc.linvel_warp_jacobian(jnp.asarray(ts), t0=0.5)):
        assert g.shape == (2, len(ts)) and np.array_equal(g.numpy(), np.asarray(r))
    assert tc.LINVEL_DIMS == jc.LINVEL_DIMS


@pytest.mark.parametrize("sigma", [1.0, 2.0])
def test_gaussian_blur(sigma):
    """Within 1e-6 x max(1, max |JAX|): a few f32 roundings of 2r + 1 taps
    summed in another order."""
    img = np.random.default_rng(1).uniform(0, 3, (37, 45)).astype(np.float32)
    planes = np.stack([img, 2 * img[::-1]])
    batched = tc.gaussian_blur(torch.from_numpy(planes), sigma).numpy()
    for got, plane in ((tc.gaussian_blur(torch.from_numpy(img), sigma).numpy(), img),
                       (batched[1], planes[1])):
        ref = np.asarray(jc.gaussian_blur(jnp.asarray(plane), sigma))
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-6 * max(1.0, np.abs(ref).max())
    for sigma in (None, 0):
        assert np.array_equal(tc.gaussian_blur(torch.from_numpy(img), sigma).numpy(), img)


def test_gaussian_blur_pads_symmetric_not_reflect():
    """A bright edge row: numpy's symmetric pad repeats it, torch's reflect
    pad would not; the blur matches JAX's and not the reflect version."""
    img = np.zeros((9, 11), np.float32)
    img[0] = 10.0
    got = tc.gaussian_blur(torch.from_numpy(img), 1.0).numpy()
    ref = np.asarray(jc.gaussian_blur(jnp.asarray(img), 1.0))
    assert np.abs(got - ref).max() <= 1e-6
    r = 4
    k = np.exp(-0.5 * np.arange(-r, r + 1, dtype=np.float32) ** 2)
    k = torch.from_numpy(k / k.sum())
    reflect = F.pad(torch.from_numpy(img)[None, None], (r, r, r, r), mode="reflect")
    reflect = F.conv2d(F.conv2d(reflect, k.view(1, 1, -1, 1)), k.view(1, 1, 1, -1))[0, 0].numpy()
    assert np.abs(reflect - ref).max() > 1.0


@pytest.mark.parametrize("blur", [None, 1.0])
@pytest.mark.parametrize("use_polarity", [True, False])
def test_get_iwe_and_drv(padded, blur, use_polarity):
    bufs, n = padded
    kw = dict(img_size=SENSOR, use_polarity=use_polarity, blur_sigma=blur)
    for p in PARAMS[1:]:
        pt = torch.tensor(p, dtype=torch.float32)
        pj = jnp.asarray(p, jnp.float32)
        iwe = tc.get_iwe(pt, *tensors(bufs), n, **kw).numpy()
        ref = np.asarray(jc.get_iwe(pj, *bufs, n, **kw))
        assert iwe.shape == (SENSOR[0] + 1, SENSOR[1] + 1)
        assert np.abs(iwe - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())
        img, d = tc.get_iwe_drv(pt, *tensors(bufs), n, **kw)
        ref_img, ref_d = jc.get_iwe_drv(pj, *bufs, n, **kw)
        for g, r in ((img, ref_img), (d, ref_d)):
            r = np.asarray(r)
            assert np.abs(g.numpy() - r).max() <= 1e-5 * max(1.0, np.abs(r).max())


def test_analytic_derivative_equals_autograd(padded):
    """get_iwe_drv's planes are the IWE's jacobian with respect to the
    parameters, which autograd computes through get_iwe."""
    bufs, n = padded
    ev = tensors(bufs)
    p = torch.tensor(PARAMS[1], dtype=torch.float32)
    jac = torch.autograd.functional.jacobian(
        lambda q: tc.get_iwe(q, *ev, n, img_size=SENSOR, blur_sigma=1.0), p)  # (H, W, 2)
    _, d = tc.get_iwe_drv(p, *ev, n, img_size=SENSOR, blur_sigma=1.0)
    assert torch.allclose(d, jac.permute(2, 0, 1), atol=1e-5 * max(1.0, d.abs().max().item()))


OBJECTIVE_CASES = [(name, True) for name in jc.OBJECTIVES] + [("sosa", False), ("zhu", True)]


@pytest.mark.parametrize("objective,use_polarity", OBJECTIVE_CASES)
def test_objective_value_and_grad(padded, objective, use_polarity):
    """Value and gradient at three parameter points against
    ``jax.value_and_grad``, within 1e-4 relative."""
    bufs, n = padded
    blur = None if objective == "zhu" else 1.0
    jvg = jc._cached_value_and_grad(objective, SENSOR, use_polarity, blur)
    f = tc.objective_fn(objective, SENSOR, use_polarity, blur)
    ev = tensors(bufs)
    for p in PARAMS:
        v_ref, g_ref = jvg(jnp.asarray(p, jnp.float32), *bufs, n)
        v_ref, g_ref = float(v_ref), np.asarray(g_ref)
        params = torch.tensor(p, dtype=torch.float32, requires_grad=True)
        v = f(params, *ev, n)
        (g,) = torch.autograd.grad(v, params)
        assert abs(v.item() - v_ref) <= 1e-4 * abs(v_ref), (p, v.item(), v_ref)
        assert np.abs(g.numpy() - g_ref).max() <= 1e-4 * max(np.abs(g_ref).max(), 1e-6), (p, g, g_ref)


def test_variance_takes_ddof_0():
    iwe = torch.from_numpy(np.random.default_rng(2).normal(size=(5, 6)).astype(np.float32))
    ref = float(jc.variance_objective(jnp.asarray(iwe.numpy())))
    assert tc.variance_objective(iwe).item() == pytest.approx(ref, rel=1e-6)
    assert abs(-torch.var(iwe).item() - ref) > 1e-2  # torch's default, unbiased


def test_rms_takes_the_spectral_norm():
    iwe = np.random.default_rng(3).normal(size=(7, 9)).astype(np.float32)
    got = tc.rms_objective(torch.from_numpy(iwe)).item()
    assert got == pytest.approx(float(jc.rms_objective(jnp.asarray(iwe))), rel=1e-5)
    assert got == pytest.approx(-np.linalg.norm(iwe, 2) ** 2 / iwe.size, rel=1e-5)


def test_optimize_contrast_recovers_velocity_in_both_packages(dots):
    """The moving-dot set (64x64) from (15, -8): both packages recover (20,
    -12) within 2 px/s; the distance between their estimates is printed."""
    kw = dict(objective="variance", img_size=SENSOR, blur_sigma=2.0, x0=np.array([15.0, -8.0]))
    ours = tc.optimize_contrast(*dots, device="cpu", **kw)
    theirs = jc.optimize_contrast(*dots, **kw)
    for est in (ours, theirs):
        assert np.abs(np.asarray(est) - TRUE_V).max() <= 2.0, est
    print(f"optimize_contrast: port {ours}, JAX {theirs}, distance "
          f"{np.linalg.norm(np.asarray(ours) - np.asarray(theirs))}")
    full = tc.optimize_contrast(*dots, device="cpu", full_output=True, **kw)
    assert np.array_equal(full[0], ours) and full[4] >= 1 and full[5] >= 1


def test_zhu_refuses_use_polarity_false(dots):
    with pytest.raises(ValueError, match="zhu objective ignores use_polarity"):
        tc.optimize_contrast(*dots, objective="zhu", use_polarity=False, device="cpu")


def test_optimize_contrast_refuses_a_missing_card(dots, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tc.optimize_contrast(*dots)
