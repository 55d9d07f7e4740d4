"""The port's separable warp (kernels #7 and #8) against the JAX package on
the CPU: the guard decision of both forms, the plain row-anchored sample
(the `separable` backend, and the plain version of the CUDA forward that
its wrapper runs for CPU tensors), its splat (the plain version of the
CUDA backward), the autograd Function and the warp dispatch.

Tolerances: the guard decision is compared exactly. In the domain the
anchored sample is held to JAX's separable_bilinear_sample and its
interpret-mode Pallas kernel at atol 1e-6 on values in [0, 1] (the same
taps and tent weights; the JAX matmuls may fuse a multiply-add, one
rounding apart); the splat to _sep_bwd and to jax.grad of the pure form
at atol 1e-5 (sums of up to a few dozen taps a source pixel, in another
order). Out of the domain both sides are the exact gather: the port's
guarded output equals its plain gather bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mine_tpu.kernels import warp_sep as jks
from mine_tpu.ops import warp_separable as jws
from mine_tpu_torch import geometry, kernels
from mine_tpu_torch.config import CONFIG_DIR, load_config, \
    mpi_config_from_dict
from mine_tpu_torch.kernels import warp as kwarp
from mine_tpu_torch.kernels import warp_sep
from mine_tpu_torch.ops import warp, warp_separable

VALUE_TOL = dict(rtol=0.0, atol=1e-6)
SPLAT_TOL = dict(rtol=0.0, atol=1e-5)
H = W = 64
BP = 4


def _rot_z(angle):
    c, s = np.cos(angle), np.sin(angle)
    return torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]],
                        dtype=torch.float32)


def _coords(roll=0.0, tz=0.0, h=H, w=W, ty=-0.02):
    """Source coords of BP planes (disparities 1..1/4) under one pose:
    a small translation (`ty` vertically), a roll of `roll` rad
    (row-varying cy: the separability error) and a forward move `tz` (a
    zoom: the anchors' block span grows past a narrow band; a backward
    move zooms out)."""
    K = torch.from_numpy(geometry.intrinsics_from_fov(h, w))[None].expand(
        BP, 3, 3)
    G = torch.eye(4).repeat(BP, 1, 1)
    G[:, :3, :3] = _rot_z(roll)
    G[:, :3, 3] = torch.tensor([0.03, ty, tz])
    x, y, _ = warp.warp_coords(torch.linspace(1.0, 4.0, BP), G,
                               torch.linalg.inv(K), K,
                               geometry.cached_pixel_grid(h, w), (h, w))
    return x.contiguous(), y.contiguous()


POSES = {"translation": (0.0, 0.0), "roll": (0.02, 0.0),
         "zoom": (0.0, 0.5), "strong zoom": (0.0, 0.85),
         "roll and zoom": (0.05, 0.5)}


def test_guard_decision_equals_jax_for_both_forms():
    """Translation, rotation-heavy and band-overflowing poses at two bands
    and two tolerances, and heights that are no multiple of the 8-row
    block: the port's decision of the pure form equals
    mine_tpu.ops.warp_separable.guard_ok, that of the kernel form
    mine_tpu.kernels.warp_sep.guard_ok, every time."""
    seen = {"pure": set(), "kernel": set()}
    cases = [(kind, band, tol, (H, W)) for kind in POSES for band in (16, 48)
             for tol in (0.5, 2.0)]
    cases += [("translation", 48, 0.5, (60, W)), ("zoom", 16, 2.0, (60, W))]
    for kind, band, tol, (h, w) in cases:
        _, cy = _coords(*POSES[kind], h=h, w=w)
        cyj = jnp.asarray(cy.numpy())
        for src_h in (h, 60):
            shape = (BP, 7, src_h, w)
            pure = warp_separable.guard_ok(shape, cy, band, sep_tol=tol)
            kern, _ = warp_sep.guard_ok(shape, cy, band, sep_tol=tol)
            assert pure.dtype == torch.bool and pure.shape == ()
            assert bool(pure) == bool(jws.guard_ok(shape, cyj, band,
                                                   sep_tol=tol)), \
                (kind, band, tol, shape)
            assert bool(kern) == bool(jks.guard_ok(shape, cyj, band,
                                                   sep_tol=tol)), \
                (kind, band, tol, shape)
            seen["pure"].add(bool(pure))
            seen["kernel"].add(bool(kern))
    nan_cy = cy.clone()
    nan_cy[0, 0, 0] = float("nan")
    assert not bool(warp_separable.guard_ok((BP, 7, H, W), nan_cy, 48))
    assert seen == {"pure": {True, False}, "kernel": {True, False}}
    # the forms differ where the TPU kernel's band alignment costs rows
    _, cy = _coords(*POSES["zoom"])
    assert bool(warp_separable.guard_ok((BP, 7, H, W), cy, 16))
    assert not bool(warp_sep.guard_ok((BP, 7, H, W), cy, 16)[0])


@pytest.fixture(scope="module")
def src():
    return np.random.RandomState(1).uniform(size=(BP, 7, H, W)).astype(
        np.float32)


@pytest.mark.parametrize("kind", ["translation", "zoom"])
def test_anchored_sample_matches_jax_separable_and_pallas_kernel(src, kind):
    cx, cy = _coords(*POSES[kind])
    band = 48
    ok, anchor = warp_sep.guard_ok(src.shape, cy, band)
    assert bool(ok)
    kernels.reset_launches()
    got = warp_sep.separable_sample(torch.from_numpy(src), cx, cy, anchor,
                                    ok).numpy()
    assert kernels.LAUNCHES["separable_sample"] == 0  # CPU: plain version
    pure, pure_ok = warp_separable.separable_bilinear_sample_guarded(
        torch.from_numpy(src), cx, cy, band=band)
    assert bool(pure_ok)
    np.testing.assert_array_equal(pure.numpy(), got)
    args = (jnp.asarray(src), jnp.asarray(cx.numpy()), jnp.asarray(cy.numpy()))
    np.testing.assert_allclose(got, np.asarray(
        jws.separable_bilinear_sample(*args, band=band)), **VALUE_TOL)
    np.testing.assert_allclose(got, np.asarray(
        jks.pallas_sep_bilinear_sample(*args, band=band, interpret=True)),
        **VALUE_TOL)
    # a translation pose is the gather's sample, to the tent's rounding
    np.testing.assert_allclose(got, warp.bilinear_sample(
        torch.from_numpy(src), cx, cy).numpy(),
        atol=1e-6 if kind == "translation" else 0.05)


def test_out_of_domain_is_the_exact_gather_and_its_splat(src):
    cx, cy = _coords(*POSES["roll and zoom"])
    s = torch.from_numpy(src)
    ok, anchor = warp_sep.guard_ok(src.shape, cy, 48)
    assert not bool(ok)
    gather = warp.bilinear_sample(s, cx, cy).numpy()
    np.testing.assert_array_equal(
        warp_sep.separable_sample(s, cx, cy, anchor, ok).numpy(), gather)
    out, pure_ok = warp_separable.separable_bilinear_sample_guarded(
        s, cx, cy, band=48)
    assert not bool(pure_ok)
    np.testing.assert_array_equal(out.numpy(), gather)
    g = torch.from_numpy(np.random.RandomState(2).normal(
        size=src.shape).astype(np.float32))
    np.testing.assert_array_equal(
        warp_sep.separable_splat(g, cx, cy, anchor, ok, (H, W)).numpy(),
        kwarp.bilinear_splat_plain(g, cx, cy, (H, W)).numpy())
    jout = jks.separable_sample_diff_guarded(
        jnp.asarray(src), jnp.asarray(cx.numpy()), jnp.asarray(cy.numpy()),
        band=48, interpret=True)
    np.testing.assert_allclose(gather, np.asarray(jout), **VALUE_TOL)


# anchored splat cases (roll, tz, ty): a zoom-in whose top and bottom
# rows clamp onto the border rows; a zoom-out, where up to 5 target rows
# read one source row and neighbouring rows share their source rows; a
# move that pushes the lower target rows past the bottom (lo == hi ==
# H_s-1, both of a row's taps on one source row)
SPLAT_POSES = {"zoom": POSES["zoom"] + (-0.02,),
               "zoom out": (0.0, -0.8, -0.02),
               "past the bottom": (0.0, 0.0, -0.5)}


@pytest.mark.parametrize("kind", list(SPLAT_POSES))
def test_splat_matches_jax_sep_bwd_and_grad_of_the_pure_form(src, kind):
    roll, tz, ty = SPLAT_POSES[kind]
    cx, cy = _coords(roll, tz, ty=ty)
    ok, anchor = warp_sep.guard_ok(src.shape, cy, 48)
    assert bool(ok)
    lo = torch.floor(warp.clamp_coords(anchor, H))
    rows_per_src = torch.stack([torch.bincount(r.long(), minlength=H)
                                for r in lo])
    assert rows_per_src.max() >= 2  # target rows that share a source row
    if kind == "past the bottom":
        assert (anchor >= H - 1).sum() >= 8
    g = np.random.RandomState(3).normal(size=src.shape).astype(np.float32)
    kernels.reset_launches()
    got = warp_sep.separable_splat(torch.from_numpy(g), cx, cy, anchor, ok,
                                   (H, W)).numpy()
    assert kernels.LAUNCHES["separable_splat"] == 0
    cxj, cyj = jnp.asarray(cx.numpy()), jnp.asarray(cy.numpy())
    want = jks._sep_bwd(jnp.asarray(g), cxj, cyj, src_shape=src.shape,
                        band=48, rows_per_block=8, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **SPLAT_TOL)
    grad = jax.grad(lambda s: jnp.sum(jws.separable_bilinear_sample(
        s, cxj, cyj, band=48) * g))(jnp.asarray(src))
    np.testing.assert_allclose(got, np.asarray(grad), **SPLAT_TOL)
    # the splat is the adjoint of the port's own anchored sample
    s = torch.from_numpy(src).requires_grad_(True)
    (warp_separable.anchored_sample(s, cx, anchor)
     * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got, s.grad.numpy(), **SPLAT_TOL)


@pytest.mark.parametrize("kind", ["translation", "roll and zoom"])
def test_separable_sample_diff_gradient_is_autograd_of_the_guarded_form(
        src, kind):
    """The autograd Function (plain versions on the CPU) against autograd
    through the plain `separable` backend, in and out of the domain."""
    cx, cy = _coords(*POSES[kind])
    w = torch.from_numpy(np.random.RandomState(4).normal(
        size=src.shape).astype(np.float32))
    a = torch.from_numpy(src).requires_grad_(True)
    b = torch.from_numpy(src).requires_grad_(True)
    out_a, ok_a = warp_sep.separable_sample_diff(a, cx, cy, band=48)
    out_b, ok_b = warp_separable.separable_bilinear_sample_guarded(
        b, cx, cy, band=48)
    assert bool(ok_a) == bool(ok_b) == (kind == "translation")
    np.testing.assert_array_equal(out_a.detach().numpy(),
                                  out_b.detach().numpy())
    (out_a * w).sum().backward()
    (out_b * w).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), **SPLAT_TOL)


@pytest.mark.parametrize("impl", ["separable", "pallas_sep"])
def test_homography_warp_reports_the_guard_as_in_domain(src, impl):
    K = torch.from_numpy(geometry.intrinsics_from_fov(H, W))[None].expand(
        BP, 3, 3)
    d = torch.linspace(1.0, 4.0, BP)
    for roll, want in ((0.0, 1.0), (0.05, 0.0)):
        G = torch.eye(4).repeat(BP, 1, 1)
        G[:, :3, :3] = _rot_z(roll)
        G[:, :3, 3] = torch.tensor([0.03, -0.02, 0.0])
        tgt, valid, in_domain = warp.homography_warp(
            torch.from_numpy(src), d, G, torch.linalg.inv(K), K,
            geometry.cached_pixel_grid(H, W), impl=impl, band=48,
            sep_tol=0.5)
        assert float(in_domain) == want and tgt.shape == src.shape
        ref, _, _ = warp.homography_warp(
            torch.from_numpy(src), d, G, torch.linalg.inv(K), K,
            geometry.cached_pixel_grid(H, W), impl="xla")
        np.testing.assert_allclose(tgt.numpy(), ref.numpy(),
                                   atol=1e-6 if want else 0.0)


def test_config_accepts_the_separable_backends():
    llff = CONFIG_DIR + "/params_llff.yaml"
    for backend in ("separable", "pallas_sep"):
        cfg = mpi_config_from_dict(load_config(llff, {
            "training.warp_backend": backend,
            "training.warp_sep_tol": 0.25, "training.warp_band": 32}),
            device="cpu")
        assert (cfg.warp_backend, cfg.warp_sep_tol, cfg.warp_band) == \
            (backend, 0.25, 32)
    for key, value, match in (
            ("training.warp_sep_tol", -0.1, ">= 0"),
            ("training.warp_backend", "xla_banded", "not ported yet"),
            ("training.warp_backend", "pallas_fused", "not ported yet"),
            ("training.warp_dtype", "bfloat16", "not ported yet")):
        with pytest.raises(ValueError, match=match):
            mpi_config_from_dict(load_config(llff, {key: value}),
                                 device="cpu")
