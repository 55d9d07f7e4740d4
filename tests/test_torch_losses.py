"""The training slice's kernels and losses on the CPU against the JAX
package: the plain versions of the two backward kernels (the splat #5 and
the composite backward #6) against jax.grad of the XLA paths and against
the Pallas backward kernels in interpret mode; the autograd Functions
inside the target render; every loss function and the sparse-point
helpers.

Tolerances: the splat as tests/test_warp_vjp.py (rtol 1e-4 / atol 1e-4);
the composite backward as tests/test_composite_vjp.py (rtol 2e-3 /
atol 2e-4); the loss functions float32 on both sides, rtol 1e-5 /
atol 1e-6 (SSIM and the instance-normalized smoothness reduce in another
order: rtol 1e-5 / atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mine_tpu import geometry as jgeo
from mine_tpu import losses as jlosses
from mine_tpu.kernels.composite_vjp import _composite_bwd
from mine_tpu.losses.ssim import ssim as jssim_fn
from mine_tpu.kernels.warp_vjp import _warp_bwd
from mine_tpu.ops import rendering as jrender
from mine_tpu.ops import sampling as jsampling
from mine_tpu.ops import warp as jwarp
from mine_tpu.train import loss as jloss
from mine_tpu_torch import losses as tlosses
from mine_tpu_torch.kernels import composite, warp
from mine_tpu_torch.ops import rendering as trender
from mine_tpu_torch.ops import sampling as tsampling
from mine_tpu_torch.train import loss as tloss
from tests.kernel_test_utils import interpret
from tests.test_kernels import _volume as jax_volume
from tests.test_torch_kernel_wrappers import SPLAT_CASES, splat_coords

SPLAT_TOL = dict(rtol=1e-4, atol=1e-4)
BWD_TOL = dict(rtol=2e-3, atol=2e-4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol,
                               err_msg=msg)


# ---------------- (a) #5 the splat ----------------

def _mild_coords(rng, Bp, H, W):
    """Translation-dominated coords (the training regime, in band)."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    x = xx[None] + rng.uniform(-4, 4, (Bp, 1, 1)).astype(np.float32) \
        + 0.02 * yy[None]
    y = yy[None] + rng.uniform(-3, 3, (Bp, 1, 1)).astype(np.float32) \
        + 0.03 * xx[None]
    return x.astype(np.float32), y.astype(np.float32)


@pytest.mark.parametrize("kind", SPLAT_CASES)
def test_splat_is_jax_grad_of_the_gather_border_included(kind):
    """The plain splat == jax.grad of the XLA gather w.r.t. src, at any
    coordinates: out of the image, on exact borders and integers, ragged
    target tiles, a source of another size, a 3x zoom-out, far outside
    (the coordinate sets the CUDA splat is held to on the card). A NaN
    coordinate reads pixel 0 in the port (JAX's gather gives NaN there),
    so JAX is given 0 in its place."""
    rng = np.random.RandomState(0)
    (H, W), cx, cy = splat_coords(kind)
    Bp, C = cx.shape[0], 5
    src = rng.normal(size=(Bp, C, H, W)).astype(np.float32)
    cot = rng.normal(size=(Bp, C) + cx.shape[1:]).astype(np.float32)
    jx, jy = (jnp.asarray(np.where(np.isnan(c), 0.0, c)) for c in (cx, cy))
    want = jax.grad(lambda s: jnp.sum(jwarp.bilinear_sample(s, jx, jy)
                                      * cot))(jnp.asarray(src))
    got = warp.bilinear_splat_plain(_t(cot), _t(cx), _t(cy), (H, W))
    _close(got, want, SPLAT_TOL)
    # the wrapper takes the plain version for CPU tensors
    _close(warp.bilinear_splat(_t(cot), _t(cx), _t(cy), (H, W)), want,
           SPLAT_TOL)


def test_splat_matches_pallas_warp_bwd_in_band():
    rng = np.random.RandomState(1)
    Bp, C, H, W = 2, 5, 32, 48
    x, y = _mild_coords(rng, Bp, H, W)
    cot = rng.normal(size=(Bp, C, H, W)).astype(np.float32)
    want = _warp_bwd(jnp.asarray(cot), jnp.asarray(x), jnp.asarray(y),
                     src_shape=(Bp, C, H, W), band=24, rows_per_block=8,
                     interpret=interpret())
    _close(warp.bilinear_splat_plain(_t(cot), _t(x), _t(y), (H, W)), want,
           SPLAT_TOL)


def test_sample_diff_gradient_goes_to_src_only():
    rng = np.random.RandomState(2)
    src = torch.from_numpy(rng.normal(size=(2, 3, 8, 9)).astype(np.float32))
    src.requires_grad_(True)
    cx = torch.from_numpy(rng.uniform(-1, 9, (2, 5, 6)).astype(np.float32))
    cy = torch.from_numpy(rng.uniform(-1, 8, (2, 5, 6)).astype(np.float32))
    cx.requires_grad_(True)
    out = warp.bilinear_sample_diff(src, cx, cy)
    out.sum().backward()
    assert src.grad is not None and cx.grad is None
    _close(out.detach(), jwarp.bilinear_sample(
        jnp.asarray(src.detach().numpy()), jnp.asarray(cx.detach().numpy()),
        jnp.asarray(cy.numpy())), dict(rtol=1e-5, atol=1e-6))


# ---------------- (b) #6 the composite backward ----------------

def _xla_loss(rgb, sigma, xyz, z_mask, bg_inf, g_rgb, g_depth):
    if z_mask:
        sigma = jnp.where(xyz[:, :, 2:3] >= 0.0, sigma, 0.0)
    out_rgb, out_depth, _, _ = jrender.plane_volume_rendering(
        rgb, sigma, xyz, bg_inf)
    return jnp.sum(out_rgb * g_rgb) + jnp.sum(out_depth * g_depth)


@pytest.mark.parametrize("bg_inf", [False, True])
@pytest.mark.parametrize("z_mask", [False, True])
def test_composite_bwd_matches_jax_grad_and_pallas_kernel(bg_inf, z_mask):
    rgb, sigma, xyz = jax_volume(0, B=1, S=4, H=8, W=16)
    if z_mask:
        xyz = xyz.at[:, 1].add(-3.0)  # mixed-sign z on one plane
    rng = np.random.RandomState(1)
    g_rgb = rng.normal(size=(1, 3, 8, 16)).astype(np.float32)
    g_depth = rng.normal(size=(1, 1, 8, 16)).astype(np.float32)
    args = (rgb, sigma, xyz, z_mask, bg_inf, jnp.asarray(g_rgb),
            jnp.asarray(g_depth))
    ref = jax.grad(_xla_loss, argnums=(0, 1, 2))(*args)
    pallas = _composite_bwd(rgb, sigma, xyz, jnp.asarray(g_rgb),
                            jnp.asarray(g_depth), z_mask=z_mask,
                            is_bg_depth_inf=bg_inf, interpret=interpret())
    got = composite.volume_render_bwd(*map(_t, (rgb, sigma, xyz, g_rgb,
                                                g_depth)), z_mask, bg_inf)
    for name, g, r, p in zip(("rgb", "sigma", "xyz"), got, ref, pallas):
        _close(g, r, BWD_TOL, f"{name} vs jax.grad")
        _close(g, p, BWD_TOL, f"{name} vs _composite_bwd")


def test_diff_backends_in_the_target_render_match_jax_grad():
    """render_tgt_rgb_depth(pallas_diff, pallas_diff) — both autograd
    Functions, here on their plain versions — against jax.grad of the JAX
    package's XLA render, w.r.t. the plane rgb and sigma."""
    rng = np.random.RandomState(7)
    B, S, H, W = 2, 4, 8, 16
    rgb = rng.uniform(size=(B, S, 3, H, W)).astype(np.float32)
    sigma = np.abs(rng.normal(size=(B, S, 1, H, W))).astype(np.float32) * 2
    disp = np.sort(rng.uniform(0.2, 1.0, (B, S)))[:, ::-1].astype(np.float32)
    K = np.stack([jgeo.intrinsics_from_fov(H, W)] * B)
    K_inv = np.array(jgeo.inverse_intrinsics(jnp.asarray(K)))
    G = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    G[:, :3, 3] = [[0.05, 0.0, -0.1], [-0.08, 0.02, 0.1]]
    xyz = np.array(jgeo.plane_xyz_tgt(jgeo.plane_xyz_src(
        jgeo.cached_pixel_grid(H, W), jnp.asarray(disp), jnp.asarray(K_inv)),
        jnp.asarray(G)))
    w_rgb = rng.normal(size=(B, 3, H, W)).astype(np.float32)
    w_d = rng.normal(size=(B, 1, H, W)).astype(np.float32)

    def jloss_fn(r, s):
        res = jrender.render_tgt_rgb_depth(
            r, s, jnp.asarray(disp), jnp.asarray(xyz), jnp.asarray(G),
            jnp.asarray(K_inv), jnp.asarray(K), backend="xla",
            warp_impl="xla")
        return jnp.sum(res.rgb * w_rgb) + jnp.sum(res.depth * w_d)

    want = jax.grad(jloss_fn, argnums=(0, 1))(jnp.asarray(rgb),
                                              jnp.asarray(sigma))
    r, s = _t(rgb).requires_grad_(True), _t(sigma).requires_grad_(True)
    res = trender.render_tgt_rgb_depth(
        r, s, *map(_t, (disp, xyz, G, K_inv, K)), backend="pallas_diff",
        warp_impl="pallas_diff")
    ((res.rgb * _t(w_rgb)).sum() + (res.depth * _t(w_d)).sum()).backward()
    _close(r.grad, want[0], BWD_TOL, "rgb")
    _close(s.grad, want[1], BWD_TOL, "sigma")
    assert float(res.warp_in_domain) == 1.0


# ---------------- (c) the loss functions ----------------

@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(3)
    img = rng.uniform(size=(2, 3, 24, 20)).astype(np.float32)
    other = np.clip(img + rng.normal(scale=0.05, size=img.shape), 0, 1
                    ).astype(np.float32)
    disp = rng.uniform(0.1, 1.0, size=(2, 1, 24, 20)).astype(np.float32)
    return img, other, disp


@pytest.mark.parametrize("normalized", [True, False])
def test_sobel_and_image_helpers_match_jax(images, normalized):
    img, _, _ = images
    _close(tlosses.sobel_gradients(_t(img), normalized),
           jlosses.photometric.sobel_gradients(jnp.asarray(img), normalized),
           LOSS_TOL)
    for g, w in zip(tlosses.image_mean_abs_grads(_t(img)),
                    jlosses.image_mean_abs_grads(jnp.asarray(img))):
        _close(g, w, LOSS_TOL)
    for g, w in zip(tlosses.edge_aware_image_masks(_t(img), 0.2),
                    jlosses.edge_aware_image_masks(jnp.asarray(img), 0.2)):
        _close(g, w, LOSS_TOL)


@pytest.mark.parametrize("size_average", [True, False])
def test_photometric_losses_match_jax(images, size_average):
    img, other, disp = images
    tol = dict(rtol=1e-5, atol=1e-5)
    _close(tlosses.psnr(_t(img), _t(other), size_average),
           jlosses.psnr(jnp.asarray(img), jnp.asarray(other), size_average),
           LOSS_TOL)
    _close(tlosses.edge_aware_loss(_t(img), _t(disp), 0.8, 0.2,
                                   size_average),
           jlosses.edge_aware_loss(jnp.asarray(img), jnp.asarray(disp), 0.8,
                                   0.2, size_average), tol)
    _close(tlosses.edge_aware_loss_v2(_t(img), _t(disp), size_average),
           jlosses.edge_aware_loss_v2(jnp.asarray(img), jnp.asarray(disp),
                                      size_average), tol)
    _close(tlosses.ssim(_t(img), _t(other), size_average=size_average),
           jssim_fn(jnp.asarray(img), jnp.asarray(other),
                    size_average=size_average), tol)


def test_ssim_pairs_and_blur_matrices_match_jax(images):
    img, other, _ = images
    from mine_tpu.losses.ssim import _blur_matrix
    from mine_tpu_torch.losses.ssim import _blur_matrix as t_blur_matrix
    for n in (20, 24, 7):
        np.testing.assert_array_equal(t_blur_matrix(n, 11, 1.5),
                                      _blur_matrix(n, 11, 1.5))
    a = np.stack([img, other])
    b = np.stack([other, img[:, :, ::-1].copy()])
    _close(tlosses.ssim_pairs(_t(a), _t(b)),
           jlosses.ssim_pairs(jnp.asarray(a), jnp.asarray(b),
                              precision="highest"),
           dict(rtol=1e-5, atol=1e-5))
    with pytest.raises(ValueError, match="precision"):
        tlosses.ssim_pairs(_t(a), _t(b), precision="bf16")


def test_sparse_point_helpers_match_jax():
    rng = np.random.RandomState(4)
    img = rng.uniform(size=(2, 1, 12, 16)).astype(np.float32)
    pxpy = rng.uniform(-3, 18, size=(2, 2, 30)).astype(np.float32)
    pxpy[0, 0, :4] = [2.5, 3.5, -0.5, 15.5]  # round half to even
    _close(tsampling.gather_pixel_by_pxpy(_t(img), _t(pxpy)),
           jsampling.gather_pixel_by_pxpy(jnp.asarray(img),
                                          jnp.asarray(pxpy)), LOSS_TOL)
    a = rng.uniform(0.1, 2.0, size=(2, 1, 30)).astype(np.float32)
    b = rng.uniform(0.1, 2.0, size=(2, 1, 30)).astype(np.float32)
    _close(tloss.compute_scale_factor(_t(a), _t(b)),
           jloss.compute_scale_factor(jnp.asarray(a), jnp.asarray(b)),
           LOSS_TOL)
    sf = rng.uniform(0.5, 2.0, size=(2,)).astype(np.float32)
    _close(tloss._disp_loss(_t(a), _t(b), _t(sf)),
           jloss._disp_loss(jnp.asarray(a), jnp.asarray(b), jnp.asarray(sf)),
           LOSS_TOL)
    K = np.stack([jgeo.intrinsics_from_fov(12, 16)] * 2)
    pts = rng.uniform(0.5, 3.0, size=(2, 3, 30)).astype(np.float32)
    _close(tloss._project_points(_t(K), _t(pts)),
           jloss._project_points(jnp.asarray(K), jnp.asarray(pts)),
           dict(rtol=1e-5, atol=1e-5))
