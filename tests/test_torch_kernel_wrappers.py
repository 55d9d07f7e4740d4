"""The kernel wrappers' contract, and — marked `cuda` — the CUDA kernels
against their plain versions on the card.

This file imports no JAX, so the card's machine (which has none) runs it:
    python -m pytest --noconftest -m cuda tests/test_torch_kernel_wrappers.py
(--noconftest: tests/conftest.py configures JAX).

Tolerances as tests/test_torch_kernels.py: rtol 1e-5 / atol 1e-6 for rgb,
rtol 1e-4 / atol 1e-5 for depth, atol 3e-4 for is_bg_depth_inf depth; the
gather is compared bitwise (same operations in the same order, each
rounded on its own). The backward kernels: the splats at rtol 1e-5 /
atol 1e-6 (float atomics, in shared memory and in device memory, add in
a varying order; every addend is the plain version's), the composite backward
at tests/test_composite_vjp.py's rtol 2e-3 / atol 2e-4 (its chain rule is
hand-derived, the plain version is autograd's), atol 2e-3 on d_sigma and
d_xyz with is_bg_depth_inf (the depth cotangent is scaled by 1000 there).
The render megakernel at the composite's tolerances (its sampling is the
plain gather's bit for bit, its sums run in another order), with its
in-register dequant pinned bitwise to pre-dequantized planes through the
same kernel; the separable sample bitwise (same operations, same order,
both branches), its splat at the gather splat's rtol 1e-5 / atol 1e-6.
"""

import os

import numpy as np
import pytest
import torch

from mine_tpu_torch import kernels
from mine_tpu_torch.kernels import composite, render_fused, warp, warp_sep
from mine_tpu_torch.ops import warp as twarp

RGB_TOL = dict(rtol=1e-5, atol=1e-6)
DEPTH_TOL = dict(rtol=1e-4, atol=1e-5)
BG_DEPTH_TOL = dict(rtol=1e-4, atol=3e-4)


def _volume(seed, B, S, H, W, device="cpu"):
    """rgb in [0,1], sigma >= 0, xyz of planes in front of the camera plus
    noise, a few pixels behind it."""
    g = torch.Generator().manual_seed(seed)
    rgb = torch.rand((B, S, 3, H, W), generator=g)
    sigma = torch.randn((B, S, 1, H, W), generator=g).abs() * 2
    xyz = torch.randn((B, S, 3, H, W), generator=g) * 0.3
    xyz[:, :, 2] += torch.linspace(1.0, 8.0, S)[None, :, None, None]
    xyz[:, :, 2, 0, :3] = -0.5
    return rgb.to(device), sigma.to(device), xyz.to(device)


# The splat's adversarial coordinate sets (numpy, seeded; shared with the
# CPU parity test of the plain splat in tests/test_torch_losses.py): each
# is (source (H_s, W_s), coords_x, coords_y [B',H_t,W_t] f32).
SPLAT_CASES = ("border and integers", "ragged tiles", "zoom-out x3",
               "nan and far", "unaligned rows")


def splat_coords(kind, seed=0):
    """`kind` of SPLAT_CASES:
    - border and integers: random coordinates up to 4 px outside a 10x13
      source, some on exact borders and integers (9x11 target);
    - ragged tiles: a 13x37 target (no multiple of the splat kernel's
      8x32 tile) spread over a 12x20 source with noise, partly outside;
    - zoom-out x3: a 24x64 target zoomed out 3x about the centre of a
      72x192 source: every tile's taps spread past the kernel's shared
      window (its direct route);
    - nan and far: a near-identity 40x96 -> 40x100 map with a few NaN
      coordinates (they read pixel 0) and far-outside ones (+-1e9, inf:
      they clamp onto border pixels), which spread some tiles past the
      window;
    - unaligned rows: a near-identity 16x40 -> 18x42 map (W_s no multiple
      of 4: the kernel's scalar flush)."""
    rng = np.random.RandomState(seed)
    Bp = 3

    def near_identity(h_t, w_t, src_hw, noise):
        yy, xx = np.mgrid[0:h_t, 0:w_t].astype(np.float32)
        sx = (src_hw[1] - 1) / max(w_t - 1, 1)
        sy = (src_hw[0] - 1) / max(h_t - 1, 1)
        cx = xx[None] * sx + rng.uniform(-noise, noise, (Bp, h_t, w_t))
        cy = yy[None] * sy + rng.uniform(-noise, noise, (Bp, h_t, w_t))
        return cx.astype(np.float32), cy.astype(np.float32)

    if kind == "border and integers":
        src_hw = (10, 13)
        cx = rng.uniform(-4, 17, size=(Bp, 9, 11)).astype(np.float32)
        cy = rng.uniform(-4, 14, size=(Bp, 9, 11)).astype(np.float32)
        cx[0, 0, :4] = [0.0, 12.0, 5.0, -0.0]
        cy[0, 1, :3] = [9.0, 0.0, 3.0]
    elif kind == "ragged tiles":
        src_hw = (12, 20)
        cx, cy = near_identity(13, 37, src_hw, 2.5)
    elif kind == "zoom-out x3":
        src_hw = (72, 192)
        yy, xx = np.mgrid[0:24, 0:64].astype(np.float32)
        cx = (xx - 32.0) * 3.0 + 96.0 + rng.uniform(0, 0.5, (Bp, 24, 64))
        cy = (yy - 12.0) * 3.0 + 36.0 + rng.uniform(0, 0.5, (Bp, 24, 64))
    elif kind == "nan and far":
        src_hw = (40, 100)
        cx, cy = near_identity(40, 96, src_hw, 0.45)
        cx[0, 2, 3] = np.nan
        cx[0, 30, 70] = cy[0, 30, 70] = np.nan
        cy[1, 30, 75] = np.nan
        cx[1, 4, 40] = 1e9
        cy[2, 33, 20] = -1e9
        cx[2, 17, 90] = -np.inf
        cx[2, 36, 10], cy[2, 36, 10] = 1e9, -1e9
    elif kind == "unaligned rows":
        src_hw = (18, 42)
        cx, cy = near_identity(16, 40, src_hw, 0.45)
    else:
        raise ValueError(kind)
    return src_hw, cx.astype(np.float32), cy.astype(np.float32)


def test_splat_wide_tiles_follow_the_window_budget():
    """The plain count of the splat kernel's direct-route tiles: none for
    near-identity maps, every tile of the 3x zoom-out, and only the tiles
    that hold a NaN or far-outside coordinate of the NaN case."""
    t = torch.from_numpy
    for kind in ("ragged tiles", "unaligned rows"):
        src_hw, cx, cy = splat_coords(kind)
        assert not warp.splat_wide_tiles(t(cx), t(cy), src_hw).any(), kind
    src_hw, cx, cy = splat_coords("zoom-out x3")
    wide = warp.splat_wide_tiles(t(cx), t(cy), src_hw)
    assert wide.shape == (3, 3, 2) and wide.all()
    src_hw, cx, cy = splat_coords("nan and far")
    wide = warp.splat_wide_tiles(t(cx), t(cy), src_hw)
    assert wide.shape == (3, 5, 3)
    # the tiles of pixels (0, 30, 70), NaN in x and y (it reads pixel 0),
    # and (2, 36, 10), far outside to the top right: their taps span more
    # than 1536 source pixels; the tiles of the other NaN and far pixels
    # (one coordinate each) still fit the window
    assert wide.nonzero().tolist() == [[0, 3, 2], [2, 4, 0]]


def test_wrappers_take_plain_version_only_for_cpu_tensors(monkeypatch):
    """CPU tensors run the plain version (no launch counted); a tensor on
    any other device never reaches it: it goes to the kernel path, which
    checks the device and raises here."""
    calls = []

    def fake_library():
        calls.append(1)
        raise RuntimeError("no kernel library on this machine")

    monkeypatch.setattr(kernels.build, "library", fake_library)
    kernels.reset_launches()
    rgb, sigma, xyz = _volume(8, 1, 3, 4, 8)
    composite.volume_render(rgb, sigma, xyz, z_mask=True)
    composite.src_render_blend(rgb, sigma, xyz, rgb[:, 0])
    composite.volume_render_bwd(rgb, sigma, xyz, rgb[:, 0], sigma[:, 0])
    warp.bilinear_sample(rgb[0], xyz[0, :, 0], xyz[0, :, 1])
    warp.bilinear_splat(rgb[0], xyz[0, :, 0], xyz[0, :, 1], (4, 8))
    vol = torch.cat([rgb, sigma], dim=2)
    render_fused.fused_plane_render(vol, None, xyz, xyz[:, :, 0],
                                    xyz[:, :, 1])
    ok, anchor = warp_sep.guard_ok(rgb[0].shape, xyz[0, :, 1], band=4)
    warp_sep.separable_sample(rgb[0], xyz[0, :, 0], xyz[0, :, 1], anchor, ok)
    warp_sep.separable_splat(rgb[0], xyz[0, :, 0], xyz[0, :, 1], anchor, ok,
                             (4, 8))
    assert kernels.LAUNCHES == {n: 0 for n in kernels.KERNELS}
    assert not calls

    meta = [t.to("meta") for t in (rgb, sigma, xyz)]
    with pytest.raises(ValueError, match="unsupported device"):
        composite.volume_render(*meta)
    with pytest.raises(ValueError, match="unsupported device"):
        composite.src_render_blend(*meta, meta[0][:, 0])
    with pytest.raises(ValueError, match="unsupported device"):
        warp.bilinear_sample(meta[0][0], meta[2][0, :, 0], meta[2][0, :, 1])
    with pytest.raises(ValueError, match="unsupported device"):
        warp.bilinear_splat(meta[0][0], meta[2][0, :, 0], meta[2][0, :, 1],
                            (4, 8))
    with pytest.raises(ValueError, match="unsupported device"):
        composite.volume_render_bwd(*meta, meta[0][:, 0], meta[1][:, 0])
    with pytest.raises(ValueError, match="unsupported device"):
        render_fused.fused_plane_render(vol.to("meta"), None, meta[2],
                                        meta[2][:, :, 0], meta[2][:, :, 1])
    m_ok, m_anchor = ok.to("meta"), anchor.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        warp_sep.separable_sample(meta[0][0], meta[2][0, :, 0],
                                  meta[2][0, :, 1], m_anchor, m_ok)
    with pytest.raises(ValueError, match="unsupported device"):
        warp_sep.separable_splat(meta[0][0], meta[2][0, :, 0],
                                 meta[2][0, :, 1], m_anchor, m_ok, (4, 8))
    assert not calls and kernels.LAUNCHES == {n: 0 for n in kernels.KERNELS}


def test_kernel_table_names_sources_and_pallas_calls():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name, (source, replaces) in kernels.KERNELS.items():
        assert os.path.exists(os.path.join(root, source)), name
        path, line = replaces.split(":")
        with open(os.path.join(root, path)) as f:
            assert "pl.pallas_call(" in f.read().splitlines()[int(line) - 1]


def test_build_is_keyed_by_the_sources(tmp_path, monkeypatch):
    digest = kernels.build.source_hash()
    assert len(digest) == 16
    assert [os.path.basename(p) for p in kernels.build.sources()] == \
        ["composite.cu", "render_fused.cu", "warp.cu", "warp_sep.cu"]
    assert [os.path.basename(p) for p in kernels.build.headers()] == \
        ["block_scan.cuh"]
    for name in kernels.build.SIGNATURES:
        src = "".join(open(p).read() for p in kernels.build.sources())
        assert f'extern "C" int {name}(' in src, name
    # a header the sources include keys the build as a source does
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.build.CSRC_DIR, csrc)
    monkeypatch.setattr(kernels.build, "CSRC_DIR", str(csrc))
    assert kernels.build.source_hash() == digest
    with open(csrc / "block_scan.cuh", "a") as f:
        f.write("\n")
    assert kernels.build.source_hash() != digest


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want, tol):
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **tol)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(cuda_device):
    rgb, sigma, xyz = _volume(9, 2, 5, 12, 20, cuda_device)
    src = torch.rand((2, 3, 12, 20), device=cuda_device)
    kernels.reset_launches()
    for bg in (False, True):
        depth_tol = BG_DEPTH_TOL if bg else DEPTH_TOL
        for z_mask in (True, False):
            got = composite.volume_render(rgb, sigma, xyz, z_mask, bg)
            want = composite.volume_render_plain(rgb, sigma, xyz, z_mask, bg)
            _close(got[0], want[0], RGB_TOL)
            _close(got[1], want[1], depth_tol)
        got = composite.src_render_blend(rgb, sigma, xyz.abs(), src, bg)
        want = composite.src_render_blend_plain(rgb, sigma, xyz.abs(), src,
                                                bg)
        for g, w, tol in zip(got, want, (RGB_TOL, depth_tol, RGB_TOL)):
            _close(g, w, tol)
    vol = rgb.reshape(10, 3, 12, 20)
    cx = torch.rand((10, 9, 17), device=cuda_device) * 24 - 2
    cy = torch.rand((10, 9, 17), device=cuda_device) * 16 - 2
    np.testing.assert_array_equal(
        warp.bilinear_sample(vol, cx, cy).cpu().numpy(),
        twarp.bilinear_sample(vol, cx, cy).cpu().numpy())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == dict(
        {n: 0 for n in kernels.KERNELS}, volume_render=4, src_render_blend=2,
        bilinear_sample=1)


@pytest.mark.cuda
def test_cuda_backward_kernels_match_plain_versions(cuda_device):
    """The splat against the plain scatter-add adjoint, border taps
    included; the composite backward against autograd of the plain
    composite, both depth modes x z-mask, coincident planes included."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    cot = torch.randn((10, 3, 9, 17), generator=g, device=cuda_device)
    cx = torch.rand((10, 9, 17), generator=g, device=cuda_device) * 26 - 3
    cy = torch.rand((10, 9, 17), generator=g, device=cuda_device) * 18 - 3
    cx[0, 0, :3] = torch.tensor([0.0, 19.0, 5.0])
    kernels.reset_launches()
    _close(warp.bilinear_splat(cot, cx, cy, (12, 20)),
           warp.bilinear_splat_plain(cot, cx, cy, (12, 20)),
           dict(rtol=1e-5, atol=1e-6))
    rgb, sigma, xyz = _volume(12, 2, 6, 12, 20, cuda_device)
    xyz[:, 3] = xyz[:, 2]  # coincident planes: unit vector 0, not NaN
    g_rgb = torch.randn((2, 3, 12, 20), generator=g, device=cuda_device)
    g_depth = torch.randn((2, 1, 12, 20), generator=g, device=cuda_device)
    for bg in (False, True):
        for z_mask in (True, False):
            got = composite.volume_render_bwd(rgb, sigma, xyz, g_rgb,
                                              g_depth, z_mask, bg)
            want = composite.volume_render_bwd_plain(rgb, sigma, xyz, g_rgb,
                                                     g_depth, z_mask, bg)
            for name, a, b in zip(("rgb", "sigma", "xyz"), got, want):
                tol = dict(rtol=2e-3, atol=2e-3 if bg and name != "rgb"
                           else 2e-4)
                _close(a, b, tol)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bilinear_splat"] == 1
    assert kernels.LAUNCHES["volume_render_bwd"] == 4


@pytest.mark.cuda
def test_cuda_autograd_functions_match_plain_autograd(cuda_device):
    """bilinear_sample_diff and volume_render_diff: gradients of a loss
    through the kernel pairs against autograd through the plain versions
    on the same card tensors."""
    g = torch.Generator(device=cuda_device).manual_seed(13)
    src = torch.randn((6, 7, 10, 14), generator=g, device=cuda_device)
    cx = torch.rand((6, 10, 14), generator=g, device=cuda_device) * 18 - 2
    cy = torch.rand((6, 10, 14), generator=g, device=cuda_device) * 14 - 2
    a = src.clone().requires_grad_(True)
    b = src.clone().requires_grad_(True)
    (warp.bilinear_sample_diff(a, cx, cy) ** 2).sum().backward()
    (twarp.bilinear_sample(b, cx, cy) ** 2).sum().backward()
    _close(a.grad, b.grad, dict(rtol=1e-5, atol=1e-5))

    vols = _volume(14, 2, 5, 10, 14, cuda_device)
    ka = [t.clone().requires_grad_(True) for t in vols]
    pa = [t.clone().requires_grad_(True) for t in vols]
    rk, dk = composite.volume_render_diff(*ka, True, False)
    rp, dp = composite.volume_render_plain(*pa, True, False)
    ((rk ** 2).sum() + dk.mean()).backward()
    ((rp ** 2).sum() + dp.mean()).backward()
    for k, p in zip(ka, pa):
        _close(k.grad, p.grad, dict(rtol=2e-3, atol=2e-4))


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    rgb, sigma, xyz = _volume(10, 1, 3, 8, 8, cuda_device)
    cx = torch.rand((3, 8, 8), device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        warp.bilinear_sample(rgb[0].double(), cx, cx)
    with pytest.raises(ValueError, match="contiguous"):
        warp.bilinear_sample(rgb[0].transpose(2, 3), cx.transpose(1, 2), cx)
    with pytest.raises(ValueError, match="shape"):
        composite.volume_render(rgb, sigma[:, :2], xyz)
    with pytest.raises(ValueError, match="expected a tensor on"):
        composite.volume_render(rgb, sigma.cpu(), xyz)


@pytest.mark.cuda
def test_cuda_render_megakernel_matches_plain_and_pins_the_dequant(
        cuda_device):
    """Every cache dtype, both depth modes, coordinates partly outside the
    image and xyz partly behind the camera: the kernel against its plain
    version; the cached planes through the kernel bit for bit the
    pre-dequantized f32 planes through the same kernel."""
    from mine_tpu_torch.serve.cache import quantize_planes
    g = torch.Generator(device=cuda_device).manual_seed(15)
    B, S, H, W = 2, 5, 12, 20
    rgb, sigma, xyz = _volume(16, B, S, H, W, cuda_device)
    vol = torch.cat([rgb, sigma], dim=2)
    cx = torch.rand((B, S, 9, 17), generator=g, device=cuda_device) * 24 - 2
    cy = torch.rand((B, S, 9, 17), generator=g, device=cuda_device) * 16 - 2
    kernels.reset_launches()
    for quant in ("float32", "bf16", "int8"):
        qs, ss = zip(*(quantize_planes(v, quant) for v in vol))
        q = torch.stack(qs).contiguous()
        scales = None if ss[0] is None else torch.stack(ss).contiguous()
        dq = q.float() * scales if scales is not None else q.float()
        for bg in (False, True):
            got = render_fused.fused_plane_render(q, scales, xyz, cx, cy, bg)
            want = render_fused.fused_plane_render_plain(q, scales, xyz, cx,
                                                         cy, bg)
            _close(got[0], want[0], RGB_TOL)
            _close(got[1], want[1], BG_DEPTH_TOL if bg else DEPTH_TOL)
            pre = render_fused.fused_plane_render(dq.contiguous(), None, xyz,
                                                  cx, cy, bg)
            for a, b in zip(got, pre):
                np.testing.assert_array_equal(a.cpu().numpy(),
                                              b.cpu().numpy())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_plane_render"] == 12


@pytest.mark.cuda
def test_cuda_separable_pair_matches_plain_versions_on_both_branches(
        cuda_device):
    """The guard's two branches through both kernels: the anchored sample
    (a translation-like field) and the exact gather (the flag off), the
    sample bitwise, the splat at a tolerance; and the autograd Function
    against autograd through the plain anchored sample."""
    g = torch.Generator(device=cuda_device).manual_seed(17)
    Bp, C, H, W = 6, 7, 16, 24
    src = torch.randn((Bp, C, H, W), generator=g, device=cuda_device)
    rows = torch.arange(16, device=cuda_device, dtype=torch.float32)
    cx = torch.rand((Bp, 16, 24), generator=g, device=cuda_device) * 28 - 2
    cy = (rows[None, :, None] * 0.9 + 0.7
          + 0.1 * torch.rand((Bp, 16, 24), generator=g, device=cuda_device))
    cot = torch.randn((Bp, C, 16, 24), generator=g, device=cuda_device)
    kernels.reset_launches()
    ok, anchor = warp_sep.guard_ok(src.shape, cy, band=16)
    assert bool(ok)
    for flag in (ok, ~ok):
        np.testing.assert_array_equal(
            warp_sep.separable_sample(src, cx, cy, anchor, flag).cpu().numpy(),
            warp_sep.separable_sample_plain(src, cx, cy, anchor,
                                            flag).cpu().numpy())
        _close(warp_sep.separable_splat(cot, cx, cy, anchor, flag, (H, W)),
               warp_sep.separable_splat_plain(cot, cx, cy, anchor, flag,
                                              (H, W)),
               dict(rtol=1e-5, atol=1e-6))
    a = src.clone().requires_grad_(True)
    b = src.clone().requires_grad_(True)
    out, ok2 = warp_sep.separable_sample_diff(a, cx, cy, band=16)
    assert bool(ok2)
    (out * cot).sum().backward()
    from mine_tpu_torch.ops.warp_separable import anchored_sample
    (anchored_sample(b, cx, anchor) * cot).sum().backward()
    _close(a.grad, b.grad, dict(rtol=1e-5, atol=1e-5))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["separable_sample"] == 3
    assert kernels.LAUNCHES["separable_splat"] == 3


SPLAT_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SPLAT_CASES)
def test_cuda_splats_match_plain_versions_on_adversarial_coords(
        cuda_device, kind):
    """The tiled exact splat (#5, and #8's exact branch, which runs the
    same kernel behind its zero-filling row kernel) against the plain
    versions: ragged tiles, a source of another size, the direct route of
    a zoom-out, NaN and far-outside coordinates, W_s no multiple of 4; one
    counted launch a call."""
    src_hw, cx, cy = (v if isinstance(v, tuple) else
                      torch.from_numpy(v).to(cuda_device)
                      for v in splat_coords(kind))
    g = torch.Generator(device=cuda_device).manual_seed(21)
    cot = torch.randn((cx.shape[0], 7) + tuple(cx.shape[1:]), generator=g,
                      device=cuda_device)
    anchor = torch.zeros(cx.shape[:2], device=cuda_device)
    off = torch.zeros((), dtype=torch.bool, device=cuda_device)
    kernels.reset_launches()
    _close(warp.bilinear_splat(cot, cx, cy, src_hw),
           warp.bilinear_splat_plain(cot, cx, cy, src_hw), SPLAT_TOL)
    _close(warp_sep.separable_splat(cot, cx, cy, anchor, off, src_hw),
           warp_sep.separable_splat_plain(cot, cx, cy, anchor, off, src_hw),
           SPLAT_TOL)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == dict({n: 0 for n in kernels.KERNELS},
                                    bilinear_splat=1, separable_splat=1)


# anchored cases of the separable splat: (H_t, H_s, anchors of plane 0
# [H_t] as a function of the row index i, W_t); plane b adds 0.37*b
ANCHOR_CASES = {
    # neighbouring target rows share their source rows
    "shared rows": (24, 16, lambda i: 1.2 + 0.4 * i, 37),
    # a zoom-out: one source row collects 5 target rows (10 with hi)
    "zoom-out": (40, 12, lambda i: 2.0 + 0.2 * i, 37),
    # rows at and past the bottom: lo == hi == H_s-1 (also exactly H_s-1)
    "bottom border": (16, 12, lambda i: 7.0 + 0.5 * i, 37),
    # more target rows than the row kernel selects at a time (256), rows
    # longer than it sorts at a time (512 pixels)
    "many long rows": (300, 280, lambda i: 0.9 * i, 600),
    # rows wider than the row kernel's shared sums hold: column chunks and
    # one channel a pass
    "wide rows": (8, 6, lambda i: 0.6 * i, 2600),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(ANCHOR_CASES))
def test_cuda_anchored_splat_matches_plain_on_both_flags(cuda_device, kind):
    """The separable splat (#8) against its plain version with `ok` set
    and cleared at anchors that make the row kernel's selection work:
    shared source rows, a source row that collects many target rows, the
    bottom-border row with lo == hi, more rows and longer rows than the
    kernel takes at a time; sources 7 pixels wider than the target, x
    taps partly outside, y taps (the exact branch's) about the anchors."""
    H_t, H_s, rows, W_t = ANCHOR_CASES[kind]
    Bp, C, W_s = 3, 7, W_t + 7
    g = torch.Generator(device=cuda_device).manual_seed(23)
    i = torch.arange(H_t, dtype=torch.float32, device=cuda_device)
    anchor = (rows(i)[None] + 0.37 * torch.arange(
        Bp, dtype=torch.float32, device=cuda_device)[:, None]).contiguous()
    if kind == "bottom border":
        anchor[0, 8] = H_s - 1.0
        assert (anchor >= H_s - 1).sum() >= 8
    # source x across the row with 3 px of noise (partly outside), source
    # y about the row's anchor (the taps of the exact branch)
    j = torch.arange(W_t, dtype=torch.float32, device=cuda_device)
    cx = j * (W_s - 1) / (W_t - 1) + 6 * torch.rand(
        (Bp, H_t, W_t), generator=g, device=cuda_device) - 3
    cy = anchor[:, :, None] + torch.rand(
        (Bp, H_t, W_t), generator=g, device=cuda_device) - 0.5
    cot = torch.randn((Bp, C, H_t, W_t), generator=g, device=cuda_device)
    kernels.reset_launches()
    for ok in (True, False):
        flag = torch.tensor(ok, device=cuda_device)
        _close(warp_sep.separable_splat(cot, cx, cy, anchor, flag,
                                        (H_s, W_s)),
               warp_sep.separable_splat_plain(cot, cx, cy, anchor, flag,
                                              (H_s, W_s)), SPLAT_TOL)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == dict({n: 0 for n in kernels.KERNELS},
                                    separable_splat=2)
