#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (mine_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (sm_90a: H100) and nvcc; there is no CPU fallback, and
any failed phase makes the script exit non-zero without the result line.

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from mine_tpu_torch/csrc and prints the build
     time and ptxas' register/spill report;
  3. for each serving kernel, at the shapes the serving path gives it
     (one 8-pose bucket of the LLFF config: 384x512, S=32): launches it
     and its plain PyTorch version on the same card tensors and holds the
     results within the stated limits; times kernel, plain version and,
     where one PyTorch call computes the same function, that yardstick,
     with CUDA events; computes the bound from the bytes and operations of
     the call;
  4. drives the serving path through mine_tpu_torch.serve_cli.main at full
     width (LLFF config, ResNet-50, bf16 convs, bf16 cache, 8-pose buckets,
     seeded weights, two seeded 384x512 images): encode each once, render
     both trajectories of each; checks the outputs, that every kernel ran
     (launch counts set to 0 just before the run and read just after), and
     two poses against the same cached MPI rendered through the plain
     versions;
  5. as 3 for the two backward kernels, at scale 0 of the LLFF train step
     (B=2, S=32, 384x512); the share of the splat's target tiles that
     take its direct route at those poses (plain torch, from the
     coordinates), and the splat on a forced-wide input (3x zoom-out,
     NaN rows) against its plain version;
  6. checks the two training autograd Functions (gather + splat, composite
     + its backward) against autograd through the plain versions, at a
     reduced size;
  7. drives the training path through mine_tpu_torch.train_cli.main at full
     width (LLFF config, data.name synthetic, ResNet-50, bf16 convs, B=2,
     S=32, 2 epochs = 4 steps, seeded weights): checks finite losses,
     parameters that moved, and 4 launches a step of each training kernel
     (counts set to 0 just before, read just after); then one step's loss
     and per-group gradient norms through the kernels against the plain
     versions from the same state, batch and draws (deterministic cuDNN);
     prints the warm step time and a profile of one warm step;
  8. kernel #4, the render megakernel, against its plain version at one
     8-pose LLFF bucket for each cache dtype (float32, bf16, int8), with
     its in-register dequant pinned bitwise to pre-dequantized planes
     through the same kernel; times and bound of the bf16 bucket;
  9. drives the request path: two seeded images encoded once into a
     serve.warp_backend=pallas_fused engine per cache mode (bf16, the
     shipped default, and int8); 128 (image, pose) requests from both
     images' trajectories, interleaved, submitted from 2 threads through a
     started ContinuousBatcher (serve.max_requests 8, serve.max_wait_ms 2)
     -> render_many -> fused_plane_render; every answer held to the same
     request through the unfused kernel engine (#1 + #2); requests/s,
     flushes, the mean batch, one fused launch a flush; the same batches
     as direct render_many calls from the main thread and from a worker
     thread, and a profile of one warm fused flush from each;
 10. kernels #7/#8, the guarded separable warp pair, against their plain
     versions at scale 0 of the train step (B*S=64, C=7, 384x512) on a
     translation-dominated pose set (the guard passes: the anchored
     branch) and a rotation-heavy one (it fails: the exact gather);
     times, yardsticks and bounds of the anchored sample and of both
     branches of the splat, each at its own poses (the splat's row
     reports the exact branch, which the `pallas_sep` train path runs);
     the autograd Function against autograd through the plain anchored
     sample;
 11. as 7 with training.warp_backend pallas_sep: 4 full-width steps with
     4 launches a step of #7/#8 (and #2/#6), warp_fallback_frac per step,
     and one step through the kernels against the plain `separable`
     backend from the same state;
 12. prints {"kernels": [...]} and, last, {"ok": true, "device": {...}}.

Each path runs right after its own kernels' checks, serving first, so the
serving numbers are taken in the same process state as before the
later slices existed.

Float32 comparisons run with TF32 off for cuDNN and matmuls ("highest").
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# seeded 384x512 images the serving path encodes (the first encode also
# pays cuDNN's first-call setup; the second is warm)
N_IMAGES = 2

# the training path: 2 epochs of the synthetic set's 2 drop-last batches
TRAIN_STEPS = 4
TRAIN_KERNELS = ("bilinear_sample", "volume_render", "bilinear_splat",
                 "volume_render_bwd")
# launches of each training kernel in one train step: one a scale
PER_STEP = 4
# what train_cli is given, and the full-width LLFF run it must make:
# (img_h, img_w, S, ResNet depth, conv dtype, batch)
TRAIN_EXTRA = {"data.name": "synthetic", "training.epochs": 2}
TRAIN_SHAPE = (384, 512, 32, 50, "bfloat16", 2)

# the request path: requests from both images' trajectories, the
# submitting threads, the cache modes served through the megakernel
REQUESTS = 128
SUBMITTERS = 2
REQUEST_QUANTS = ("bf16", "int8")
# the separable training path: the kernels it runs, 4 launches a step each
SEP_EXTRA = dict(TRAIN_EXTRA, **{"training.warp_backend": "pallas_sep"})
SEP_KERNELS = ("separable_sample", "volume_render", "separable_splat",
               "volume_render_bwd")
# roll of the rotation-heavy pose set of the separable kernel check (rad)
SEP_ROLL = 0.05

# device-time groups of a profile, by kernel name (first match wins)
PROFILE_GROUPS = (
    ("the port's CUDA kernels", ("bilinear_sample_kernel",
                                 "bilinear_splat_tiled_kernel",
                                 "volume_render_kernel",
                                 "volume_render_bwd_kernel",
                                 "src_render_blend_kernel",
                                 "fused_plane_render_kernel",
                                 "separable_sample_kernel",
                                 "anchored_splat_rows_kernel")),
    ("cuDNN/cuBLAS convolutions, GEMMs and layout transforms",
     ("cudnn", "xmma", "gemm", "Gemm", "cutlass", "nchwToNhwc",
      "nhwcToNchw", "sm80_", "sm90_")),
    ("reflection padding", ("reflection_pad",)),
    ("copies and fills", ("Memcpy", "Memset", "direct_copy", "fill_")),
)

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s off the
# tensor cores. The bound of a kernel is the larger of bytes/rate and
# operations/rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# limits of kernel vs plain version, on the same card tensors
TOL = {
    # same operations in the same order, each rounded: bitwise in practice
    "bilinear_sample": dict(atol=1e-6, rtol=0.0),
    # house tolerances of the composite (tests/test_kernels.py): rgb and
    # blended planes 1e-5/1e-6, depth 1e-4/1e-5 (exp and sums over 32
    # planes are rounded in another order than the plain reductions)
    "rgb": dict(atol=1e-6, rtol=1e-5),
    "depth": dict(atol=1e-5, rtol=1e-4),
    # the splat adds with float atomics in a varying order: the adjoint
    # tolerance of tests/test_warp_vjp.py (also the separable splat's)
    "bilinear_splat": dict(atol=1e-4, rtol=1e-4),
    # same operations in the same order on both branches: bitwise in
    # practice
    "separable_sample": dict(atol=1e-6, rtol=0.0),
    # the composite backward's chain rule is hand-derived, the plain
    # version is autograd's: tests/test_composite_vjp.py; with
    # is_bg_depth_inf the depth cotangent is scaled by 1000
    "bwd": dict(atol=2e-4, rtol=2e-3),
    "bwd_bg": dict(atol=2e-3, rtol=2e-3),
    # one train step, kernels vs plain versions (bf16 convs, TF32 off,
    # deterministic cuDNN): loss and per-group gradient norms, or twice
    # the plain step's own change under a 1e-6 nudge of its images where
    # that is larger (run_training_path)
    "train_step": dict(rtol=1e-3),
}


def log(msg):
    print(msg, flush=True)


def close(name, got, want, atol, rtol):
    """Max abs error; raises if |got-want| > atol + rtol*|want| anywhere or
    either side is not finite."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{name}: non-finite values")
    err = (got - want).abs()
    excess = (err - (atol + rtol * want.abs())).max().item()
    max_abs = err.max().item()
    # relative error where the reference is above the absolute limit
    small = want.abs() <= max(atol, 1e-30)
    max_rel = (err / want.abs()).masked_fill(small, 0.0).max().item()
    log(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
        f"(limit |err| <= {atol:g} + {rtol:g}*|plain|)")
    if excess > 0:
        raise AssertionError(f"{name}: error {max_abs:.3e} over the limit")
    return max_abs


def median_ms(fn, warmup=3, iters=15):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def slice_inputs(dev):
    """Inputs at the serving path's shapes, made the way the path makes
    them: seeded planes of one LLFF encode (S=32, 384x512), warped into
    the first 8 poses of the swing trajectory."""
    from mine_tpu_torch import geometry
    from mine_tpu_torch.config import CONFIG_DIR, load_config, \
        mpi_config_from_dict
    from mine_tpu_torch.infer.video import generate_trajectories
    from mine_tpu_torch.ops import sampling, warp

    config = load_config(os.path.join(CONFIG_DIR, "params_llff.yaml"))
    cfg = mpi_config_from_dict(config)
    S, H, W = cfg.num_bins_coarse, cfg.img_h, cfg.img_w
    g = torch.Generator(device=dev).manual_seed(0)
    disp = sampling.sample_disparity(cfg, 1, generator=g, device=dev)
    K = torch.from_numpy(geometry.intrinsics_from_fov(H, W))[None].to(dev)
    K_inv = geometry.inverse_intrinsics(K)
    rgb = torch.rand((1, S, 3, H, W), generator=g, device=dev)
    sigma = torch.randn((1, S, 1, H, W), generator=g, device=dev).abs() * 2
    src = torch.rand((1, 3, H, W), generator=g, device=dev)
    xyz_src = geometry.plane_xyz_src(geometry.cached_pixel_grid(H, W),
                                     disp, K_inv).contiguous()

    poses = torch.from_numpy(generate_trajectories("llff")[0][1][:8]).to(dev)
    P = poses.shape[0]
    xyz_tgt = geometry.plane_xyz_tgt(xyz_src.expand(P, -1, -1, -1, -1), poses)
    volume = torch.cat([rgb.expand(P, -1, -1, -1, -1),
                        sigma.expand(P, -1, -1, -1, -1), xyz_tgt], dim=2)
    volume = volume.reshape(P * S, 7, H, W).contiguous()

    def expand(x):
        return torch.repeat_interleave(x, S, dim=0)

    cx, cy, _ = warp.warp_coords((1.0 / disp).reshape(S).repeat(P),
                                 expand(poses), expand(K_inv.expand(P, 3, 3)),
                                 expand(K.expand(P, 3, 3)),
                                 geometry.cached_pixel_grid(H, W), (H, W))
    return dict(S=S, H=H, W=W, P=P, rgb=rgb, sigma=sigma, src=src,
                xyz_src=xyz_src, xyz_tgt=xyz_tgt, volume=volume,
                cx=cx.contiguous(), cy=cy.contiguous())


def check_kernels(dev):
    """Phase 3: each serving kernel against its plain version, times,
    bounds."""
    import torch.nn.functional as F

    from mine_tpu_torch.kernels import composite, warp
    from mine_tpu_torch.ops.warp import bilinear_sample as gather_plain

    x = slice_inputs(dev)
    S, H, W, P = x["S"], x["H"], x["W"], x["P"]
    rows = {}

    # -- 1. bilinear gather, [256,7,384,512] --
    vol, cx, cy = x["volume"], x["cx"], x["cy"]
    log(f"bilinear_sample: src {tuple(vol.shape)}, coords {tuple(cx.shape)}")
    out_k = warp.bilinear_sample(vol, cx, cy)
    out_p = gather_plain(vol, cx, cy)
    torch.cuda.synchronize()
    err = close("out", out_k, out_p, **TOL["bilinear_sample"])
    grid = torch.stack([(cx + 0.5) / (0.5 * W) - 1.0,
                        (cy + 0.5) / (0.5 * H) - 1.0], dim=-1)

    def library():
        return F.grid_sample(vol, grid, mode="bilinear",
                             padding_mode="border", align_corners=False)
    log(f"  grid_sample (yardstick only) max_abs_err vs kernel: "
        f"{(library() - out_k).abs().max().item():.3e}")
    del out_p
    C = vol.shape[1]
    rows["bilinear_sample"] = dict(
        max_abs_err=err,
        ms=median_ms(lambda: warp.bilinear_sample(vol, cx, cy)),
        plain_ms=median_ms(lambda: gather_plain(vol, cx, cy), iters=5),
        library_ms=median_ms(library),
        # clamp/floor/offsets ~10 flops a pixel, 3 lerps (9 flops) a channel
        bound=bound(nbytes(vol, cx, cy, out_k), cx.numel() * (10 + 9 * C)))
    del out_k, grid

    # -- 2. target composite on the warped volume, [8,32,*,384,512] --
    warped = warp.bilinear_sample(vol, cx, cy).reshape(P, S, 7, H, W)
    t_rgb = warped[:, :, 0:3].contiguous()
    t_sig = warped[:, :, 3:4].contiguous()
    t_xyz = warped[:, :, 4:7].contiguous()
    del warped
    log(f"volume_render: rgb {tuple(t_rgb.shape)}, z_mask")
    rk, dk = composite.volume_render(t_rgb, t_sig, t_xyz, z_mask=True)
    rp, dp = composite.volume_render_plain(t_rgb, t_sig, t_xyz, z_mask=True)
    torch.cuda.synchronize()
    err = max(close("rgb", rk, rp, **TOL["rgb"]),
              close("depth", dk, dp, **TOL["depth"]))
    rows["volume_render"] = dict(
        max_abs_err=err,
        ms=median_ms(lambda: composite.volume_render(t_rgb, t_sig, t_xyz,
                                                     z_mask=True)),
        plain_ms=median_ms(lambda: composite.volume_render_plain(
            t_rgb, t_sig, t_xyz, z_mask=True), iters=5),
        library_ms=None,
        # dist 9, exp ~4, weights/T 5, rgb+depth sums 8: ~26 a plane-pixel
        bound=bound(nbytes(t_rgb, t_sig, t_xyz, rk, dk), t_sig.numel() * 26))
    del t_rgb, t_sig, t_xyz, vol, cx, cy

    # -- 3. source composite + blend, [1,32,*,384,512] --
    rgb, sigma, xyz, src = x["rgb"], x["sigma"], x["xyz_src"], x["src"]
    log(f"src_render_blend: rgb {tuple(rgb.shape)}, src {tuple(src.shape)}")
    ok_ = composite.src_render_blend(rgb, sigma, xyz, src)
    op_ = composite.src_render_blend_plain(rgb, sigma, xyz, src)
    torch.cuda.synchronize()
    err = max(close("rgb", ok_[0], op_[0], **TOL["rgb"]),
              close("depth", ok_[1], op_[1], **TOL["depth"]),
              close("blended", ok_[2], op_[2], **TOL["rgb"]))
    rows["src_render_blend"] = dict(
        max_abs_err=err,
        ms=median_ms(lambda: composite.src_render_blend(rgb, sigma, xyz,
                                                        src)),
        plain_ms=median_ms(lambda: composite.src_render_blend_plain(
            rgb, sigma, xyz, src), iters=5),
        library_ms=None,
        # the composite's ~26 plus the blend's 9 a plane-pixel
        bound=bound(nbytes(rgb, sigma, xyz, src, *ok_), sigma.numel() * 35))

    return table_rows(rows)


def table_rows(rows):
    """Complete each kernel's row of the {"kernels": [...]} line."""
    from mine_tpu_torch.kernels import KERNELS

    for name, r in rows.items():
        b_ms, b_by = r.pop("bound")
        r.update(name=name, route="cuda", source=KERNELS[name][0],
                 replaces=KERNELS[name][1], bound_ms=b_ms, bound_by=b_by)
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms,"
            f" library {lib} ms, bound {b_ms:.4f} ms ({b_by})")
    return rows


def train_inputs(dev):
    """Inputs at scale 0 of the LLFF train step, made the way the step
    makes them: B=2 examples of S=32 seeded planes at 384x512, the target
    poses a few centimetres off the source (the synthetic set's range),
    the 7-channel volume warped through the gather into the target
    cameras; and seeded cotangents of the warp and of the composite."""
    from mine_tpu_torch import geometry
    from mine_tpu_torch.config import CONFIG_DIR, load_config, \
        mpi_config_from_dict
    from mine_tpu_torch.kernels import warp as kwarp
    from mine_tpu_torch.ops import sampling, warp

    config = load_config(os.path.join(CONFIG_DIR, "params_llff.yaml"))
    cfg = mpi_config_from_dict(config, device=dev)
    B, S, H, W = 2, cfg.num_bins_coarse, cfg.img_h, cfg.img_w
    g = torch.Generator(device=dev).manual_seed(1)
    disp = sampling.sample_disparity(cfg, B, generator=g, device=dev)
    K = torch.from_numpy(geometry.intrinsics_from_fov(H, W))[None].expand(
        B, 3, 3).to(dev)
    K_inv = geometry.inverse_intrinsics(K)
    grid = geometry.cached_pixel_grid(H, W)
    xyz_src = geometry.plane_xyz_src(grid, disp, K_inv)
    G = torch.eye(4, device=dev).repeat(B, 1, 1)
    G[:, 0:3, 3] = torch.tensor([[0.05, -0.02, 0.03], [-0.04, 0.03, -0.02]],
                                device=dev)
    xyz_tgt = geometry.plane_xyz_tgt(xyz_src, G)
    rgb = torch.rand((B, S, 3, H, W), generator=g, device=dev)
    sigma = torch.randn((B, S, 1, H, W), generator=g, device=dev).abs() * 2
    volume = torch.cat([rgb, sigma, xyz_tgt], dim=2).reshape(B * S, 7, H, W)

    def expand(x):
        return torch.repeat_interleave(x, S, dim=0)

    cx, cy, _ = warp.warp_coords((1.0 / disp).reshape(B * S), expand(G),
                                 expand(K_inv), expand(K), grid, (H, W))
    cx, cy = cx.contiguous(), cy.contiguous()
    warped = kwarp.bilinear_sample(volume.contiguous(), cx, cy).reshape(
        B, S, 7, H, W)
    return dict(B=B, S=S, H=H, W=W, cx=cx, cy=cy,
                g_warp=torch.randn((B * S, 7, H, W), generator=g, device=dev),
                rgb=warped[:, :, 0:3].contiguous(),
                sigma=warped[:, :, 3:4].contiguous(),
                xyz=warped[:, :, 4:7].contiguous(),
                g_rgb=torch.randn((B, 3, H, W), generator=g, device=dev),
                g_depth=torch.randn((B, 1, H, W), generator=g, device=dev))


def check_train_kernels(dev):
    """Phase 5: the two backward kernels against their plain versions at
    scale 0 of the train step; times, yardstick, bounds."""
    from mine_tpu_torch.kernels import composite, warp

    x = train_inputs(dev)
    H, W = x["H"], x["W"]
    rows = {}

    # -- 5. bilinear splat, [64,7,384,512] --
    gw, cx, cy = x["g_warp"], x["cx"], x["cy"]
    log(f"bilinear_splat: cotangent {tuple(gw.shape)}, coords "
        f"{tuple(cx.shape)}")
    d_k = warp.bilinear_splat(gw, cx, cy, (H, W))
    d_p = warp.bilinear_splat_plain(gw, cx, cy, (H, W))
    torch.cuda.synchronize()
    err = close("d_src", d_k, d_p, **TOL["bilinear_splat"])
    del d_p
    log(f"  target tiles on the direct (wide) route: "
        f"{wide_share(cx, cy, (H, W)):.4f}")
    # a forced-wide input: coordinates zoomed out 3x about the centre,
    # a few rows NaN (they read pixel 0). The clamp piles thousands of
    # taps onto each border pixel; the cotangent is positive there, since
    # signed addends would cancel and the f32 sums of two orders would
    # differ by about the limit whatever the route (a check of the order,
    # not of the kernel)
    wx = ((cx - 0.5 * W) * 3.0 + 0.5 * W).contiguous()
    wy = ((cy - 0.5 * H) * 3.0 + 0.5 * H).contiguous()
    wx[::7, 100:103] = float("nan")
    wy[3::7, 200:202] = float("nan")
    pos = torch.rand(gw.shape, generator=torch.Generator(
        device=dev).manual_seed(2), device=dev)
    log(f"  forced-wide input (3x zoom-out, NaN rows): tiles on the direct "
        f"route {wide_share(wx, wy, (H, W)):.4f}")
    close("d_src (forced wide)", warp.bilinear_splat(pos, wx, wy, (H, W)),
          warp.bilinear_splat_plain(pos, wx, wy, (H, W)),
          **TOL["bilinear_splat"])
    del wx, wy, pos
    grid = torch.stack([(cx + 0.5) / (0.5 * W) - 1.0,
                        (cy + 0.5) / (0.5 * H) - 1.0], dim=-1)

    def library():
        # the input gradient of grid_sample(bilinear, border,
        # align_corners=False), the same function; timed only
        return torch.ops.aten.grid_sampler_2d_backward(
            gw, d_k, grid, 0, 1, False, [True, False])[0]
    log(f"  grid_sampler_2d_backward (yardstick only) max_abs_err vs "
        f"kernel: {(library() - d_k).abs().max().item():.3e}")
    C = gw.shape[1]
    moved = nbytes(gw, cx, cy, d_k, d_k, d_k)
    log(f"  bytes: {nbytes(gw, cx, cy, d_k) / 1e9:.3f} GB to read each "
        f"input and write d_src once; the kernel moves ~{moved / 1e9:.3f} "
        f"GB (it zero-fills d_src first, and its flush's atomics read d_src "
        f"back and write it again)")
    rows["bilinear_splat"] = dict(
        max_abs_err=err,
        ms=median_ms(lambda: warp.bilinear_splat(gw, cx, cy, (H, W))),
        plain_ms=median_ms(lambda: warp.bilinear_splat_plain(
            gw, cx, cy, (H, W)), iters=5),
        library_ms=median_ms(library),
        # clamp/floor/offsets ~10 flops a pixel; 6 multiplies and 4 adds
        # (atomic) a channel
        bound=bound(nbytes(gw, cx, cy, d_k), cx.numel() * (10 + 10 * C)))
    del d_k, grid, gw

    # -- 6. composite backward, [2,32,*,384,512] --
    rgb, sig, xyz = x["rgb"], x["sigma"], x["xyz"]
    g_rgb, g_depth = x["g_rgb"], x["g_depth"]
    log(f"volume_render_bwd: rgb {tuple(rgb.shape)}, z_mask, both depth "
        f"modes")
    err = 0.0
    for bg in (False, True):
        tol = TOL["bwd_bg" if bg else "bwd"]
        got = composite.volume_render_bwd(rgb, sig, xyz, g_rgb, g_depth,
                                          True, bg)
        want = composite.volume_render_bwd_plain(rgb, sig, xyz, g_rgb,
                                                 g_depth, True, bg)
        torch.cuda.synchronize()
        for name, a, b in zip(("d_rgb", "d_sigma", "d_xyz"), got, want):
            e = close(f"{name} (is_bg_depth_inf={bg})", a, b,
                      **(TOL["bwd"] if name == "d_rgb" else tol))
            if not bg:  # the LLFF config's mode goes into the table
                err = max(err, e)
        del got, want
    outs = composite.volume_render_bwd(rgb, sig, xyz, g_rgb, g_depth, True,
                                       False)
    ins = nbytes(rgb, sig, xyz, g_rgb, g_depth)
    log(f"  bytes: {(ins + nbytes(*outs)) / 1e9:.3f} GB to read each input "
        f"and write each output once; the kernel moves "
        f"{(ins + nbytes(xyz, sig, *outs) + 2 * nbytes(sig)) / 1e9:.3f} GB "
        f"(xyz and sigma read in both passes, T_s parked in d_sigma)")
    rows["volume_render_bwd"] = dict(
        max_abs_err=err,
        ms=median_ms(lambda: composite.volume_render_bwd(
            rgb, sig, xyz, g_rgb, g_depth, True, False)),
        plain_ms=median_ms(lambda: composite.volume_render_bwd_plain(
            rgb, sig, xyz, g_rgb, g_depth, True, False), iters=5),
        library_ms=None,
        # up pass ~26 (the forward's), down pass ~45 a plane-pixel
        bound=bound(ins + nbytes(*outs), sig.numel() * 71))
    return table_rows(rows)


def wide_share(cx, cy, src_hw):
    """Share of the splat's target tiles that take its direct route."""
    from mine_tpu_torch.kernels.warp import splat_wide_tiles

    return splat_wide_tiles(cx, cy, src_hw).float().mean().item()


def check_autograd(dev):
    """Phase 6: the two training autograd Functions against autograd
    through the plain versions, on the same card tensors at a reduced
    size (16 planes of 96x128; 2 x 8 planes)."""
    from mine_tpu_torch.kernels import composite, warp
    from mine_tpu_torch.ops.warp import bilinear_sample as gather_plain

    g = torch.Generator(device=dev).manual_seed(3)
    src = torch.randn((16, 7, 96, 128), generator=g, device=dev)
    cx = torch.rand((16, 96, 128), generator=g, device=dev) * 136 - 4
    cy = torch.rand((16, 96, 128), generator=g, device=dev) * 104 - 4
    w = torch.randn((16, 7, 96, 128), generator=g, device=dev)
    a = src.clone().requires_grad_(True)
    b = src.clone().requires_grad_(True)
    (warp.bilinear_sample_diff(a, cx, cy) * w).sum().backward()
    (gather_plain(b, cx, cy) * w).sum().backward()
    log("bilinear_sample_diff vs autograd of the plain gather:")
    close("d_src", a.grad, b.grad, **TOL["bilinear_splat"])

    rgb = torch.rand((2, 8, 3, 96, 128), generator=g, device=dev)
    sigma = torch.randn((2, 8, 1, 96, 128), generator=g, device=dev).abs()
    xyz = torch.randn((2, 8, 3, 96, 128), generator=g, device=dev) * 0.3
    xyz[:, :, 2] += torch.linspace(1.0, 8.0, 8, device=dev)[
        None, :, None, None]
    xyz[:, :, 2, 0, :5] = -0.5  # a few pixels behind the camera
    w_rgb = torch.randn((2, 3, 96, 128), generator=g, device=dev)
    w_depth = torch.randn((2, 1, 96, 128), generator=g, device=dev)
    log("volume_render_diff vs autograd of the plain composite:")
    grads = []
    for fn in (composite.volume_render_diff, composite.volume_render_plain):
        leaves = [t.clone().requires_grad_(True) for t in (rgb, sigma, xyz)]
        out_rgb, out_depth = fn(*leaves, True, False)
        ((out_rgb * w_rgb).sum() + (out_depth * w_depth).sum()).backward()
        grads.append([t.grad for t in leaves])
    for name, k, p in zip(("d_rgb", "d_sigma", "d_xyz"), *grads):
        close(name, k, p, **TOL["bwd"])


def sep_inputs(dev, roll):
    """Inputs at scale 0 of the LLFF train step (B=2, S=32 planes,
    384x512, the translations of train_inputs) with a roll of `roll` rad:
    the source volume [64,7,384,512], its coordinates and a cotangent."""
    from mine_tpu_torch import geometry
    from mine_tpu_torch.config import CONFIG_DIR, load_config, \
        mpi_config_from_dict
    from mine_tpu_torch.ops import sampling, warp

    config = load_config(os.path.join(CONFIG_DIR, "params_llff.yaml"))
    cfg = mpi_config_from_dict(config, device=dev)
    B, S, H, W = 2, cfg.num_bins_coarse, cfg.img_h, cfg.img_w
    g = torch.Generator(device=dev).manual_seed(4)
    disp = sampling.sample_disparity(cfg, B, generator=g, device=dev)
    K = torch.from_numpy(geometry.intrinsics_from_fov(H, W))[None].expand(
        B, 3, 3).to(dev)
    G = torch.eye(4, device=dev).repeat(B, 1, 1)
    c, s_ = float(np.cos(roll)), float(np.sin(roll))
    G[:, 0:2, 0:2] = torch.tensor([[c, -s_], [s_, c]], device=dev)
    G[:, 0:3, 3] = torch.tensor([[0.05, -0.02, 0.03], [-0.04, 0.03, -0.02]],
                                device=dev)

    def expand(x):
        return torch.repeat_interleave(x, S, dim=0)

    cx, cy, _ = warp.warp_coords((1.0 / disp).reshape(B * S), expand(G),
                                 expand(geometry.inverse_intrinsics(K)),
                                 expand(K), geometry.cached_pixel_grid(H, W),
                                 (H, W))
    return dict(cfg=cfg, H=H, W=W, cx=cx.contiguous(), cy=cy.contiguous(),
                src=torch.rand((B * S, 7, H, W), generator=g, device=dev),
                cot=torch.randn((B * S, 7, H, W), generator=g, device=dev))


def check_sep_kernels(dev):
    """Phase 10: the separable pair against its plain versions on both
    branches of the guard at scale 0 of the train step; times, yardsticks
    and bounds of the anchored sample (#7) and of both branches of its
    splat (#8: the row's numbers are the exact branch's, which the
    `pallas_sep` train path runs, with both under "branches"); the
    autograd Function at a reduced size."""
    import torch.nn.functional as F

    from mine_tpu_torch.kernels import warp_sep
    from mine_tpu_torch.ops.warp_separable import anchored_sample

    rows, branches = {}, {}
    for roll, label, want_ok in ((0.0, "translation-dominated", True),
                                 (SEP_ROLL, "rotation-heavy", False)):
        x = sep_inputs(dev, roll)
        cfg, H, W = x["cfg"], x["H"], x["W"]
        src, cx, cy, cot = x["src"], x["cx"], x["cy"], x["cot"]
        del x
        ok, anchor = warp_sep.guard_ok(src.shape, cy, cfg.warp_band,
                                       sep_tol=cfg.warp_sep_tol)
        branch = "anchored" if bool(ok) else "gather"
        log(f"separable pair, {label} poses (roll {roll} rad): src "
            f"{tuple(src.shape)}, guard (band {cfg.warp_band}, sep_tol "
            f"{cfg.warp_sep_tol}) -> the {branch} branch")
        if bool(ok) != want_ok:
            raise AssertionError(f"{label} poses: the guard gave "
                                 f"{bool(ok)}, expected {want_ok}")
        out_k = warp_sep.separable_sample(src, cx, cy, anchor, ok)
        out_p = warp_sep.separable_sample_plain(src, cx, cy, anchor, ok)
        torch.cuda.synchronize()
        err_s = close("separable_sample out", out_k, out_p,
                      **TOL["separable_sample"])
        del out_p
        d_k = warp_sep.separable_splat(cot, cx, cy, anchor, ok, (H, W))
        d_p = warp_sep.separable_splat_plain(cot, cx, cy, anchor, ok, (H, W))
        torch.cuda.synchronize()
        err_d = close("separable_splat d_src", d_k, d_p,
                      **TOL["bilinear_splat"])
        del d_p
        ms_s = median_ms(lambda: warp_sep.separable_sample(src, cx, cy,
                                                           anchor, ok))
        ms_d = median_ms(lambda: warp_sep.separable_splat(cot, cx, cy, anchor,
                                                          ok, (H, W)))
        log(f"  {branch} branch: sample {ms_s:.4f} ms, splat {ms_d:.4f} ms")
        # the yardsticks compute the same function: grid_sample(border,
        # align_corners=False) at (cx, anchor) or (cx, cy), and its input
        # gradient
        ay = anchor[:, :, None].expand_as(cx) if bool(ok) else cy
        grid = torch.stack([(cx + 0.5) / (0.5 * W) - 1.0,
                            (ay + 0.5) / (0.5 * H) - 1.0], dim=-1)

        def lib_fwd():
            return F.grid_sample(src, grid, mode="bilinear",
                                 padding_mode="border", align_corners=False)

        def lib_bwd():
            return torch.ops.aten.grid_sampler_2d_backward(
                cot, d_k, grid, 0, 1, False, [True, False])[0]
        log(f"  grid_sample at (cx, {'anchor' if bool(ok) else 'cy'}) "
            f"(yardstick only) max_abs_err vs kernel: "
            f"{(lib_fwd() - out_k).abs().max().item():.3e}; its input "
            f"gradient vs the splat: "
            f"{(lib_bwd() - d_k).abs().max().item():.3e}")
        C = src.shape[1]
        # the anchored branch reads src (or the cotangent), cx and the
        # anchors, the gather branch cx and cy; taps and tent weights ~14
        # flops a pixel, then 6 multiplies and 3 adds (splat: 6 multiplies,
        # 4 adds) a channel
        ys = anchor if bool(ok) else cy
        branches[branch] = dict(
            max_abs_err=err_d, ms=ms_d,
            plain_ms=median_ms(lambda: warp_sep.separable_splat_plain(
                cot, cx, cy, anchor, ok, (H, W)), iters=5),
            library_ms=median_ms(lib_bwd),
            bound=bound(nbytes(cot, cx, ys, d_k),
                        cx.numel() * (14 + 10 * C)))
        log(f"  bytes of the {branch} branch: "
            f"{nbytes(src, cx, ys, out_k) / 1e9:.3f} GB (sample), "
            f"{nbytes(cot, cx, ys, d_k) / 1e9:.3f} GB (splat)")
        if branch == "gather":
            log(f"  splat target tiles on the direct (wide) route: "
                f"{wide_share(cx, cy, (H, W)):.4f}")
        else:
            rows["separable_sample"] = dict(
                max_abs_err=err_s, ms=ms_s,
                plain_ms=median_ms(lambda: warp_sep.separable_sample_plain(
                    src, cx, cy, anchor, ok), iters=5),
                library_ms=median_ms(lib_fwd),
                bound=bound(nbytes(src, cx, anchor, out_k),
                            cx.numel() * (14 + 9 * C)))
        del grid, ay, d_k, out_k
    rows["separable_splat"] = dict(branches["gather"])
    for name, b in branches.items():
        b_ms, b_by = b.pop("bound")
        b.update(bound_ms=b_ms, bound_by=b_by)
        lib = b["library_ms"]
        log(f"separable_splat, {name} branch: kernel {b['ms']:.4f} ms, plain "
            f"{b['plain_ms']:.4f} ms, library {lib:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
    rows["separable_splat"]["branches"] = branches

    # the Function against autograd through the plain anchored sample
    g = torch.Generator(device=dev).manual_seed(5)
    src = torch.randn((16, 7, 96, 128), generator=g, device=dev)
    cx = torch.rand((16, 96, 128), generator=g, device=dev) * 136 - 4
    rows_y = torch.arange(96, device=dev, dtype=torch.float32)
    cy = (rows_y[None, :, None] * 1.02 - 0.8 + 0.2 * torch.rand(
        (16, 96, 128), generator=g, device=dev)).contiguous()
    w = torch.randn((16, 7, 96, 128), generator=g, device=dev)
    a = src.clone().requires_grad_(True)
    b = src.clone().requires_grad_(True)
    out, ok = warp_sep.separable_sample_diff(a, cx, cy, band=48)
    if not bool(ok):
        raise AssertionError("the autograd check's poses failed the guard")
    (out * w).sum().backward()
    _, anchor = warp_sep.guard_ok(src.shape, cy, 48)
    (anchored_sample(b, cx, anchor) * w).sum().backward()
    log("separable_sample_diff vs autograd of the plain anchored sample:")
    close("d_src", a.grad, b.grad, **TOL["bilinear_splat"])
    return table_rows(rows)


def run_serving_path(dev, tmp):
    """Phase 4: the port's serving path at full width through serve_cli."""
    from mine_tpu_torch import kernels, serve_cli
    from mine_tpu_torch.infer.video import generate_trajectories
    from mine_tpu_torch.serve.engine import RenderEngine

    img_dir = os.path.join(tmp, "images")
    out_dir = os.path.join(tmp, "out")
    os.makedirs(img_dir)
    for seed in range(N_IMAGES):
        rng = np.random.RandomState(seed)
        np.save(os.path.join(img_dir, f"seed{seed}.npy"),
                (rng.uniform(size=(384, 512, 3)) * 255).astype(np.uint8))

    kernels.reset_launches()
    res = serve_cli.main(["--data_path", img_dir, "--output_dir", out_dir,
                          "--device", str(dev), "--seed", "0"])
    launches = dict(kernels.LAUNCHES)
    engine = res["engine"]
    calls = res["device_calls"]
    log(f"serving path: encode {['%.1f' % t for t in res['encode_ms']]} ms, "
        f"{calls} device calls")
    log("  render ms per bucket: "
        + " ".join(f"{t:.2f}" for t in res["render_call_ms"]))
    log(f"  {res['views']} views, {res['views_per_s']:.2f} views/s "
        f"(encode included); launches {launches}")

    expect = {"src_render_blend": res["images"], "bilinear_sample": calls,
              "volume_render": calls}
    for name, n in expect.items():
        if launches[name] != n or n == 0:
            raise AssertionError(f"{name}: {launches[name]} launches on the "
                                 f"serving path, expected {n} (> 0)")
    if engine.cache.quant != "bf16" or engine.max_bucket != 8:
        raise AssertionError(f"serving path ran with cache "
                             f"{engine.cache.quant}, bucket "
                             f"{engine.max_bucket}: expected bf16, 8")

    trajectories, _ = generate_trajectories("llff")
    for path, poses in zip(res["written"], trajectories * N_IMAGES):
        with np.load(path) as f:
            rgb, disp = f["rgb"], f["disparity"]
        if rgb.shape != (poses.shape[0], 384, 512, 3) or \
                disp.shape != (poses.shape[0], 384, 512):
            raise AssertionError(f"{path}: shapes {rgb.shape} {disp.shape}")
        if not np.isfinite(disp).all():
            raise AssertionError(f"{path}: non-finite disparity")

    # two poses from the same cached MPI: kernels vs plain versions
    image_id = res["image_ids"][0]
    poses = trajectories[1][[5, 40]]
    rgb_k, depth_k = engine.render(image_id, poses, warp_impl="pallas")
    plain = RenderEngine(backend="xla", max_bucket=8, cache=engine.cache)
    rgb_p, depth_p = plain.render(image_id, poses, warp_impl="xla")
    log("two poses, kernels vs plain versions:")
    close("rgb", torch.from_numpy(rgb_k), torch.from_numpy(rgb_p),
          **TOL["rgb"])
    close("depth", torch.from_numpy(depth_k), torch.from_numpy(depth_p),
          **TOL["depth"])
    try:
        profile_call("one warm 8-pose bucket", lambda: engine.render(
            image_id, trajectories[1][:8], warp_impl="pallas"))
    except Exception as e:  # noqa: BLE001 - a report, not a check
        log(f"profile: not measured ({type(e).__name__}: {e})")
    return launches


def profile_call(label, fn):
    """Where one warm call's time goes: torch.profiler's device time by
    kernel, and the device-busy share of the call's wall time. Reporting
    only: a profiler that records no device time prints so."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue  # CPU ops: their kernels are rows of their own
        if getattr(e, "is_user_annotation", False) or e.key.startswith(
                ("Optimizer.", "ProfilerStep")):
            continue  # a record_function range spans kernels counted below
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    busy = sum(r[0] for r in rows)
    if not rows:
        log("profile: the profiler recorded no device time (not measured)")
        return
    log(f"profile of {label}: wall {wall_ms:.2f} ms under the profiler, "
        f"device busy {busy:.2f} ms ({100.0 * busy / wall_ms:.1f}%), "
        f"{sum(r[1] for r in rows)} device activities")
    shares = {}
    for ms, _, key in rows:
        group = next((g for g, marks in PROFILE_GROUPS if any(
            m in key for m in marks)), "other PyTorch kernels")
        shares[group] = shares.get(group, 0.0) + ms
    for group, ms in sorted(shares.items(), key=lambda kv: -kv[1]):
        log(f"  {ms:8.3f} ms  {100.0 * ms / busy:5.1f}%  {group}")
    log("  by kernel:")
    for ms, count, key in sorted(rows, reverse=True)[:12]:
        log(f"  {ms:8.3f} ms  x{count:<4d} {key[:90]}")


def check_fused_kernel(dev):
    """Phase 8: the render megakernel against its plain version at one
    8-pose LLFF bucket (planes[idx] of one cached encode, as the engine
    hands them over) for each cache dtype, the in-kernel dequant against
    pre-dequantized planes through the same kernel (bitwise); times and
    bound of the bf16 (shipped default) bucket."""
    from mine_tpu_torch.kernels import render_fused
    from mine_tpu_torch.serve.cache import quantize_planes

    x = slice_inputs(dev)
    S, H, W, P = x["S"], x["H"], x["W"], x["P"]
    planes = torch.cat([x["rgb"][0], x["sigma"][0]], dim=1)  # [S,4,H,W]
    xyz = x["xyz_tgt"].contiguous()
    cx = x["cx"].reshape(P, S, H, W)
    cy = x["cy"].reshape(P, S, H, W)
    del x
    rows, times = {}, {}
    for quant in ("float32", "bf16", "int8"):
        q, sc = quantize_planes(planes, quant)
        vol = q.expand(P, -1, -1, -1, -1).contiguous()
        scales = (None if sc is None
                  else sc.expand(P, -1, -1, -1, -1).contiguous())
        log(f"fused_plane_render ({quant} cache): planes "
            f"{tuple(vol.shape)} {vol.dtype}, xyz {tuple(xyz.shape)}")
        rk, dk = render_fused.fused_plane_render(vol, scales, xyz, cx, cy)
        rp, dp = render_fused.fused_plane_render_plain(vol, scales, xyz, cx,
                                                       cy)
        torch.cuda.synchronize()
        err = max(close("rgb", rk, rp, **TOL["rgb"]),
                  close("depth", dk, dp, **TOL["depth"]))
        del rp, dp
        dq = (vol.float() * scales if scales is not None
              else vol.float()).contiguous()
        r_dq, d_dq = render_fused.fused_plane_render(dq, None, xyz, cx, cy)
        torch.cuda.synchronize()
        if not (torch.equal(rk, r_dq) and torch.equal(dk, d_dq)):
            raise AssertionError(f"{quant}: in-kernel dequant differs from "
                                 f"pre-dequantized planes through the kernel")
        log("  in-kernel dequant == pre-dequantized planes through the "
            "kernel: bitwise")
        del dq, r_dq, d_dq
        times[quant] = median_ms(lambda: render_fused.fused_plane_render(
            vol, scales, xyz, cx, cy))
        log(f"  kernel {times[quant]:.4f} ms")
        if quant == "bf16":
            rows["fused_plane_render"] = dict(
                max_abs_err=err, ms=times[quant],
                plain_ms=median_ms(lambda: render_fused.
                                   fused_plane_render_plain(
                                       vol, scales, xyz, cx, cy), iters=5),
                library_ms=None,
                # taps ~10, 7 channels x 3 lerps x 3, dist 9, composite
                # ~20: ~100 flops a plane-pixel
                bound=bound(nbytes(vol, xyz, cx, cy, rk, dk),
                            cx.numel() * 100))
        del vol, scales, rk, dk
    log("fused_plane_render kernel ms by cache dtype: "
        + ", ".join(f"{q} {t:.4f}" for q, t in times.items()))
    return table_rows(rows)


def run_request_path(dev, tmp):
    """Phase 9: requests through ContinuousBatcher -> render_many ->
    fused_plane_render, per cache mode, against the unfused kernel
    engine."""
    from mine_tpu_torch import kernels, serve_cli
    from mine_tpu_torch.config import CONFIG_DIR, load_config, \
        mpi_config_from_dict, serve_config_from_dict
    from mine_tpu_torch.infer.video import VideoGenerator, \
        generate_trajectories
    from mine_tpu_torch.serve.batcher import ContinuousBatcher, make_batcher
    from mine_tpu_torch.serve.cache import MPICache
    from mine_tpu_torch.serve.engine import RenderEngine

    config = load_config(os.path.join(CONFIG_DIR, "params_llff.yaml"))
    cfg = mpi_config_from_dict(config)
    model = serve_cli.build_model(config, None, 0, dev)
    engines = {}
    for quant in REQUEST_QUANTS:
        scfg = serve_config_from_dict(dict(config, **{
            "serve.cache_quant": quant, "serve.warp_backend": "pallas_fused"}))
        engines[quant] = (scfg, RenderEngine(
            use_alpha=cfg.use_alpha, is_bg_depth_inf=cfg.is_bg_depth_inf,
            backend="pallas", warp_impl=scfg.warp_backend,
            max_bucket=scfg.max_bucket,
            cache=MPICache(capacity_bytes=scfg.cache_bytes,
                           quant=scfg.cache_quant)))
    image_ids = []
    for seed in range(N_IMAGES):
        img = (np.random.RandomState(seed).uniform(size=(384, 512, 3))
               * 255).astype(np.uint8)
        gen = VideoGenerator(config, model, img, chunk=8, seed=0,
                             engine=engines[REQUEST_QUANTS[0]][1], device=dev)
        for quant in REQUEST_QUANTS[1:]:
            engines[quant][1].put(gen.image_id, gen.mpi_rgb[0],
                                  gen.mpi_sigma[0], gen.disparity[0],
                                  gen.K[0])
        image_ids.append(gen.image_id)
    del model, gen
    poses = np.concatenate(generate_trajectories("llff")[0])
    requests = [(image_ids[i % N_IMAGES], poses[(i // N_IMAGES) % len(poses)])
                for i in range(REQUESTS)]

    kernels.reset_launches()
    answers, stats = {}, {}
    for quant in REQUEST_QUANTS:
        scfg, engine = engines[quant]
        batcher = make_batcher(engine, scfg.scheduler, scfg.max_requests,
                               scfg.max_wait_ms)
        if not isinstance(batcher, ContinuousBatcher) or (
                batcher.max_requests, batcher.max_wait_s) != (8, 0.002):
            raise AssertionError("the request path did not get the shipped "
                                 "ContinuousBatcher(8, 2 ms)")
        futs = [None] * REQUESTS

        def submit(part):
            for i in range(part, REQUESTS, SUBMITTERS):
                futs[i] = batcher.submit(*requests[i])
        calls = engine.device_calls
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=submit, args=(k,))
                   for k in range(SUBMITTERS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        answers[quant] = [f.result(timeout=600) for f in futs]
        dt = time.perf_counter() - t0
        if not batcher.close():
            raise AssertionError("the batcher's flush thread did not stop")
        stats[quant] = dict(seconds=dt, flushes=batcher.flushes,
                            full=batcher.flushes_full,
                            deadline=batcher.flushes_deadline,
                            calls=engine.device_calls - calls,
                            call_ms=engine.call_ms[calls:])
    launches = dict(kernels.LAUNCHES)

    for quant in REQUEST_QUANTS:
        st = stats[quant]
        log(f"request path ({quant} cache, serve.warp_backend pallas_fused): "
            f"{REQUESTS} requests from {SUBMITTERS} threads in "
            f"{st['seconds']:.3f} s, {REQUESTS / st['seconds']:.2f} "
            f"requests/s; {st['flushes']} flushes ({st['full']} full, "
            f"{st['deadline']} on the deadline), mean batch "
            f"{REQUESTS / st['flushes']:.2f}")
        log("  render_many ms per flush (host clock, dispatch to the "
            "readback): " + " ".join(f"{t:.2f}" for t in st["call_ms"]))
    flushes = sum(st["flushes"] for st in stats.values())
    log(f"  launches {launches}; fused_plane_render "
        f"{launches['fused_plane_render']} == flushes {flushes}")
    if launches["fused_plane_render"] != flushes or flushes != sum(
            st["calls"] for st in stats.values()) or flushes == 0:
        raise AssertionError("fused_plane_render did not launch once a flush")
    for name in ("bilinear_sample", "volume_render"):
        if launches[name]:
            raise AssertionError(f"{name} launched on the fused path")

    for quant in REQUEST_QUANTS:
        _, engine = engines[quant]
        unfused = RenderEngine(use_alpha=cfg.use_alpha,
                               is_bg_depth_inf=cfg.is_bg_depth_inf,
                               backend="pallas", warp_impl="pallas",
                               max_bucket=8, cache=engine.cache)
        want = []
        for j in range(0, REQUESTS, 8):
            want += unfused.render_many(requests[j:j + 8])
        log(f"{REQUESTS} answers ({quant} cache), fused vs the unfused "
            f"kernel engine (#1 + #2):")
        for k, name in ((0, "rgb"), (1, "depth")):
            got = torch.from_numpy(np.stack([a[k] for a in answers[quant]]))
            ref = torch.from_numpy(np.stack([a[k] for a in want]))
            shape = (REQUESTS, 3 if k == 0 else 1, cfg.img_h, cfg.img_w)
            if tuple(got.shape) != shape:
                raise AssertionError(f"{name}: shape {tuple(got.shape)}")
            close(name, got, ref, **TOL[name])
        del want
    # where a flush's host time goes: the same batches of 8 as direct
    # render_many calls, from the main thread and from one worker thread
    # (the main thread joining it), without the batcher
    _, engine = engines["bf16"]

    def direct(out):
        for j in range(0, REQUESTS, 8):
            t0 = time.perf_counter()
            engine.render_many(requests[j:j + 8])
            out.append((time.perf_counter() - t0) * 1e3)
    for where in ("the main thread", "one worker thread"):
        ms = []
        if where == "the main thread":
            direct(ms)
        else:
            worker = threading.Thread(target=direct, args=(ms,))
            worker.start()
            worker.join()
        log(f"  the same {REQUESTS // 8} batches of 8 (bf16 cache) as "
            f"direct render_many calls from {where}, no batcher: median "
            f"{statistics.median(ms):.2f} ms, all "
            + " ".join(f"{t:.2f}" for t in ms))
    def in_worker():
        worker = threading.Thread(
            target=lambda: engine.render_many(requests[:8]))
        worker.start()
        worker.join()
    for label, fn in (("", lambda: engine.render_many(requests[:8])),
                      (", from a worker thread", in_worker)):
        try:
            profile_call(f"one warm fused 8-request flush (bf16 cache)"
                         f"{label}", fn)
        except Exception as e:  # noqa: BLE001 - a report, not a check
            log(f"profile: not measured ({type(e).__name__}: {e})")
    return launches


def run_training_path(dev, tmp, extra=TRAIN_EXTRA, warp="pallas_diff",
                      plain_warp="xla", path_kernels=TRAIN_KERNELS):
    """Phases 7 and 11: the port's training path at full width through
    train_cli with training.warp_backend `warp` (the composite `auto`),
    then one step through the kernels against the plain versions
    (`plain_warp` for the warp) from the same state."""
    from mine_tpu_torch import kernels, train_cli
    from mine_tpu_torch.data.synthetic import get_dataset
    from mine_tpu_torch.ops.sampling import sample_disparity
    from mine_tpu_torch.train.step import group_grad_norms

    kernels.reset_launches()
    res = train_cli.main(["--workspace", tmp, "--version", "v1",
                          "--extra_config", json.dumps(extra)])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    trainer, state, hist = res["trainer"], res["state"], res["history"]
    cfg, tcfg = trainer.cfg, trainer.tcfg
    log(f"training path: {len(hist)} steps, LLFF {cfg.img_h}x{cfg.img_w}, "
        f"S={cfg.num_bins_coarse}, ResNet-{cfg.num_layers}, {tcfg.dtype} "
        f"convs, B={tcfg.batch_size}, backends composite="
        f"{cfg.composite_backend} warp={cfg.warp_backend}")
    for h in hist:
        log(f"  step {h['step']}: loss {h['loss']:.4f} psnr "
            f"{h['psnr_tgt']:.2f} grad_norm {h['grad_norm']:.4g} "
            f"step_ms {h['step_ms']:.1f} skipped {int(h['skipped_steps'])} "
            f"warp_fallback_frac {h.get('warp_fallback_frac', float('nan'))}")
    warm = [h["step_ms"] for h in hist[1:]]
    log(f"  warm step ms (steps 2..{len(hist)}): median "
        f"{statistics.median(warm):.1f}, min {min(warm):.1f}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches {launches}")

    if (cfg.img_h, cfg.img_w, cfg.num_bins_coarse, cfg.num_layers,
            tcfg.dtype, tcfg.batch_size) != TRAIN_SHAPE:
        raise AssertionError("training path did not run the LLFF config at "
                             "full width")
    if (cfg.composite_backend, cfg.warp_backend) != ("pallas_diff", warp):
        raise AssertionError(f"training path ran composite="
                             f"{cfg.composite_backend} warp="
                             f"{cfg.warp_backend}, expected pallas_diff "
                             f"(auto on the card) and {warp}")
    if len(hist) != TRAIN_STEPS or state.step != TRAIN_STEPS:
        raise AssertionError(f"{len(hist)} train steps, expected "
                             f"{TRAIN_STEPS}")
    if not all(np.isfinite(h["loss"]) and h["skipped_steps"] == 0
               for h in hist):
        raise AssertionError("non-finite or skipped train steps")
    for name in kernels.KERNELS:
        want = PER_STEP * TRAIN_STEPS if name in path_kernels else 0
        if launches[name] != want:
            raise AssertionError(f"{name}: {launches[name]} launches on the "
                                 f"training path, expected {want}")
    fallback = [h["warp_fallback_frac"] for h in hist]
    if warp == "pallas_sep" and min(fallback) >= 1.0:
        log("  the synthetic poses fail the separable guard at every scale "
            "of every step: the anchored branch ran in the kernel-check "
            "phase only")
    start = trainer.init_state()  # the same seeded initialisation
    moved = [n for (n, p), q in zip(state.model.named_parameters(),
                                    start.model.parameters())
             if not torch.equal(p, q)]
    n_params = len(list(start.model.parameters()))
    log(f"  parameters moved: {len(moved)} of {n_params} tensors")
    if len(moved) < n_params // 2 or not all(
            torch.isfinite(p).all() for p in state.model.parameters()):
        raise AssertionError("training left the parameters unmoved or "
                             "non-finite")
    del start

    # one step from the same state, batch and draws: kernels vs plain
    ds = get_dataset(trainer.config)
    batch = trainer.put_batch(next(iter(ds.batch_iterator(
        tcfg.batch_size, shuffle=False))))
    disparity = sample_disparity(
        cfg, tcfg.batch_size, device=dev,
        generator=torch.Generator(device=dev).manual_seed(7))
    snapshot = {k: v.clone() for k, v in state.model.state_dict().items()}
    # the plain path once more on source images perturbed by 1e-6 of
    # themselves: how far the step's own float noise moves each number
    nudged = dict(batch, src_img=batch["src_img"] * (1.0 + 1e-6 * torch.randn(
        batch["src_img"].shape, device=dev,
        generator=torch.Generator(device=dev).manual_seed(8))))
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out, frac = {}, {}
    try:
        for name, backends, b in (
                ("kernels", ("pallas_diff", warp), batch),
                ("plain", ("xla", plain_warp), batch),
                ("plain, nudged", ("xla", plain_warp), nudged)):
            state.model.load_state_dict(snapshot)
            m = trainer.grads_and_metrics(
                state, b, disparity, cfg=trainer.with_backends(*backends))
            out[name] = dict(loss=m["loss"].item(), **{
                f"grad_norm/{k}": v.item()
                for k, v in group_grad_norms(state).items()})
            frac[name] = (m["warp_fallback_frac"].item()
                          if "warp_fallback_frac" in m else None)
    finally:
        torch.backends.cudnn.deterministic = False
        state.model.load_state_dict(snapshot)
    log(f"one train step, kernels (pallas_diff, {warp}) vs plain versions "
        f"(xla, {plain_warp}), same state, batch and draws "
        f"(warp_fallback_frac {frac['kernels']} vs {frac['plain']}):")
    if warp == "pallas_sep" and frac["kernels"] != frac["plain"]:
        raise AssertionError("the kernel and plain forms of the separable "
                             "guard decided differently")
    for k, want in out["plain"].items():
        got = out["kernels"][k]
        noise = abs(out["plain, nudged"][k] - want)
        rel = abs(got - want) / max(abs(want), 1e-30)
        limit = max(TOL["train_step"]["rtol"] * abs(want), 2 * noise)
        log(f"  {k}: {got:.7g} vs {want:.7g} (rel {rel:.2e}; the plain "
            f"path moves by {noise / max(abs(want), 1e-30):.2e} under a "
            f"1e-6 nudge of the images; limit rtol "
            f"{TOL['train_step']['rtol']:g} or twice that)")
        if not (np.isfinite(got) and abs(got - want) <= limit):
            raise AssertionError(f"train step {k}: kernels {got} vs plain "
                                 f"{want}")

    def step():
        trainer.train_step(state, batch)
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"  warm train steps on one resident batch (host clock, each ends "
        f"in a synchronize): median {statistics.median(times[1:]):.1f} ms, "
        f"min {min(times[1:]):.1f} ms, all "
        + " ".join(f"{t:.1f}" for t in times))
    try:
        profile_call(f"one warm train step (LLFF, B=2, S=32, warp {warp})",
                     step)
    except Exception as e:  # noqa: BLE001 - a report, not a check
        log(f"profile: not measured ({type(e).__name__}: {e})")
    return launches


def run_sep_training_path(dev, tmp):
    """Phase 11: the training path with training.warp_backend pallas_sep."""
    return run_training_path(dev, tmp, SEP_EXTRA, "pallas_sep", "separable",
                             SEP_KERNELS)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card "
              "only", file=sys.stderr)
        return 2
    try:
        from mine_tpu_torch.kernels import KERNELS, build
    except ImportError as e:
        print(f"chip_smoke: the mine_tpu_torch package is missing beside "
              f"this script ({e})", file=sys.stderr)
        return 2

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    log(smi[0])

    t0 = time.perf_counter()
    build.build(verbose=True)
    build.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for line in build.last_build_log:
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    failures = []
    rows = {}

    def phase(name, fn, *args):
        try:
            return fn(*args)
        except Exception as e:  # noqa: BLE001 - report every failed phase
            failures.append(f"{name}: {type(e).__name__}: {e}")
            log(f"FAILED {name}: {type(e).__name__}: {e}")
        finally:
            torch.cuda.empty_cache()

    def drive(path, fn):
        tmp = tempfile.mkdtemp(prefix="chip_smoke-", dir=HERE)
        try:
            launches[path] = phase(f"{path} path", fn, dev, tmp) or {}
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    launches = {}
    rows.update(phase("serving kernels", check_kernels, dev) or {})
    drive("serve", run_serving_path)
    rows.update(phase("render megakernel", check_fused_kernel, dev) or {})
    drive("requests", run_request_path)
    rows.update(phase("training kernels", check_train_kernels, dev) or {})
    phase("autograd functions", check_autograd, dev)
    drive("train", run_training_path)
    rows.update(phase("separable kernels", check_sep_kernels, dev) or {})
    drive("train_sep", run_sep_training_path)

    if failures:
        for f in failures:
            print(f"chip_smoke: {f}", file=sys.stderr)
        return 1
    missing = [name for name in KERNELS if name not in rows]
    if missing:
        print(f"chip_smoke: no check of {missing}", file=sys.stderr)
        return 1
    for name in rows:
        by_path = {path: n[name] for path, n in launches.items() if n[name]}
        if not by_path:
            print(f"chip_smoke: {name} was launched on no path",
                  file=sys.stderr)
            return 1
        rows[name].update(launches=sum(by_path.values()),
                          launches_by_path=by_path)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launches_by_path")
    # a kernel with data-dependent branches also reports each branch
    print(json.dumps({"kernels": [
        dict({k: r[k] for k in keys},
             **{k: r[k] for k in ("branches",) if k in r})
        for r in rows.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
