"""Wrappers of the CUDA separable-warp kernels (csrc/warp_sep.cu): the
guarded row-anchored sample, which replaces the Pallas kernel
mine_tpu/kernels/warp_sep.py:pallas_sep_bilinear_sample, and its exact
adjoint the splat, which replaces mine_tpu/kernels/warp_sep.py:_sep_bwd.
`separable_sample_diff` pairs them for training (`pallas_sep`).

The guard is part of the function: the JAX package takes the anchored
sample only where the kernel form of the decision passes
(kernels/warp_sep.py guard_ok: the anchors' block span fits the band with
the TPU's alignment slack, sep_err <= sep_tol, H_t and H_s multiples of
8), and the exact gather elsewhere. The decision is a 0-dim bool tensor on
the device (ops/warp_separable.py); the kernels read it through a
pointer and run the anchored sample/splat or the exact gather/splat, so
no host read decides the branch (the splat is two launches, the anchored
row kernel and csrc/warp.cu's exact splat, each doing nothing on the
other branch; one counted launch a call). The plain versions compute
both branches and select with the same flag.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mine_tpu_torch.kernels import LAUNCHES, build, check_tensor
from mine_tpu_torch.kernels.warp import bilinear_splat_plain
from mine_tpu_torch.ops.warp import bilinear_sample as gather_plain
from mine_tpu_torch.ops.warp_separable import (ROWS_PER_BLOCK,
                                               anchored_sample,
                                               anchored_taps, sep_guard)


def guard_ok(src_shape, coords_y: torch.Tensor, band: int = 48,
             sep_tol: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The `pallas_sep` decision (band starts aligned, both heights
    multiples of the block) -> (ok 0-dim bool, anchor [B',H_t] f32)."""
    H_s = src_shape[2]
    if coords_y.shape[1] % ROWS_PER_BLOCK or H_s % ROWS_PER_BLOCK:
        anchor = torch.zeros(coords_y.shape[:2], dtype=torch.float32,
                             device=coords_y.device)
        return torch.zeros((), dtype=torch.bool,
                           device=coords_y.device), anchor
    return sep_guard(coords_y, H_s, band, sep_tol, aligned=True)


def separable_sample_plain(src: torch.Tensor, coords_x: torch.Tensor,
                           coords_y: torch.Tensor, anchor: torch.Tensor,
                           ok: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward kernel: the anchored sample where `ok`,
    the exact gather where not."""
    return torch.where(ok, anchored_sample(src, coords_x, anchor),
                       gather_plain(src, coords_x, coords_y))


def anchored_splat_plain(g: torch.Tensor, coords_x: torch.Tensor,
                         anchor: torch.Tensor, src_hw) -> torch.Tensor:
    """The anchored sample's exact adjoint: the same taps and tent weights,
    each tap's weight autograd's of the y-then-x passes, (g*wx)*wy;
    accumulated with scatter_add_, so coinciding border taps add."""
    H, W = src_hw
    Bp, C, H_t, W_t = g.shape
    (i00, i10, i01, i11), (wx0, wx1, wy0, wy1) = anchored_taps(
        coords_x, anchor, src_hw)
    g = g.float()
    g0 = g * wx0
    g1 = g * wx1
    d_src = torch.zeros((Bp, C, H * W), dtype=torch.float32, device=g.device)
    for idx, val in ((i00, g0 * wy0), (i10, g0 * wy1), (i01, g1 * wy0),
                     (i11, g1 * wy1)):
        d_src.scatter_add_(2, idx[:, None].expand(Bp, C, H_t * W_t),
                           val.reshape(Bp, C, H_t * W_t))
    return d_src.reshape(Bp, C, H, W)


def separable_splat_plain(g: torch.Tensor, coords_x: torch.Tensor,
                          coords_y: torch.Tensor, anchor: torch.Tensor,
                          ok: torch.Tensor, src_hw) -> torch.Tensor:
    """Plain version of the backward kernel: the adjoint of the branch the
    forward took."""
    return torch.where(ok, anchored_splat_plain(g, coords_x, anchor, src_hw),
                       bilinear_splat_plain(g, coords_x, coords_y, src_hw))


def _check(name, Bp, H_t, W_t, coords_x, coords_y, anchor, ok, dev):
    for cname, t in (("coords_x", coords_x), ("coords_y", coords_y)):
        check_tensor(f"{name} {cname}", t, (Bp, H_t, W_t), dev)
    check_tensor(f"{name} anchor", anchor, (Bp, H_t), dev)
    if ok.device != dev or ok.dtype != torch.bool or ok.numel() != 1:
        raise ValueError(f"{name}: ok must be a 1-element bool tensor on "
                         f"{dev}")
    return ok.reshape(()).to(torch.int32)


def separable_sample(src: torch.Tensor, coords_x: torch.Tensor,
                     coords_y: torch.Tensor, anchor: torch.Tensor,
                     ok: torch.Tensor) -> torch.Tensor:
    """src [B',C,H_s,W_s] f32, coords [B',H_t,W_t] f32, anchor [B',H_t]
    f32, ok 0-dim bool (from guard_ok) -> [B',C,H_t,W_t] f32.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if src.device.type == "cpu":
        return separable_sample_plain(src, coords_x, coords_y, anchor, ok)
    if src.device.type != "cuda":
        raise ValueError(f"separable_sample: unsupported device "
                         f"{src.device}")
    Bp, C, H_s, W_s = src.shape
    check_tensor("separable_sample src", src, (Bp, C, H_s, W_s), src.device)
    _, H_t, W_t = coords_x.shape
    flag = _check("separable_sample", Bp, H_t, W_t, coords_x, coords_y,
                  anchor, ok, src.device)
    out = torch.empty((Bp, C, H_t, W_t), dtype=torch.float32,
                      device=src.device)
    lib = build.library()
    with torch.cuda.device(src.device):
        err = lib.mtpu_separable_sample(
            src.data_ptr(), coords_x.data_ptr(), coords_y.data_ptr(),
            anchor.data_ptr(), flag.data_ptr(), out.data_ptr(), Bp, C, H_s,
            W_s, H_t, W_t, torch.cuda.current_stream().cuda_stream)
    build.check_launch("separable_sample", err)
    LAUNCHES["separable_sample"] += 1
    return out


def separable_splat(g: torch.Tensor, coords_x: torch.Tensor,
                    coords_y: torch.Tensor, anchor: torch.Tensor,
                    ok: torch.Tensor, src_hw) -> torch.Tensor:
    """The forward's adjoint: g [B',C,H_t,W_t] f32 and the forward's
    coords, anchor and ok -> d_src [B',C,H_s,W_s] f32.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if g.device.type == "cpu":
        return separable_splat_plain(g, coords_x, coords_y, anchor, ok,
                                     src_hw)
    if g.device.type != "cuda":
        raise ValueError(f"separable_splat: unsupported device {g.device}")
    Bp, C, H_t, W_t = g.shape
    H_s, W_s = src_hw
    check_tensor("separable_splat g", g, (Bp, C, H_t, W_t), g.device)
    flag = _check("separable_splat", Bp, H_t, W_t, coords_x, coords_y,
                  anchor, ok, g.device)
    d_src = torch.empty((Bp, C, H_s, W_s), dtype=torch.float32,
                        device=g.device)
    lib = build.library()
    with torch.cuda.device(g.device):
        err = lib.mtpu_separable_splat(
            g.data_ptr(), coords_x.data_ptr(), coords_y.data_ptr(),
            anchor.data_ptr(), flag.data_ptr(), d_src.data_ptr(), Bp, C,
            H_s, W_s, H_t, W_t, torch.cuda.current_stream().cuda_stream)
    build.check_launch("separable_splat", err)
    LAUNCHES["separable_splat"] += 1
    return d_src


class SeparableSampleDiff(torch.autograd.Function):
    """Guarded separable sample forward (kernel #7), its adjoint backward
    (kernel #8); the coordinates, anchor and flag get no gradient
    (kernels/warp_sep.py:284-289)."""

    @staticmethod
    def forward(ctx, src, coords_x, coords_y, anchor, ok):
        ctx.save_for_backward(coords_x, coords_y, anchor, ok)
        ctx.src_hw = tuple(src.shape[-2:])
        return separable_sample(src, coords_x, coords_y, anchor, ok)

    @staticmethod
    def backward(ctx, g):
        coords_x, coords_y, anchor, ok = ctx.saved_tensors
        d_src = separable_splat(g.contiguous(), coords_x, coords_y, anchor,
                                ok, ctx.src_hw)
        return d_src, None, None, None, None


def separable_sample_diff(src: torch.Tensor, coords_x: torch.Tensor,
                          coords_y: torch.Tensor, band: int = 48,
                          sep_tol: float = 0.5
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable guarded separable sample (`pallas_sep`): src
    [B',C,H_s,W_s] f32 contiguous, detached coords [B',H_t,W_t] ->
    (out [B',C,H_t,W_t] f32, ok 0-dim bool), gradient to src only."""
    ok, anchor = guard_ok(src.shape, coords_y, band, sep_tol)
    out = SeparableSampleDiff.apply(src, coords_x, coords_y,
                                    anchor.contiguous(), ok)
    return out, ok
