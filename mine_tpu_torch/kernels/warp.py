"""Wrappers of the CUDA warp kernels (csrc/warp.cu): the gather, which
replaces the Pallas kernel mine_tpu/kernels/warp.py:pallas_bilinear_sample,
and its adjoint the splat, which replaces mine_tpu/kernels/warp_vjp.py:
_warp_bwd. `bilinear_sample_diff` pairs them for training.

The kernels have no band: they are exact for every pose, so unlike the TPU
kernels they need no domain guard and no caller-side fallback.
"""

from __future__ import annotations

import torch

from mine_tpu_torch.kernels import LAUNCHES, build, check_tensor
from mine_tpu_torch.ops.warp import bilinear_sample as bilinear_sample_plain
from mine_tpu_torch.ops.warp import clamp_coords

# the splat kernel's tile of target pixels (rows, columns) and the budget
# of its shared window in source pixels (csrc/warp.cu TILE_H/TILE_W,
# WIN_PIXELS)
SPLAT_TILE = (8, 32)
SPLAT_WINDOW = 24 * 64


def _check_warp(name, src_shape, coords_x, coords_y, dev):
    Bp = src_shape[0]
    _, H_t, W_t = coords_x.shape
    for cname, t in (("coords_x", coords_x), ("coords_y", coords_y)):
        check_tensor(f"{name} {cname}", t, (Bp, H_t, W_t), dev)
    return H_t, W_t


def bilinear_sample(src: torch.Tensor, coords_x: torch.Tensor,
                    coords_y: torch.Tensor) -> torch.Tensor:
    """src [B',C,H_s,W_s] f32, coords_x/coords_y [B',H_t,W_t] f32 source
    pixel coords -> [B',C,H_t,W_t] f32, border-clamped bilinear samples.

    CPU tensors run the plain gather; CUDA tensors launch the kernel."""
    if src.device.type == "cpu":
        return bilinear_sample_plain(src, coords_x, coords_y)
    if src.device.type != "cuda":
        raise ValueError(f"bilinear_sample: unsupported device {src.device}")
    Bp, C, H_s, W_s = src.shape
    check_tensor("bilinear_sample src", src, (Bp, C, H_s, W_s), src.device)
    H_t, W_t = _check_warp("bilinear_sample", src.shape, coords_x, coords_y,
                           src.device)
    out = torch.empty((Bp, C, H_t, W_t), dtype=torch.float32,
                      device=src.device)
    lib = build.library()
    with torch.cuda.device(src.device):
        err = lib.mtpu_bilinear_sample(
            src.data_ptr(), coords_x.data_ptr(), coords_y.data_ptr(),
            out.data_ptr(), Bp, C, H_s, W_s, H_t, W_t,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch("bilinear_sample", err)
    LAUNCHES["bilinear_sample"] += 1
    return out


def bilinear_splat_plain(g: torch.Tensor, coords_x: torch.Tensor,
                         coords_y: torch.Tensor, src_hw) -> torch.Tensor:
    """Plain version of the splat: the exact adjoint of the plain gather
    (ops/warp.py bilinear_sample). The same clamp, floor and border taps;
    each tap's weight is autograd's of the gather's lerps, and the taps
    are accumulated with scatter_add_, so coinciding border taps add.

    g [B',C,H_t,W_t] f32 (cotangent of the gather's output) -> d_src
    [B',C,H_s,W_s] f32."""
    H, W = src_hw
    Bp, C, Ho, Wo = g.shape
    x = clamp_coords(coords_x, W)
    y = clamp_coords(coords_y, H)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = (x - x0)[:, None]
    ty = (y - y0)[:, None]
    x0i = x0.long()
    y0i = y0.long()
    x1i = torch.clamp(x0i + 1, max=W - 1)
    y1i = torch.clamp(y0i + 1, max=H - 1)

    g = g.float()
    g_top = g * (1.0 - ty)
    g_bot = g * ty
    d_src = torch.zeros((Bp, C, H * W), dtype=torch.float32, device=g.device)
    for yi, xi, val in ((y0i, x0i, g_top * (1.0 - tx)), (y0i, x1i, g_top * tx),
                        (y1i, x0i, g_bot * (1.0 - tx)), (y1i, x1i, g_bot * tx)):
        idx = (yi * W + xi).reshape(Bp, 1, Ho * Wo).expand(Bp, C, Ho * Wo)
        d_src.scatter_add_(2, idx, val.reshape(Bp, C, Ho * Wo))
    return d_src.reshape(Bp, C, H, W)


def splat_wide_tiles(coords_x: torch.Tensor, coords_y: torch.Tensor,
                     src_hw) -> torch.Tensor:
    """Which target tiles the splat kernel adds straight into d_src: the
    tiles (SPLAT_TILE target pixels of one plane) whose taps' bounding box,
    its x extent rounded out to 4 pixels where W_s is a multiple of 4, is
    larger than the kernel's shared window of SPLAT_WINDOW source pixels.
    coords [B',H_t,W_t] -> [B', tiles_y, tiles_x] bool, computed as
    csrc/warp.cu computes it (a report of the route, not part of the
    function)."""
    H, W = src_hw
    th, tw = SPLAT_TILE
    x0 = torch.floor(clamp_coords(coords_x, W))
    y0 = torch.floor(clamp_coords(coords_y, H))
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    Bp, H_t, W_t = coords_x.shape
    pad = (0, -W_t % tw, 0, -H_t % th)

    def tiles(v, fill, reduce):
        v = torch.nn.functional.pad(v, pad, value=fill)
        v = v.reshape(Bp, v.shape[1] // th, th, v.shape[2] // tw, tw)
        return reduce(reduce(v, dim=4).values, dim=2).values

    big = float(2 ** 24)
    bx0, by0 = (tiles(v, big, torch.min) for v in (x0, y0))
    bx1, by1 = (tiles(v, -big, torch.max) for v in (x1, y1))
    bx1 = bx1 + 1
    if W % 4 == 0:
        bx0 = torch.floor(bx0 / 4) * 4
        bx1 = torch.ceil(bx1 / 4) * 4
    return (bx1 - bx0) * (by1 - by0 + 1) > SPLAT_WINDOW


def bilinear_splat(g: torch.Tensor, coords_x: torch.Tensor,
                   coords_y: torch.Tensor, src_hw) -> torch.Tensor:
    """The gather's adjoint: g [B',C,H_t,W_t] f32, the gather's coords ->
    d_src [B',C,H_s,W_s] f32 with src_hw = (H_s, W_s).

    CPU tensors run the plain splat; CUDA tensors launch the kernel."""
    if g.device.type == "cpu":
        return bilinear_splat_plain(g, coords_x, coords_y, src_hw)
    if g.device.type != "cuda":
        raise ValueError(f"bilinear_splat: unsupported device {g.device}")
    Bp, C, H_t, W_t = g.shape
    H_s, W_s = src_hw
    check_tensor("bilinear_splat g", g, (Bp, C, H_t, W_t), g.device)
    _check_warp("bilinear_splat", g.shape, coords_x, coords_y, g.device)
    d_src = torch.empty((Bp, C, H_s, W_s), dtype=torch.float32,
                        device=g.device)
    lib = build.library()
    with torch.cuda.device(g.device):
        err = lib.mtpu_bilinear_splat(
            g.data_ptr(), coords_x.data_ptr(), coords_y.data_ptr(),
            d_src.data_ptr(), Bp, C, H_s, W_s, H_t, W_t,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch("bilinear_splat", err)
    LAUNCHES["bilinear_splat"] += 1
    return d_src


class BilinearSampleDiff(torch.autograd.Function):
    """Gather forward (kernel #1), splat backward (kernel #5); the
    coordinates get no gradient (warp_vjp.py:165-197: they come from
    sampled disparities and poses under stop_gradient)."""

    @staticmethod
    def forward(ctx, src, coords_x, coords_y):
        ctx.save_for_backward(coords_x, coords_y)
        ctx.src_hw = tuple(src.shape[-2:])
        return bilinear_sample(src, coords_x, coords_y)

    @staticmethod
    def backward(ctx, g):
        coords_x, coords_y = ctx.saved_tensors
        d_src = bilinear_splat(g.contiguous(), coords_x, coords_y,
                               ctx.src_hw)
        return d_src, None, None


def bilinear_sample_diff(src: torch.Tensor, coords_x: torch.Tensor,
                         coords_y: torch.Tensor) -> torch.Tensor:
    """Differentiable gather: src [B',C,H_s,W_s] f32 contiguous, detached
    coords [B',H_t,W_t] -> [B',C,H_t,W_t] f32, gradient to src only."""
    return BilinearSampleDiff.apply(src, coords_x, coords_y)
