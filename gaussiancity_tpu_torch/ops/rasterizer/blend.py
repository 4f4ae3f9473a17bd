# -*- coding: utf-8 -*-
"""Tile-local front-to-back alpha blending, forward and backward
(counterpart of ``gaussiancity_tpu/ops/rasterizer/blend.py::
blend_gathered``).

``blend_forward`` launches kernel K1 (``csrc/blend_fwd.cu``) and
``blend_backward`` kernel K2 (``csrc/blend_bwd.cu``) on CUDA tensors; on
CPU tensors they run ``blend_forward_plain`` and ``blend_backward_plain``.
The forward implements the sequential per-pixel semantics of upstream
renderCUDA (forward.cu:238-346) and of the JAX package's
``_blend_fwd_impl``:

- a slot is eligible iff ``k < count``, ``power <= 0`` and
  ``alpha >= alpha_min``; with ``ref_gate`` the pixel's 16x16 sensor block
  must also lie in the slot's getRect bbox;
- an eligible slot blends iff the pixel is not done and
  ``T * (1 - alpha) >= t_eps``, and otherwise marks the pixel done;
- window renders shift the pixel origin, never the means.

The backward replays each pixel's slots ``k < n_contrib`` back to front
(``_blend_bwd_impl``, upstream backward.cu:427-581) and returns per-(tile,
slot) gradient rows, compact: tile ``t``'s rows ``k < k_hi[t]`` at row
``slot_row_offsets(k_hi)[t] + k``; ``reduce_slot_grads`` sums them into
per-Gaussian rows through kernel K3, bounded by ``grad_capacity`` /
``grad_budget`` with the overflow counted by ``grad_trunc_count``
(``blend.py:405-431,496-554``).

Both kernels work on sub-tiles of at most ``SUB_TILE_PIXELS`` pixels
(``sub_tile_shape``) and drop, per sub-tile, the slots whose reference
gate holds at none of its pixels; ``blend_work`` counts the work the two
functions need.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from gaussiancity_tpu_torch import _kernels
from gaussiancity_tpu_torch.ops import hash_grid_bwd

ATTR_COLS = 10  # mx, my, ca, cb, cc, op, r, g, b, radius (attrs10)
N_GRAD = 9  # gradient rows: mx, my, ca, cb, cc, op, r, g, b
# slot-page size of the grad_budget accounting where the config's page is
# 0.  The port's kernels read slot rows one by one, so the page only
# rounds the budget; 32 slots (a warp's worth) wastes at most 31 slots of
# budget per tile, against 127 at the JAX package's TPU page of 128.
DEFAULT_PAGE = 32
# the kernels' work unit: one thread per pixel of a sub-tile of at most
# this many pixels; K2 joins the sub-tiles of a tile in one thread block
# cluster, portable up to 8 blocks
SUB_TILE_PIXELS = 256
MAX_SUB_TILES = 8


class BlendConsts(NamedTuple):
    tile_h: int
    tile_w: int
    n_tx: int
    alpha_min: float = 1.0 / 255.0
    alpha_max: float = 0.99
    t_eps: float = 1e-4
    ref_gate: bool = False


def sub_tile_shape(tile_h: int, tile_w: int) -> Tuple[int, int]:
    """(sub_h, sub_w) of the kernels' sub-tiles: the tile halved, the
    longer side first (rows on a tie), until at most ``SUB_TILE_PIXELS``
    pixels remain: 16x16 of a 32x32 tile, 8x32 of an 8x128 tile.  Any
    tile of 1..1024 pixels splits into at most ``MAX_SUB_TILES``."""
    sub_h, sub_w = tile_h, tile_w
    while sub_h * sub_w > SUB_TILE_PIXELS:
        if sub_h >= sub_w:
            sub_h = -(-sub_h // 2)
        else:
            sub_w = -(-sub_w // 2)
    return sub_h, sub_w


def _gate_rect(mx, my, rd):
    """The slot's getRect bbox in 16x16 sensor blocks, [xlo, xhi) x
    [ylo, yhi), as the kernels compute it."""
    return (torch.floor((mx - rd) * 0.0625),
            torch.floor((mx + rd + 15.0) * 0.0625),
            torch.floor((my - rd) * 0.0625),
            torch.floor((my + rd + 15.0) * 0.0625))


def _pixel_gate(bx16, by16, rect):
    """The reference gate at the pixels of 16x16 block (bx16, by16)."""
    xlo, xhi, ylo, yhi = rect
    return (bx16 >= xlo) & (bx16 < xhi) & (by16 >= ylo) & (by16 < yhi)


def _pixel_planes(consts: BlendConsts, T: int, origin, device):
    """Sensor pixel coordinates [T, 1, TW] / [T, TH, 1] of every tile."""
    tid = torch.arange(T, device=device)
    x0 = ((tid % consts.n_tx) * consts.tile_w).float() + float(origin[0])
    y0 = ((tid // consts.n_tx) * consts.tile_h).float() + float(origin[1])
    ix = torch.arange(consts.tile_w, device=device, dtype=torch.float32)
    iy = torch.arange(consts.tile_h, device=device, dtype=torch.float32)
    return x0[:, None, None] + ix[None, None, :], \
        y0[:, None, None] + iy[None, :, None]


def _assemble(tiles: torch.Tensor, consts: BlendConsts, img_h: int,
              img_w: int) -> torch.Tensor:
    """[T, TH, TW] -> [H, W] (crop off tile padding)."""
    T, TH, TW = tiles.shape
    n_ty = T // consts.n_tx
    img = tiles.reshape(n_ty, consts.n_tx, TH, TW).permute(0, 2, 1, 3)
    return img.reshape(n_ty * TH, consts.n_tx * TW)[:img_h, :img_w]


def _to_tiles(img: torch.Tensor, consts: BlendConsts, T: int,
              fill=0) -> torch.Tensor:
    """[..., H, W] -> [..., T, TH, TW], padding the edge tiles with
    ``fill`` (the inverse of ``_assemble``)."""
    TH, TW = consts.tile_h, consts.tile_w
    n_ty = T // consts.n_tx
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    pad = img.new_full((*lead, n_ty * TH, consts.n_tx * TW), fill)
    pad[..., :H, :W] = img
    pad = pad.reshape(*lead, n_ty, TH, consts.n_tx, TW)
    return pad.transpose(-3, -2).reshape(*lead, T, TH, TW)


def blend_forward_plain(attrs: torch.Tensor, gauss_index: torch.Tensor,
                        counts: torch.Tensor, origin: Tuple[float, float],
                        bg: torch.Tensor, img_h: int, img_w: int,
                        consts: BlendConsts):
    """Plain PyTorch version of K1, one slot per step over all tiles.

    Returns (image [3, H, W] with background, final_T [H, W],
    n_contrib [H, W] int32, n_evaluated [H, W] int32), where
    ``n_evaluated`` counts the slots each pixel tested before it saturated
    or its tile ran out: the work the front-to-back loop needs."""
    T, K = gauss_index.shape
    dev = attrs.device
    px, py = _pixel_planes(consts, T, origin, dev)
    shape = (T, consts.tile_h, consts.tile_w)
    if consts.ref_gate:
        bx16 = torch.floor(px * 0.0625)
        by16 = torch.floor(py * 0.0625)
    T_acc = torch.ones(shape, dtype=torch.float32, device=dev)
    C = [torch.zeros(shape, dtype=torch.float32, device=dev)
         for _ in range(3)]
    done = torch.zeros(shape, dtype=torch.bool, device=dev)
    nc = torch.zeros(shape, dtype=torch.int32, device=dev)
    n_eval = torch.zeros(shape, dtype=torch.int32, device=dev)
    counts = counts.to(dev)
    k_end = int(counts.max()) if T else 0
    for k in range(k_end):
        a = attrs[gauss_index[:, k].long()]  # [T, 10]
        col = [a[:, c, None, None] for c in range(ATTR_COLS)]
        mx, my, ca, cb, cc, op = col[:6]
        active = (k < counts)[:, None, None]
        dx = mx - px
        dy = my - py
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.clamp(op * torch.exp(power), max=consts.alpha_max)
        eligible = active & (power <= 0.0) & (alpha >= consts.alpha_min)
        if consts.ref_gate:
            eligible = eligible & _pixel_gate(bx16, by16,
                                              _gate_rect(mx, my, col[9]))
        n_eval += (active & ~done).to(torch.int32)
        test_T = T_acc * (1.0 - alpha)
        live = eligible & ~done
        blend = live & (test_T >= consts.t_eps)
        done = done | (live & (test_T < consts.t_eps))
        w = torch.where(blend, alpha * T_acc, torch.zeros_like(alpha))
        for c in range(3):
            C[c] = C[c] + w * col[6 + c]
        T_acc = torch.where(blend, test_T, T_acc)
        nc = torch.where(blend, torch.full_like(nc, k + 1), nc)
    final_T = _assemble(T_acc, consts, img_h, img_w)
    bg = bg.to(dev, torch.float32)
    image = torch.stack([_assemble(C[c], consts, img_h, img_w)
                         + final_T * bg[c] for c in range(3)])
    return (image, final_T, _assemble(nc, consts, img_h, img_w),
            _assemble(n_eval, consts, img_h, img_w))


def _check_inputs(attrs, gauss_index, counts, bg, consts, img_h, img_w):
    dev = attrs.device
    for name, t, dtype in (("attrs", attrs, torch.float32),
                           ("gauss_index", gauss_index, torch.int32),
                           ("counts", counts, torch.int32),
                           ("bg", bg, torch.float32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, attrs on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    T = gauss_index.shape[0]
    n_ty = -(-img_h // consts.tile_h)
    if attrs.dim() != 2 or attrs.shape[1] != ATTR_COLS:
        raise ValueError(f"attrs must be [N, {ATTR_COLS}], got "
                         f"{tuple(attrs.shape)}")
    if gauss_index.dim() != 2 or tuple(counts.shape) != (T,):
        raise ValueError("gauss_index must be [T, K] and counts [T]")
    if T != n_ty * consts.n_tx or consts.n_tx * consts.tile_w < img_w:
        raise ValueError(f"{T} tiles do not cover a {img_h}x{img_w} image")
    if bg.shape != (3,):
        raise ValueError("bg must be [3]")
    if not 0 < consts.tile_h * consts.tile_w <= 1024:
        raise ValueError("a tile must hold 1..1024 pixels")


def _kernel_attrs(attrs: torch.Tensor) -> torch.Tensor:
    """attrs as the kernels copy them: rows in 8-byte pieces."""
    return attrs if attrs.data_ptr() % 8 == 0 else attrs.clone()


def blend_forward(attrs: torch.Tensor, gauss_index: torch.Tensor,
                  counts: torch.Tensor, origin: Tuple[float, float],
                  bg: torch.Tensor, img_h: int, img_w: int,
                  consts: BlendConsts):
    """Blend the binned Gaussians of every tile, front to back.

    ``attrs`` [N, 10] float32 (``Preprocessed.attrs10``), ``gauss_index``
    [T, K] int32 and ``counts`` [T] int32 from binning, ``origin`` the
    sensor position of pixel (0, 0), ``bg`` [3].  Returns (image [3, H, W]
    with background, final_T [H, W], n_contrib [H, W] int32).

    CUDA tensors go to kernel K1; CPU tensors to the plain version."""
    _check_inputs(attrs, gauss_index, counts, bg, consts, img_h, img_w)
    if not attrs.is_cuda:
        return blend_forward_plain(attrs, gauss_index, counts, origin, bg,
                                   img_h, img_w, consts)[:3]
    T, K = gauss_index.shape
    dev = attrs.device
    attrs = _kernel_attrs(attrs)
    image = torch.empty((3, img_h, img_w), dtype=torch.float32, device=dev)
    final_T = torch.empty((img_h, img_w), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((img_h, img_w), dtype=torch.int32, device=dev)
    if T:
        # the tile order and the work-unit counter, written by the launch
        scratch = torch.empty(T + 1, dtype=torch.int32, device=dev)
        _kernels.launch(
            "blend_fwd", attrs.data_ptr(), gauss_index.data_ptr(),
            counts.data_ptr(), bg.data_ptr(), T, K, consts.n_tx,
            consts.tile_h, consts.tile_w,
            *sub_tile_shape(consts.tile_h, consts.tile_w), img_h, img_w,
            float(origin[0]), float(origin[1]), int(consts.ref_gate),
            consts.alpha_min, consts.alpha_max, consts.t_eps,
            scratch.data_ptr(), image.data_ptr(), final_T.data_ptr(),
            n_contrib.data_ptr(), _kernels.stream_handle(dev))
    return image, final_T, n_contrib


def tile_k_hi(counts: torch.Tensor, n_contrib: torch.Tensor,
              consts: BlendConsts) -> torch.Tensor:
    """[T] int32: each tile's deepest slot that can carry gradient,
    ``min(count, max n_contrib)`` over the tile's pixels (``_k_hi``).
    Only in-image pixels count: the padding of edge tiles carries no
    gradient (the JAX package also takes the padding's n_contrib, which
    can only raise its count above this one)."""
    T = counts.shape[0]
    if T == 0:
        return counts.clone()
    nc = _to_tiles(n_contrib, consts, T).amax(dim=(1, 2))
    return torch.minimum(counts, nc).to(torch.int32)


def _grad_slots(grad_capacity: int, K: int) -> int:
    return K if grad_capacity <= 0 else min(K, grad_capacity)


def grad_trunc_count(k_hi: torch.Tensor, grad_capacity: int,
                     grad_budget: int, K: int, page: int) -> torch.Tensor:
    """Scalar int32: slots that carry gradient but fall past
    ``grad_capacity`` per tile or, page-rounded, past ``grad_budget`` in
    all (``_grad_trunc_count``).  0 means the backward is exact."""
    kb = _grad_slots(grad_capacity, K)
    k_hi = k_hi.long()
    trunc = torch.clamp(k_hi - kb, min=0).sum()
    if grad_budget > 0:
        kh = torch.clamp(k_hi, max=kb)
        total = ((kh + page - 1) // page * page).sum()
        trunc = trunc + torch.clamp(total - grad_budget // page * page,
                                    min=0)
    return trunc.to(torch.int32)


def slot_row_offsets(k_hi: torch.Tensor) -> torch.Tensor:
    """[T] int64: the first gradient row of each tile, the exclusive prefix
    sum of ``k_hi``; tile ``t``'s slot ``k < k_hi[t]`` has row
    ``offsets[t] + k``."""
    k_hi = k_hi.long()
    return torch.cumsum(k_hi, 0) - k_hi


def blend_backward_plain(attrs: torch.Tensor, gauss_index: torch.Tensor,
                         k_hi: torch.Tensor, origin: Tuple[float, float],
                         g_out: torch.Tensor, bg_dot_g: torch.Tensor,
                         final_T: torch.Tensor, n_contrib: torch.Tensor,
                         consts: BlendConsts) -> torch.Tensor:
    """Plain PyTorch version of K2, one slot per step over all tiles, back
    to front.  Returns [T * K, 9] gradient rows (mx, my, ca, cb, cc, op,
    r, g, b) in the compact layout of ``slot_row_offsets``; the rows past
    ``sum(k_hi)`` are 0."""
    T, K = gauss_index.shape
    dev = attrs.device
    px, py = _pixel_planes(consts, T, origin, dev)
    if consts.ref_gate:
        bx16 = torch.floor(px * 0.0625)
        by16 = torch.floor(py * 0.0625)
    g = _to_tiles(g_out, consts, T)
    bgg = _to_tiles(bg_dot_g, consts, T)
    fT = _to_tiles(final_T, consts, T, fill=1.0)
    nc = _to_tiles(n_contrib, consts, T)
    shape = (T, consts.tile_h, consts.tile_w)
    zero = torch.zeros(shape, dtype=torch.float32, device=dev)
    T_cur = fT
    ar = [zero] * 3
    la = zero
    lc = [zero] * 3
    grads = torch.zeros((T * K, N_GRAD), dtype=torch.float32, device=dev)
    offsets = slot_row_offsets(k_hi)
    k_end = int(k_hi.max()) if T else 0
    for k in reversed(range(k_end)):
        a = attrs[gauss_index[:, k].long()]  # [T, 10]
        col = [a[:, c, None, None] for c in range(ATTR_COLS)]
        mx, my, ca, cb, cc, op = col[:6]
        dx = mx - px
        dy = my - py
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        G = torch.exp(power)
        alpha = torch.clamp(op * G, max=consts.alpha_max)
        ok = (k < nc) & (power <= 0.0) & (alpha >= consts.alpha_min)
        if consts.ref_gate:
            ok = ok & _pixel_gate(bx16, by16, _gate_rect(mx, my, col[9]))
        one_m_alpha = torch.where(ok, 1.0 - alpha, torch.ones_like(alpha))
        T_cur = T_cur / one_m_alpha  # T before this slot blended
        ar = [torch.where(ok, la * lc[c] + (1.0 - la) * ar[c], ar[c])
              for c in range(3)]
        w = alpha * T_cur
        dl_dalpha = T_cur * ((col[6] - ar[0]) * g[0] + (col[7] - ar[1]) * g[1]
                             + (col[8] - ar[2]) * g[2])
        dl_dalpha = dl_dalpha - (fT / one_m_alpha) * bgg
        la = torch.where(ok, alpha, la)
        lc = [torch.where(ok, col[6 + c], lc[c]) for c in range(3)]
        dl_dG = op * dl_dalpha
        gdx = G * dx
        gdy = G * dy
        rows = [dl_dG * (-gdx * ca - gdy * cb), dl_dG * (-gdy * cc - gdx * cb),
                -0.5 * gdx * dx * dl_dG, -gdx * dy * dl_dG,
                -0.5 * gdy * dy * dl_dG, G * dl_dalpha,
                w * g[0], w * g[1], w * g[2]]
        live = k < k_hi
        grads[offsets[live] + k] = torch.stack(
            [torch.where(ok, r, zero).sum(dim=(1, 2)) for r in rows],
            -1)[live]
    return grads


def blend_backward(attrs: torch.Tensor, gauss_index: torch.Tensor,
                   k_hi: torch.Tensor, origin: Tuple[float, float],
                   g_out: torch.Tensor, bg_dot_g: torch.Tensor,
                   final_T: torch.Tensor, n_contrib: torch.Tensor,
                   consts: BlendConsts) -> torch.Tensor:
    """Per-(tile, slot) gradients of the blend.

    ``attrs``, ``gauss_index`` as for ``blend_forward``; ``k_hi`` [T]
    int32 from ``tile_k_hi``; ``g_out`` [3, H, W] the image cotangent,
    ``bg_dot_g`` [H, W] = bg . g_out + the final_T cotangent; ``final_T``
    and ``n_contrib`` [H, W] from the forward.  Returns [T * K, 9]
    float32 rows (mx, my, ca, cb, cc, op, r, g, b), compact: tile ``t``'s
    slot ``k < k_hi[t]`` at row ``slot_row_offsets(k_hi)[t] + k``.  The
    first ``sum(k_hi)`` rows are the result: the kernel writes no other
    row (``sum(k_hi)`` stays on the card, so the shape is its bound
    ``T * K``).

    CUDA tensors go to kernel K2; CPU tensors to the plain version."""
    img_h, img_w = final_T.shape
    T, K = gauss_index.shape
    dev = attrs.device
    for name, t, dtype, shape in (
            ("k_hi", k_hi, torch.int32, (T,)),
            ("g_out", g_out, torch.float32, (3, img_h, img_w)),
            ("bg_dot_g", bg_dot_g, torch.float32, (img_h, img_w)),
            ("final_T", final_T, torch.float32, (img_h, img_w)),
            ("n_contrib", n_contrib, torch.int32, (img_h, img_w))):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _check_inputs(attrs, gauss_index, k_hi, g_out.new_zeros(3), consts,
                  img_h, img_w)
    if not attrs.is_cuda:
        return blend_backward_plain(attrs, gauss_index, k_hi, origin, g_out,
                                    bg_dot_g, final_T, n_contrib, consts)
    sub_h, sub_w = sub_tile_shape(consts.tile_h, consts.tile_w)
    if (-(-consts.tile_h // sub_h)) * (-(-consts.tile_w // sub_w)) \
            > MAX_SUB_TILES:
        raise ValueError(f"K2 joins at most {MAX_SUB_TILES} sub-tiles of a "
                         "tile in one cluster")
    attrs = _kernel_attrs(attrs)
    grads = torch.empty((T * K, N_GRAD), dtype=torch.float32, device=dev)
    if T:
        # the tile order and the row offsets, written by the launch
        scratch = torch.empty(2 * T, dtype=torch.int32, device=dev)
        _kernels.launch(
            "blend_bwd", attrs.data_ptr(), gauss_index.data_ptr(),
            k_hi.data_ptr(), T, K, consts.n_tx, consts.tile_h, consts.tile_w,
            sub_h, sub_w, img_h, img_w, float(origin[0]), float(origin[1]),
            int(consts.ref_gate), consts.alpha_min, consts.alpha_max,
            g_out.data_ptr(), bg_dot_g.data_ptr(), final_T.data_ptr(),
            n_contrib.data_ptr(), scratch.data_ptr(), grads.data_ptr(),
            _kernels.stream_handle(dev))
    return grads


def reduce_slot_grads(grads: torch.Tensor, gauss_index: torch.Tensor,
                      k_hi: torch.Tensor, n_gauss: int, grad_capacity: int,
                      grad_budget: int, page: int) -> torch.Tensor:
    """Sum the per-(tile, slot) rows of ``blend_backward`` (the compact
    layout of ``slot_row_offsets``) into per-Gaussian rows [n_gauss, 9]
    through the binning index (``scatter_packed_grads``).

    Each tile keeps its slots ``k < min(k_hi, grad_capacity)``.  With a
    ``grad_budget`` the kept slots are enumerated in whole pages, tile
    after tile, into ``grad_budget // page`` pages; pages past the budget
    are dropped, exactly those that ``grad_trunc_count`` counts.  (Without
    a budget the JAX package reduces whole pages, so past a capacity that
    is not a multiple of the page it also sums slots that its count calls
    truncated; the port keeps the two consistent.)  The sum runs through
    ``hash_grid_bwd.reduce_rows`` (kernel K3)."""
    T, K = gauss_index.shape
    dev = grads.device
    if T == 0:
        return grads.new_zeros((n_gauss, N_GRAD))
    kh = torch.clamp(k_hi.long(), max=_grad_slots(grad_capacity, K))
    if grad_budget > 0:
        n_pages = grad_budget // page
        pages_t = (kh + page - 1) // page
        cum = torch.cumsum(pages_t, 0)
        p = torch.arange(n_pages, device=dev)
        t_of_p = torch.clamp(torch.searchsorted(cum, p, right=True),
                             max=T - 1)
        k = ((p - (cum - pages_t)[t_of_p])[:, None] * page
             + torch.arange(page, device=dev)[None, :])
        valid = (p < cum[-1])[:, None] & (k < kh[t_of_p][:, None])
        tile = t_of_p[:, None]
    else:
        k = torch.arange(_grad_slots(grad_capacity, K), device=dev)[None, :]
        valid = k < kh[:, None]
        tile = torch.arange(T, device=dev)[:, None]
    valid = valid.reshape(-1)
    slot = torch.where(valid, (tile * K + k).reshape(-1), 0)
    row = torch.where(valid, (slot_row_offsets(k_hi)[tile] + k).reshape(-1),
                      0)
    keys = torch.where(valid, gauss_index.reshape(-1)[slot].long(),
                       torch.full_like(slot, n_gauss))
    return hash_grid_bwd.reduce_rows(keys, grads[row], n_gauss)


class BlendWork(NamedTuple):
    pairs: int  # (pixel, slot) pairs tested, where the gate holds
    eligible: int  # of those, power <= 0 and alpha >= alpha_min
    sub_tile_tests: int  # (sub-tile, slot) cull tests


def blend_work(attrs: torch.Tensor, gauss_index: torch.Tensor,
               n_slots: torch.Tensor, limit: torch.Tensor,
               origin: Tuple[float, float],
               consts: BlendConsts) -> BlendWork:
    """The work the blend functions need, for their bounds: every
    in-image pixel p of tile t tests the slots k < min(n_slots[t],
    limit[p]) (``limit`` [H, W]: the forward's ``n_evaluated``, the
    backward's ``n_contrib``); a pair counts where the reference gate
    holds at the pixel (every pair without the gate).  Each sub-tile
    tests once, for the cull, every slot below its pixels' largest
    limit."""
    T, K = gauss_index.shape
    img_h, img_w = limit.shape
    dev = attrs.device
    lim = torch.minimum(_to_tiles(limit.long(), consts, T),
                        n_slots.long()[:, None, None])
    px, py = _pixel_planes(consts, T, origin, dev)
    bx16, by16 = torch.floor(px * 0.0625), torch.floor(py * 0.0625)
    pairs = torch.zeros((), dtype=torch.long, device=dev)
    eligible = torch.zeros((), dtype=torch.long, device=dev)
    for k in range(int(lim.max()) if T else 0):
        a = attrs[gauss_index[:, k].long()]
        col = [a[:, c, None, None] for c in range(ATTR_COLS)]
        mx, my, ca, cb, cc, op = col[:6]
        live = k < lim
        if consts.ref_gate:
            live = live & _pixel_gate(bx16, by16, _gate_rect(mx, my, col[9]))
        dx, dy = mx - px, my - py
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.clamp(op * torch.exp(power), max=consts.alpha_max)
        pairs += live.sum()
        eligible += (live & (power <= 0.0)
                     & (alpha >= consts.alpha_min)).sum()
    sub_h, sub_w = sub_tile_shape(consts.tile_h, consts.tile_w)
    n_sy = -(-consts.tile_h // sub_h)
    n_sx = -(-consts.tile_w // sub_w)
    pad = lim.new_zeros((T, n_sy * sub_h, n_sx * sub_w))
    pad[:, :consts.tile_h, :consts.tile_w] = lim
    tests = pad.reshape(T, n_sy, sub_h, n_sx, sub_w).amax(dim=(2, 4)).sum()
    return BlendWork(int(pairs), int(eligible), int(tests))
