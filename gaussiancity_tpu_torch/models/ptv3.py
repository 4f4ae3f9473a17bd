# -*- coding: utf-8 -*-
"""Point Transformer V3 (counterpart of ``gaussiancity_tpu/models/ptv3.py``;
upstream models/pt_v3.py:1137-1344).

Serialized point-cloud U-Net: a k5 submanifold-conv stem, encoder stages
of transformer blocks (CPE conv, patch attention along a space-filling
curve, MLP) joined by serialized pooling, and a decoder of unpooling plus
blocks.  Submodule and parameter names mirror the Flax tree, so that
``interop.py`` carries weights and ``batch_stats`` across one to one.

What differs from the JAX package, by design:

- the samples of a batch run **packed**, as upstream's PTv3 runs them:
  the valid points of every sample, unpadded, one after another, with the
  row count of each sample beside them.  Row-wise layers (dense layers,
  norms, GELU) and ``MaskedBatchNorm`` see every row at once, so in
  training mode the batch statistics span every valid point of every
  sample, as the JAX package's ``psum`` over its ``nn.vmap`` axis makes
  them.  Serialization, neighbours, attention patches (with the
  per-sample wrap-around pad) and pooling stay within a sample: their
  index tensors hold each sample's block at its rows.  The JAX package's
  padded slabs, validity masks and static pooled capacities
  (``pool_capacity_divisor``) are TPU machinery: each pooled level has
  exactly its cluster count of points, as upstream's ``torch.unique``
  gives; the result equals the JAX package's wherever its pooled-capacity
  overflow counter reads 0.  What remains of the JAX package's
  ``PTv3PoolOverflow`` is the dense-neighbour overflow (valid points
  outside ``dense_nbr_extent``), which ``PTv3Single.overflow`` holds
  after each forward;
- the module's mode stands for the JAX ``train`` flag.  In training mode
  ``MaskedBatchNorm`` normalises with the batch statistics and folds them
  into its running averages, and drop path draws its masks from the
  ``torch.Generator`` the caller passes;
- ``cfg.remat`` wraps each SubMConv offset's gather and each attention
  group in ``torch.utils.checkpoint``: memory, not results.  No random
  draw happens inside a checkpointed region (drop path and the order
  shuffle draw outside), so the recomputation is the forward exactly.

With a ``dtype`` (bfloat16) the layers cast where the JAX package's do:
dense layers in bf16, norm statistics and the attention softmax in
float32, SubMConv's and the logits' products accumulated in float32
(``models/layers.py``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from gaussiancity_tpu_torch.config import PTv3Config
from gaussiancity_tpu_torch.models.layers import (Dense, LayerNormT,
                                                  matmul_f32, scalar)
from gaussiancity_tpu_torch.ops import serialization as ser
from gaussiancity_tpu_torch.utils import profiling

# the [G, H, K, K] logits of one chunk of patches stay under this many bytes
ATTN_CHUNK_BYTES = 256 * 1024 * 1024


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU.  In bfloat16 it is the JAX package's
    ``0.5 * x * erfc(-x * sqrt(0.5))`` op by op, each op rounding to
    bf16 as the program is written (``F.gelu`` rounds once)."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x)
    return (0.5 * x) * torch.special.erfc(-x * scalar(math.sqrt(0.5),
                                                      x.dtype))


def _cast(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return x if dtype is None else x.to(dtype)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d (eps 1e-3, momentum 0.01) over the rows it is given, the
    valid points of every sample.  The running statistics live in the
    buffers ``mean`` and ``var`` (the Flax ``batch_stats`` collection).
    Statistics and the normalisation are float32; the output is cast to
    ``dtype``.

    Eval normalises with them.  Training normalises with the batch mean
    and the biased variance, taken in two passes as the JAX package takes
    them (autograd flows through both), and folds the batch mean and the
    unbiased variance (denominator ``max(n - 1, 1)``) into the running
    averages: ``new = (1 - momentum) * old + momentum * batch``."""

    EPS = 1e-3
    MOMENTUM = 0.01

    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = dtype
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if not self.training:
            y = (x - self.mean) * torch.rsqrt(self.var + self.EPS)
            return _cast(y * self.scale + self.bias, self.compute_dtype)
        n = max(x.shape[0], 1)
        mean = x.sum(dim=0) / n
        vs = ((x - mean) ** 2).sum(dim=0)
        with torch.no_grad():
            mom = self.MOMENTUM
            self.mean.copy_((1.0 - mom) * self.mean + mom * mean)
            self.var.copy_((1.0 - mom) * self.var
                           + mom * (vs / max(n - 1, 1)))
        y = (x - mean) * torch.rsqrt(vs / n + self.EPS)
        return _cast(y * self.scale + self.bias, self.compute_dtype)


# ---------------------------------------------------------------------------
# submanifold sparse convolution
# ---------------------------------------------------------------------------


def kernel_offsets(kernel_size: int, device=None) -> torch.Tensor:
    """[K^3, 3] offsets, dx slowest, dz fastest."""
    r = kernel_size // 2
    ar = torch.arange(-r, r + 1, dtype=torch.int64, device=device)
    return torch.cartesian_prod(ar, ar, ar)


def subm_neighbors_dense(grid_coord: torch.Tensor, valid: torch.Tensor,
                         kernel_size: int, extent: int = 256):
    """Neighbour ids through a dense [extent^3] voxel id map.

    Every valid point inside the extent writes its id into its voxel;
    points that share a voxel keep the lowest id.  Returns (nb_idx [K^3, N]
    int32, found [K^3, N] bool, overflow): ``found`` says the voxel at the
    offset holds a point, ``nb_idx`` is that point's id, and ``overflow``
    counts the valid points outside the extent (they write nothing, and
    their neighbours are not found).

    Where a slot is not found, ``nb_idx`` names the query's own row.  The
    gather multiplies that row by 0, so any row would do for the value;
    the JAX package clamps to N - 1, and the port differs from it in
    those slots alone.  The own row keeps the gather's backward fast: an
    ``index_put_`` with accumulation sorts the indices and walks each run
    of equal ones serially, and on a building's shell most slots are
    unfound, so one shared row such as N - 1 would make a run of ~10^4
    rows per offset."""
    N = grid_coord.shape[0]
    dev = grid_coord.device
    g = grid_coord.to(torch.int64)
    in_r = valid & ((g >= 0) & (g < extent)).all(dim=1)
    overflow = (valid & ~in_r).sum()
    lin = (g[:, 0] * extent + g[:, 1]) * extent + g[:, 2]
    ids = torch.arange(N, dtype=torch.int32, device=dev)
    vol = torch.full((extent ** 3,), N, dtype=torch.int32, device=dev)
    vol.scatter_reduce_(0, lin[in_r], ids[in_r], reduce="amin")
    gq = g[None] + kernel_offsets(kernel_size, dev)[:, None, :]  # [K, N, 3]
    inq = ((gq >= 0) & (gq < extent)).all(dim=-1)
    linq = (gq[..., 0] * extent + gq[..., 1]) * extent + gq[..., 2]
    j = vol[torch.where(inq, linq, torch.zeros_like(linq))]
    found = inq & (j < N) & valid[None, :]
    return torch.where(found, j, ids[None]), found, overflow


def voxel_keys(grid_coord: torch.Tensor, valid: torch.Tensor,
               depth: int = 10) -> torch.Tensor:
    """One key per voxel, ``(gx * M + gy) * M + gz`` with M = 2^depth
    (int64); invalid points carry ``INVALID_CODE``."""
    M = 1 << depth
    g = grid_coord.to(torch.int64)
    key = (g[:, 0] * M + g[:, 1]) * M + g[:, 2]
    return torch.where(valid, key, torch.full_like(key, ser.INVALID_CODE))


def subm_neighbors(grid_coord: torch.Tensor, valid: torch.Tensor,
                   kernel_size: int, depth: int = 10):
    """Neighbour ids by a search over the sorted voxel keys (the JAX
    package's path at ``dense_nbr_extent == 0``).  Its two-sort merge is
    TPU machinery; what it computes is a left ``searchsorted`` of every
    ``key + offset`` in the stable-sorted keys, which is what this does:
    ``nb_idx`` is the point at that rank, so among points that share a
    voxel the lowest index, and ``found`` says its key is the query's.
    Keys live on a 2^depth lattice per axis, so an offset that leaves it
    aliases, exactly as in the JAX package.  Where a slot is not found,
    ``nb_idx`` names the query's own row, as in ``subm_neighbors_dense``
    and for its reason; the JAX package keeps the point at the clamped
    rank there.  Returns (nb_idx [K^3, N] int32, found [K^3, N] bool)."""
    N = grid_coord.shape[0]
    dev = grid_coord.device
    r = kernel_size // 2
    M = 1 << depth
    keys = voxel_keys(grid_coord, valid, depth)
    sorted_keys, order = torch.sort(keys, stable=True)
    offs = kernel_offsets(kernel_size, dev)
    offs = (offs[:, 0] * M + offs[:, 1]) * M + offs[:, 2]  # [K]
    max_off = r * (M * M + M + 1)
    q = (torch.clamp(keys, max=ser.INVALID_CODE - max_off)[None, :]
         + offs[:, None])  # [K, N]
    rank = torch.searchsorted(sorted_keys, q)
    nb_idx = order[rank.clamp(0, max(N - 1, 0))]
    found = (keys[nb_idx] == keys[None, :] + offs[:, None]) & valid[None, :]
    ids = torch.arange(N, dtype=nb_idx.dtype, device=dev)
    return torch.where(found, nb_idx, ids[None]).to(torch.int32), found


def _offset_product(feat, idx, found, w):
    """One SubMConv offset: the gathered neighbour rows (0 where none)
    times the offset's kernel, accumulated in float32 for bf16.

    ``idx`` names the query's own row where ``found`` is false (the JAX
    package's maps name N - 1 or another row there; the product is the
    same).  The gather's backward is an ``index_put_`` with accumulation,
    which walks each run of equal indices one row at a time: own rows
    leave runs of one or two, where one shared row would make a run as
    long as the unfound slots."""
    nb = feat[idx.long()] * found[:, None].to(feat.dtype)
    return matmul_f32(nb, w) if feat.dtype != torch.float32 else nb @ w


class SubMConv(nn.Module):
    """Submanifold sparse convolution: output at the active sites only,
    one product per kernel offset over the gathered neighbour features,
    summed in a float32 carry.  ``kernel`` is [K^3, C, F] (the Flax
    layout).  In ``dtype`` the features and the kernel are cast before
    the gathers and the sum after; with ``remat`` each offset's gather is
    recomputed in the backward instead of kept."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 dtype: Optional[torch.dtype] = None, remat: bool = False):
        super().__init__()
        n_offs = kernel_size ** 3
        self.kernel_size = kernel_size
        self.compute_dtype = dtype
        self.remat = remat
        self.kernel = nn.Parameter(torch.empty(n_offs, in_channels,
                                               features))
        self.bias = nn.Parameter(torch.empty(features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """uniform(+-sqrt(3 / fan_in)), fan_in = C * K^3, as the JAX
        package initialises both arrays."""
        fan_in = self.kernel.shape[0] * self.kernel.shape[1]
        bound = math.sqrt(1.0 / fan_in) * math.sqrt(3.0)
        with torch.no_grad():
            self.kernel.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, feat: torch.Tensor,
                neighbors: Tuple[torch.Tensor, torch.Tensor]
                ) -> torch.Tensor:
        nb_idx, found = neighbors
        dt = self.compute_dtype
        x, W = _cast(feat, dt), _cast(self.kernel, dt)
        remat = self.remat and torch.is_grad_enabled()
        acc = feat.new_zeros((feat.shape[0], W.shape[2]),
                             dtype=torch.float32)
        for k in range(W.shape[0]):
            if remat:
                acc = acc + checkpoint(_offset_product, x, nb_idx[k],
                                       found[k], W[k], use_reentrant=False)
            else:
                acc = acc + _offset_product(x, nb_idx[k], found[k], W[k])
        if dt is None:
            return acc + self.bias
        return acc.to(dt) + self.bias.to(dt)


# ---------------------------------------------------------------------------
# serialized patch attention
# ---------------------------------------------------------------------------


def rpe_bounds(patch_size: int) -> Tuple[int, int]:
    """Clamp bound and per-axis table stride of the relative-position
    bias (upstream models/pt_v3.py:608-610)."""
    pos_bnd = int((4 * patch_size) ** (1 / 3) * 2)
    return pos_bnd, 2 * pos_bnd + 1


def rpe_bias(table: torch.Tensor, patch_size: int,
             gc_patch: torch.Tensor) -> torch.Tensor:
    """[3 * rpe_num, H] table, [G, K, 3] grid coordinates -> [G, H, K, K]
    logit bias: the clamped per-axis coordinate deltas index the table,
    summed over the three axes (upstream models/pt_v3.py:612-626)."""
    pos_bnd, rpe_num = rpe_bounds(patch_size)
    rel = gc_patch[:, :, None, :] - gc_patch[:, None, :, :]
    idx = (rel.clamp(-pos_bnd, pos_bnd) + pos_bnd
           + torch.arange(3, device=rel.device) * rpe_num)
    return table[idx].sum(3).permute(0, 3, 1, 2)


class PatchAttention(nn.Module):
    """Dense attention within patches of ``patch_size`` consecutive points
    along a serialized order.

    forward(feat [N, C], order [N], inverse [N], count, grid_coord) ->
    [N, C], where the first ``count`` entries of ``order`` are the valid
    points.  The last partial patch wraps around as upstream's does: pad
    slot ``j`` repeats slot ``j - patch_size``; slots that name no valid
    point are masked keys (logit -1e9).  The logits (with the
    relative-position bias when ``enable_rpe``; then ``grid_coord`` [N, 3]
    is needed) and the softmax run in float32 whatever the dtype.  A
    sample of fewer than ``patch_size`` points is one patch of its own
    size."""

    def __init__(self, channels: int, num_heads: int, patch_size: int,
                 dtype: Optional[torch.dtype] = None, remat: bool = False,
                 enable_rpe: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.patch_size = patch_size
        self.compute_dtype = dtype
        self.remat = remat
        self.qkv = Dense(channels, 3 * channels, dtype=dtype)
        self.proj = Dense(channels, channels, dtype=dtype)
        self.rpe_table = None
        if enable_rpe:
            self.rpe_table = nn.Parameter(torch.empty(
                3 * rpe_bounds(patch_size)[1], num_heads))
            self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """The RPE table: a normal truncated at 2 sigma with standard
        deviation 0.02 (sigma = 0.02 / 0.8796, the JAX initializer's)."""
        if self.rpe_table is None:
            return
        std = 0.02 / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.rpe_table, 0.0, std, -2 * std,
                                  2 * std, generator=generator)

    def _group(self, qkv_p, kmask_p, gc_p, K: int, hd: int):
        """[G, K, 3, H, hd] -> [G * K, C] for one group of patches."""
        q, k, v = (qkv_p[:, :, i].transpose(1, 2) for i in range(3))
        q = q * scalar(hd ** -0.5, q.dtype)
        if self.compute_dtype is None:
            attn = q @ k.transpose(-1, -2)  # [G, H, K, K]
        else:
            attn = matmul_f32(q, k.transpose(-1, -2))
        if self.rpe_table is not None:
            attn = attn + rpe_bias(self.rpe_table, K, gc_p)
        attn = torch.where(kmask_p, attn, attn.new_tensor(-1e9))
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = attn @ v
        return out.transpose(1, 2).reshape(-1, out.shape[1] * hd)

    def forward(self, feat: torch.Tensor, order: torch.Tensor,
                inverse: torch.Tensor, count,
                grid_coord: Optional[torch.Tensor] = None) -> torch.Tensor:
        N, C = feat.shape
        K, H = min(self.patch_size, N), self.num_heads
        hd = C // H
        n_patches = -(-N // K)
        qkv = self.qkv(feat)
        j = torch.arange(n_patches * K, device=feat.device)
        pad_pos = torch.where(j < count, j, j - K)
        key_valid = (pad_pos >= 0) & (pad_pos < count)
        src = order.long()[pad_pos.clamp(0, N - 1)]
        qkv_s = qkv[src].reshape(n_patches, K, 3, H, hd)
        kmask = key_valid.reshape(n_patches, 1, 1, K)
        gc_s = None
        per_patch = 4 * H * K * K
        if self.rpe_table is not None:
            if grid_coord is None:
                raise ValueError("the relative-position bias needs the "
                                 "grid coordinates")
            gc_s = grid_coord.long()[src].reshape(n_patches, K, 3)
            per_patch += 16 * K * K
        group = max(1, min(n_patches, ATTN_CHUNK_BYTES // per_patch))
        remat = self.remat and torch.is_grad_enabled()
        outs = []
        for p0 in range(0, n_patches, group):
            args = (qkv_s[p0:p0 + group], kmask[p0:p0 + group],
                    None if gc_s is None else gc_s[p0:p0 + group], K, hd)
            outs.append(checkpoint(self._group, *args, use_reentrant=False)
                        if remat else self._group(*args))
        out = torch.cat(outs)[inverse.long()]
        return self.proj(out)


# ---------------------------------------------------------------------------
# packed samples
# ---------------------------------------------------------------------------


def sample_slices(counts: Sequence[int]) -> List[slice]:
    """The rows of each sample with points in a packed tensor (empty
    samples have none and are left out)."""
    out, start = [], 0
    for n in counts:
        if n:
            out.append(slice(start, start + n))
        start += n
    return out


# ---------------------------------------------------------------------------
# transformer block, pooling, unpooling
# ---------------------------------------------------------------------------


class PTBlock(nn.Module):
    """CPE (SubMConv k3 -> Linear -> LayerNorm, residual) -> attention
    (residual) -> MLP (residual).  Drop path at rate ``drop_path`` scales
    the attention and MLP branches (not CPE) by a per-point Bernoulli keep
    mask over ``1 - drop_path``; it is the identity in eval mode or at
    rate 0."""

    def __init__(self, channels: int, num_heads: int, patch_size: int,
                 mlp_ratio: float, order_index: int, enable_cpe: bool,
                 drop_path: float = 0.0, dtype: Optional[torch.dtype] = None,
                 remat: bool = False, enable_rpe: bool = False):
        super().__init__()
        self.order_index = order_index
        self.enable_cpe = enable_cpe
        self.drop_path = drop_path
        if enable_cpe:
            self.cpe_conv = SubMConv(channels, channels, 3, dtype, remat)
            self.cpe_fc = Dense(channels, channels, dtype=dtype)
            self.cpe_norm = LayerNormT(channels, dtype)
        self.norm1 = LayerNormT(channels, dtype)
        self.attn = PatchAttention(channels, num_heads, patch_size, dtype,
                                   remat, enable_rpe)
        self.norm2 = LayerNormT(channels, dtype)
        hidden = int(channels * mlp_ratio)
        self.mlp_fc1 = Dense(channels, hidden, dtype=dtype)
        self.mlp_fc2 = Dense(hidden, channels, dtype=dtype)

    def _drop_path(self, x: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.drop_path <= 0.0 or not self.training:
            return x
        if generator is None:
            raise ValueError("drop path in training mode needs a "
                             "torch.Generator on the features' device")
        keep = 1.0 - self.drop_path
        u = torch.rand((x.shape[0], 1), generator=generator,
                       device=x.device)
        return x * (u < keep).to(x.dtype) / scalar(keep, x.dtype)

    def forward(self, feat, state, dp_generator=None):
        """``state``: the level's packed ``order`` / ``inverse`` [O, M],
        ``grid_coord`` [M, 3], ``counts`` and ``nbrs``."""
        if self.enable_cpe:
            x = self.cpe_norm(self.cpe_fc(self.cpe_conv(feat,
                                                        state["nbrs"])))
            feat = feat + x
        x = self.norm1(feat)
        i = self.order_index
        outs = [self.attn(x[sl], state["order"][i, sl] - sl.start,
                          state["inverse"][i, sl] - sl.start,
                          sl.stop - sl.start, state["grid_coord"][sl])
                for sl in sample_slices(state["counts"])]
        x = torch.cat(outs) if len(outs) != 1 else outs[0]
        feat = feat + self._drop_path(x, dp_generator)
        x = self.mlp_fc2(gelu(self.mlp_fc1(self.norm2(feat))))
        return feat + self._drop_path(x, dp_generator)


def pool_clusters(codes: torch.Tensor, order: torch.Tensor, stride: int):
    """Clusters of one pooling step over one sample's points: points whose
    first-order code agrees after ``>> 3 * log2(stride)`` form a run of
    the sorted codes.  Returns (cluster id per point [N], sorted position
    of each cluster's head [n_clusters], pooling depth, sorted cluster id
    per slot [N])."""
    pooling_depth = (stride - 1).bit_length()
    o0 = order[0].long()
    code0 = codes[0][o0] >> (pooling_depth * 3)
    head = torch.ones_like(code0, dtype=torch.bool)
    head[1:] = code0[1:] != code0[:-1]
    seg_sorted = torch.cumsum(head.to(torch.int64), 0) - 1
    cluster = torch.empty_like(seg_sorted).scatter_(0, o0, seg_sorted)
    heads = torch.nonzero(head).squeeze(1)
    return cluster, heads, pooling_depth, seg_sorted


class SerializedPooling(nn.Module):
    """Linear -> segment max over the clusters -> BN -> GELU; the pooled
    level's coordinates are the cluster means, its grid coordinates and
    codes those of the cluster heads, shifted.  Clusters stay within a
    sample, and the level holds one point per cluster, so it cannot
    overflow.  The max's gradient is shared equally by the points of a
    cluster that tie for it, as the gradient of the JAX package's
    ``segment_max`` is (the -inf start keeps the start value out of the
    tie).

    forward(state) takes the level's packed ``feat``, ``coord``,
    ``grid_coord``, ``codes``, ``order``, ``inverse`` and ``counts`` (one
    sample of all rows when ``counts`` is absent) and returns the pooled
    level's and the cluster row of every point."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.stride = stride
        self.proj = Dense(in_channels, out_channels, dtype=dtype)
        self.norm = MaskedBatchNorm(out_channels, dtype)

    def forward(self, state: Dict[str, torch.Tensor]):
        codes, order = state["codes"], state["order"]
        clusters, segs, head_rows, new_codes, orders = [], [], [], [], []
        start = n_clusters = 0
        new_counts = []
        for n in state.get("counts", [codes.shape[1]]):
            sl = slice(start, start + n)
            start += n
            if not n:
                new_counts.append(0)
                continue
            cluster, heads, pdepth, seg = pool_clusters(
                codes[:, sl], order[:, sl] - sl.start, self.stride)
            head_local = order[0, sl].long()[heads] - sl.start
            clusters.append(cluster + n_clusters)
            segs.append(seg + n_clusters)
            head_rows.append(head_local + sl.start)
            new_codes.append(codes[:, sl][:, head_local] >> (pdepth * 3))
            o, inv = ser.sort_codes(new_codes[-1])
            orders.append((o + n_clusters, inv + n_clusters))
            new_counts.append(heads.shape[0])
            n_clusters += heads.shape[0]
        cluster, seg = torch.cat(clusters), torch.cat(segs)
        o0 = order[0].long()
        x = self.proj(state["feat"])[o0]
        idx = seg[:, None].expand(-1, x.shape[1])
        pooled = x.new_full((n_clusters, x.shape[1]), -math.inf
                            ).scatter_reduce(0, idx, x, reduce="amax",
                                             include_self=False)
        coord = state["coord"][o0]
        csum = coord.new_zeros((n_clusters, 3)).index_add_(0, seg, coord)
        ccnt = torch.bincount(seg, minlength=n_clusters).to(coord.dtype)
        return dict(
            feat=gelu(self.norm(pooled)),
            coord=csum / ccnt.clamp(min=1.0)[:, None],
            grid_coord=state["grid_coord"][torch.cat(head_rows)] >> pdepth,
            codes=torch.cat(new_codes, dim=1),
            order=torch.cat([o for o, _ in orders], dim=1),
            inverse=torch.cat([i for _, i in orders], dim=1),
            counts=new_counts,
        ), cluster


class SerializedUnpooling(nn.Module):
    """parent = GELU(BN(proj_skip(parent))) + GELU(BN(proj(child)))[cluster]."""

    def __init__(self, in_channels: int, skip_channels: int,
                 out_channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.proj = Dense(in_channels, out_channels, dtype=dtype)
        self.proj_norm = MaskedBatchNorm(out_channels, dtype)
        self.proj_skip = Dense(skip_channels, out_channels, dtype=dtype)
        self.proj_skip_norm = MaskedBatchNorm(out_channels, dtype)

    def forward(self, child_feat, parent_feat, cluster):
        x = gelu(self.proj_norm(self.proj(child_feat)))
        skip = gelu(self.proj_skip_norm(self.proj_skip(parent_feat)))
        return skip + x[cluster]


# ---------------------------------------------------------------------------
# backbone
# ---------------------------------------------------------------------------


def drop_path_rates(cfg: PTv3Config, drop_path: float
                    ) -> Tuple[List[float], Dict[int, List[float]]]:
    """The stochastic-depth schedule of the JAX package (upstream
    models/pt_v3.py:1226-1229): encoder block i of all stages gets
    ``drop_path * i / max(total - 1, 1)``; decoder stage s gets the slice
    of the decoder ramp at ``sum(dec_depths[:s])`` reversed, as the JAX
    package writes it (``ptv3.py:764-779``).  Returns (encoder rates in
    block order, {decoder stage: rates of its blocks})."""
    total_e = sum(cfg.enc_depths)
    enc = [drop_path * i / max(total_e - 1, 1) for i in range(total_e)]
    total_d = sum(cfg.dec_depths)
    dec_all = [drop_path * i / max(total_d - 1, 1) for i in range(total_d)]
    dec = {s: dec_all[sum(cfg.dec_depths[:s]):
                      sum(cfg.dec_depths[:s + 1])][::-1]
           for s in range(len(cfg.enc_depths) - 1)}
    return enc, dec


def no_drop_path(module: nn.Module) -> None:
    """Set the drop-path rate of every ``PTBlock`` under ``module`` to 0,
    for runs compared draw for draw with another package or device."""
    for m in module.modules():
        if isinstance(m, PTBlock):
            m.drop_path = 0.0


class PTv3Single(nn.Module):
    """PTv3 over packed samples: feat [M, in_channels] and coord [M, 3],
    the valid points of each sample one after another, ``counts`` rows a
    sample (one sample of M rows when None) -> [M, dec_channels[0]].

    ``forward`` takes the drop-path generator (needed in training mode at
    a positive rate) and an optional shuffle generator: with one, and with
    ``cfg.shuffle_orders`` and at least two orders, each sample's
    serialization orders are permuted after serializing and after every
    pooling, as the JAX package does when given a "shuffle" rng.  After
    each forward ``overflow`` holds the valid points that fell outside
    ``dense_nbr_extent``, summed over every neighbour search of the
    forward (a 0-dim int64 tensor on the features' device; 0 with the
    sorted search, ``dense_nbr_extent`` 0), ``unfound`` the neighbour
    slots not found over the forward's neighbour maps (the same kind of
    tensor; nothing reads it on the way) and ``slots`` the maps' K^3 x M
    slots (an int)."""

    def __init__(self, cfg: PTv3Config, in_channels: int,
                 grid_size: float = 0.01, serial_depth: int = 10,
                 drop_path: float = 0.3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.grid_size = grid_size
        self.serial_depth = serial_depth
        self.out_channels = (cfg.dec_channels[0] if len(cfg.enc_depths) > 1
                             else cfg.enc_channels[0])
        self.overflow: Optional[torch.Tensor] = None
        self.unfound: Optional[torch.Tensor] = None
        self.slots = 0
        n_orders = len(cfg.order)
        enc_dp, dec_dp = drop_path_rates(cfg, drop_path)
        blk = dict(dtype=dtype, remat=cfg.remat, enable_rpe=cfg.enable_rpe)
        self.embedding_stem = SubMConv(in_channels, cfg.enc_channels[0], 5,
                                       dtype, cfg.remat)
        self.embedding_norm = MaskedBatchNorm(cfg.enc_channels[0], dtype)
        n_stages = len(cfg.enc_depths)
        for s in range(n_stages):
            if s > 0:
                setattr(self, f"enc{s}_down", SerializedPooling(
                    cfg.enc_channels[s - 1], cfg.enc_channels[s],
                    cfg.stride[s - 1], dtype))
            for b in range(cfg.enc_depths[s]):
                setattr(self, f"enc{s}_block{b}", PTBlock(
                    cfg.enc_channels[s], cfg.enc_n_head[s],
                    cfg.enc_patch_size[s], cfg.mlp_ratio, b % n_orders,
                    cfg.enable_cpe, enc_dp[sum(cfg.enc_depths[:s]) + b],
                    **blk))
        dec_channels = list(cfg.dec_channels) + [cfg.enc_channels[-1]]
        for s in reversed(range(n_stages - 1)):
            setattr(self, f"dec{s}_up", SerializedUnpooling(
                dec_channels[s + 1], cfg.enc_channels[s], dec_channels[s],
                dtype))
            for b in range(cfg.dec_depths[s]):
                setattr(self, f"dec{s}_block{b}", PTBlock(
                    dec_channels[s], cfg.dec_n_head[s],
                    cfg.dec_patch_size[s], cfg.mlp_ratio, b % n_orders,
                    cfg.enable_cpe, dec_dp[s][b], **blk))

    def _neighbors(self, grid_coord: torch.Tensor, counts, k: int):
        """Each sample's neighbours, packed: [K^3, M] rows, found."""
        nbs, fnds = [], []
        for sl in sample_slices(counts):
            g = grid_coord[sl]
            valid = torch.ones(g.shape[0], dtype=torch.bool,
                               device=g.device)
            if self.cfg.dense_nbr_extent > 0:
                nb, found, overflow = subm_neighbors_dense(
                    g, valid, k, self.cfg.dense_nbr_extent)
                self.overflow = self.overflow + overflow
            else:
                nb, found = subm_neighbors(g, valid, k, self.serial_depth)
            nbs.append(nb + sl.start)
            fnds.append(found)
        if len(nbs) == 1:
            nb, found = nbs[0], fnds[0]
        else:
            nb, found = torch.cat(nbs, dim=1), torch.cat(fnds, dim=1)
        self.unfound = self.unfound + (~found).sum()
        self.slots += found.numel()
        return nb, found

    def _shuffle(self, state, generator: Optional[torch.Generator]) -> None:
        n_orders = state["codes"].shape[0]
        if (not self.cfg.shuffle_orders or n_orders < 2
                or generator is None):
            return
        perms = [(sl, torch.randperm(n_orders, generator=generator,
                                     device=generator.device).to(
                                         state["codes"].device))
                 for sl in sample_slices(state["counts"])]
        for k in ("codes", "order", "inverse"):
            if len(perms) == 1:
                state[k] = state[k][perms[0][1]]
            else:
                state[k] = torch.cat([state[k][perm][:, sl]
                                      for sl, perm in perms], dim=1)

    def _blocks(self, prefix: str, depth: int, state,
                dp_generator: Optional[torch.Generator]) -> None:
        for b in range(depth):
            state["feat"] = getattr(self, f"{prefix}_block{b}")(
                state["feat"], state, dp_generator)

    def _serialize(self, coord: torch.Tensor, counts):
        parts = []
        for sl in sample_slices(counts):
            valid = torch.ones(sl.stop - sl.start, dtype=torch.bool,
                               device=coord.device)
            g, codes, order, inverse = ser.serialize(
                coord[sl], valid, self.grid_size, tuple(self.cfg.order),
                self.serial_depth)
            parts.append((g, codes, order + sl.start, inverse + sl.start))
        g, codes, order, inverse = zip(*parts)
        return dict(coord=coord, counts=list(counts), grid_coord=torch.cat(g),
                    codes=torch.cat(codes, 1), order=torch.cat(order, 1),
                    inverse=torch.cat(inverse, 1))

    def forward(self, feat: torch.Tensor, coord: torch.Tensor,
                dp_generator: Optional[torch.Generator] = None,
                shuffle_generator: Optional[torch.Generator] = None,
                counts: Optional[Sequence[int]] = None) -> torch.Tensor:
        cfg = self.cfg
        counts = [feat.shape[0]] if counts is None else list(counts)
        self.overflow = torch.zeros((), dtype=torch.int64,
                                    device=feat.device)
        self.unfound = torch.zeros_like(self.overflow)
        self.slots = 0
        if feat.shape[0] == 0:
            return feat.new_zeros((0, self.out_channels))
        levels: List[Tuple[dict, torch.Tensor]] = []
        n_stages = len(cfg.enc_depths)
        for s in range(n_stages):
            with profiling.span(f"ptv3.enc{s}"):
                if s == 0:  # the serialisation and the embedding
                    state = self._serialize(coord, counts)
                    self._shuffle(state, shuffle_generator)
                    x = self.embedding_stem(feat, self._neighbors(
                        state["grid_coord"], counts, 5))
                    state["feat"] = gelu(self.embedding_norm(x))
                    if cfg.enable_cpe:
                        state["nbrs"] = self._neighbors(state["grid_coord"],
                                                        counts, 3)
                else:
                    pooled, cluster = getattr(self, f"enc{s}_down")(state)
                    levels.append((state, cluster))
                    state = pooled
                    self._shuffle(state, shuffle_generator)
                    if cfg.enable_cpe:
                        state["nbrs"] = self._neighbors(state["grid_coord"],
                                                        state["counts"], 3)
                self._blocks(f"enc{s}", cfg.enc_depths[s], state,
                             dp_generator)
        for s in reversed(range(n_stages - 1)):
            with profiling.span(f"ptv3.dec{s}"):
                parent, cluster = levels[s]
                up = getattr(self, f"dec{s}_up")(state["feat"],
                                                 parent["feat"], cluster)
                state = dict(parent)
                state["feat"] = up
                self._blocks(f"dec{s}", cfg.dec_depths[s], state,
                             dp_generator)
        return state["feat"]


class PointTransformerV3(nn.Module):
    """Batched wrapper: feat [B, N, C], coord [B, N, 3], valid [B, N] ->
    [B, N, out_channels].  The samples' valid points run packed through
    ``PTv3Single`` (training mode at any B: the BatchNorm statistics span
    every sample's valid points); invalid rows of the output are 0.
    ``overflow`` holds the samples' dense-neighbour overflow, summed,
    after each forward."""

    def __init__(self, cfg: PTv3Config, in_channels: int,
                 grid_size: float = 0.01, serial_depth: int = 10,
                 drop_path: float = 0.3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.net = PTv3Single(cfg, in_channels, grid_size, serial_depth,
                              drop_path, dtype)
        self.overflow: Optional[torch.Tensor] = None

    @property
    def out_channels(self) -> int:
        return self.net.out_channels

    def forward(self, feat: torch.Tensor, coord: torch.Tensor,
                valid: Optional[torch.Tensor] = None,
                dp_generator: Optional[torch.Generator] = None,
                shuffle_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        with profiling.span("ptv3"):
            B, N = feat.shape[:2]
            gens = (dp_generator, shuffle_generator)
            with profiling.span("sync.ptv3_pack"):
                dense = valid is None or bool(valid.all())
                if not dense:
                    rows = torch.nonzero(valid.reshape(-1)).squeeze(1)
                    counts = valid.sum(dim=1).tolist()
            if dense:
                out = self.net(feat.reshape(B * N, -1),
                               coord.reshape(B * N, 3), *gens, counts=[N] * B)
                self.overflow = self.net.overflow
                return out.reshape(B, N, -1)
            packed = self.net(feat.reshape(B * N, -1)[rows],
                              coord.reshape(B * N, 3)[rows], *gens,
                              counts=counts)
            self.overflow = self.net.overflow
            out = packed.new_zeros((B * N, self.out_channels))
            out[rows] = packed
            return out.reshape(B, N, -1)
