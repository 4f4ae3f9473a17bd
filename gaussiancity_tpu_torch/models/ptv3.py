# -*- coding: utf-8 -*-
"""Point Transformer V3, the serving (eval) path (counterpart of
``gaussiancity_tpu/models/ptv3.py``; upstream models/pt_v3.py:1137-1344).

Serialized point-cloud U-Net: a k5 submanifold-conv stem, encoder stages
of transformer blocks (CPE conv, patch attention along a space-filling
curve, MLP) joined by serialized pooling, and a decoder of unpooling plus
blocks.  Submodule and parameter names mirror the Flax tree, so that
``interop.py`` carries weights and ``batch_stats`` across one to one.

What differs from the JAX package, by design:

- one sample at a time over its valid points only, unpadded: the JAX
  package's padded slabs, validity masks and static pooled capacities
  (``pool_capacity_divisor``) are TPU machinery.  Each pooled level has
  exactly its cluster count of points, as upstream's ``torch.unique``
  gives; the result equals the JAX package's wherever its pooled-capacity
  overflow counter reads 0;
- eval only.  ``MaskedBatchNorm`` normalises with its running statistics;
  drop path is the identity.  A module in training mode raises
  ``NotImplementedError``, as do ``enable_rpe`` and the sorted-merge
  neighbour search (``dense_nbr_extent == 0``): later slices.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gaussiancity_tpu_torch.config import PTv3Config
from gaussiancity_tpu_torch.ops import serialization as ser

# the [G, H, K, K] logits of one chunk of patches stay under this many bytes
ATTN_CHUNK_BYTES = 256 * 1024 * 1024


def _eval_only(module: nn.Module) -> None:
    if module.training:
        raise NotImplementedError(
            "PTv3 runs in eval mode only in the PyTorch port: the "
            "MaskedBatchNorm train statistics and drop path are a later "
            "slice (call .eval())")


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)  # exact (erf) GELU


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d (eps 1e-3) normalising with its running statistics,
    which live in the buffers ``mean`` and ``var`` (the Flax
    ``batch_stats`` collection)."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
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
        _eval_only(self)
        y = (x - self.mean) * torch.rsqrt(self.var + self.eps)
        return y * self.scale + self.bias


def layer_norm(channels: int) -> nn.LayerNorm:
    return nn.LayerNorm(channels, eps=1e-5)


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
    offset holds a point, ``nb_idx`` is that point's id (clamped to N - 1
    where none), and ``overflow`` counts the valid points outside the
    extent (they write nothing, and their neighbours are not found)."""
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
    return torch.clamp(j, max=max(N - 1, 0)), found, overflow


class SubMConv(nn.Module):
    """Submanifold sparse convolution: output at the active sites only,
    one product per kernel offset over the gathered neighbour features.
    ``kernel`` is [K^3, C, F] (the Flax layout)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int):
        super().__init__()
        n_offs = kernel_size ** 3
        self.kernel_size = kernel_size
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
        acc = feat.new_zeros((feat.shape[0], self.kernel.shape[2]))
        for k in range(self.kernel.shape[0]):
            nb = feat[nb_idx[k].long()] * found[k][:, None].to(feat.dtype)
            acc = acc + nb @ self.kernel[k]
        return acc + self.bias


# ---------------------------------------------------------------------------
# serialized patch attention
# ---------------------------------------------------------------------------


class PatchAttention(nn.Module):
    """Dense attention within patches of ``patch_size`` consecutive points
    along a serialized order.

    forward(feat [N, C], order [N], inverse [N], count) -> [N, C], where the
    first ``count`` entries of ``order`` are the valid points.  The last
    partial patch wraps around as upstream's does: pad slot ``j`` repeats
    slot ``j - patch_size``; slots that name no valid point are masked
    keys (logit -1e9).  The softmax runs in float32.  A sample of fewer
    than ``patch_size`` points is one patch of its own size."""

    def __init__(self, channels: int, num_heads: int, patch_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.patch_size = patch_size
        self.qkv = nn.Linear(channels, 3 * channels)
        self.proj = nn.Linear(channels, channels)

    def forward(self, feat: torch.Tensor, order: torch.Tensor,
                inverse: torch.Tensor, count) -> torch.Tensor:
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
        group = max(1, min(n_patches, ATTN_CHUNK_BYTES // (4 * H * K * K)))
        outs = []
        for p0 in range(0, n_patches, group):
            qkv_p = qkv_s[p0:p0 + group]
            q, k, v = (qkv_p[:, :, i].transpose(1, 2) for i in range(3))
            attn = (q * hd ** -0.5) @ k.transpose(-1, -2)  # [G, H, K, K]
            attn = torch.where(kmask[p0:p0 + group], attn,
                               attn.new_tensor(-1e9))
            attn = torch.softmax(attn, dim=-1)
            outs.append((attn @ v).transpose(1, 2).reshape(-1, C))
        out = torch.cat(outs)[inverse.long()]
        return self.proj(out)


# ---------------------------------------------------------------------------
# transformer block, pooling, unpooling
# ---------------------------------------------------------------------------


class PTBlock(nn.Module):
    """CPE (SubMConv k3 -> Linear -> LayerNorm, residual) -> attention
    (residual) -> MLP (residual); drop path is the identity in eval."""

    def __init__(self, channels: int, num_heads: int, patch_size: int,
                 mlp_ratio: float, order_index: int, enable_cpe: bool):
        super().__init__()
        self.order_index = order_index
        self.enable_cpe = enable_cpe
        if enable_cpe:
            self.cpe_conv = SubMConv(channels, channels, 3)
            self.cpe_fc = nn.Linear(channels, channels)
            self.cpe_norm = layer_norm(channels)
        self.norm1 = layer_norm(channels)
        self.attn = PatchAttention(channels, num_heads, patch_size)
        self.norm2 = layer_norm(channels)
        hidden = int(channels * mlp_ratio)
        self.mlp_fc1 = nn.Linear(channels, hidden)
        self.mlp_fc2 = nn.Linear(hidden, channels)

    def forward(self, feat, orders_data, count, neighbors):
        order, inverse = orders_data[self.order_index]
        if self.enable_cpe:
            x = self.cpe_norm(self.cpe_fc(self.cpe_conv(feat, neighbors)))
            feat = feat + x
        feat = feat + self.attn(self.norm1(feat), order, inverse, count)
        x = self.mlp_fc2(gelu(self.mlp_fc1(self.norm2(feat))))
        return feat + x


def pool_clusters(codes: torch.Tensor, order: torch.Tensor, stride: int):
    """Clusters of one pooling step over all-valid points: points whose
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
    codes those of the cluster heads, shifted."""

    def __init__(self, in_channels: int, out_channels: int, stride: int):
        super().__init__()
        self.stride = stride
        self.proj = nn.Linear(in_channels, out_channels)
        self.norm = MaskedBatchNorm(out_channels)

    def forward(self, state: Dict[str, torch.Tensor]):
        codes, order = state["codes"], state["order"]
        cluster, heads, pdepth, seg = pool_clusters(codes, order,
                                                    self.stride)
        n_clusters = heads.shape[0]
        o0 = order[0].long()
        x = self.proj(state["feat"])[o0]
        idx = seg[:, None].expand(-1, x.shape[1])
        pooled = x.new_zeros((n_clusters, x.shape[1])).scatter_reduce_(
            0, idx, x, reduce="amax", include_self=False)
        coord = state["coord"][o0]
        csum = coord.new_zeros((n_clusters, 3)).index_add_(0, seg, coord)
        ccnt = torch.bincount(seg, minlength=n_clusters).to(coord.dtype)
        head_orig = o0[heads]
        new_codes = codes[:, head_orig] >> (pdepth * 3)
        new_order, new_inverse = ser.sort_codes(new_codes)
        return dict(
            feat=gelu(self.norm(pooled)),
            coord=csum / ccnt.clamp(min=1.0)[:, None],
            grid_coord=state["grid_coord"][head_orig] >> pdepth,
            codes=new_codes, order=new_order, inverse=new_inverse,
        ), cluster


class SerializedUnpooling(nn.Module):
    """parent = GELU(BN(proj_skip(parent))) + GELU(BN(proj(child)))[cluster]."""

    def __init__(self, in_channels: int, skip_channels: int,
                 out_channels: int):
        super().__init__()
        self.proj = nn.Linear(in_channels, out_channels)
        self.proj_norm = MaskedBatchNorm(out_channels)
        self.proj_skip = nn.Linear(skip_channels, out_channels)
        self.proj_skip_norm = MaskedBatchNorm(out_channels)

    def forward(self, child_feat, parent_feat, cluster):
        x = gelu(self.proj_norm(self.proj(child_feat)))
        skip = gelu(self.proj_skip_norm(self.proj_skip(parent_feat)))
        return skip + x[cluster]


# ---------------------------------------------------------------------------
# backbone
# ---------------------------------------------------------------------------


class PTv3Single(nn.Module):
    """PTv3 over the valid points of one sample: feat [n, in_channels],
    coord [n, 3] -> [n, dec_channels[0]]."""

    def __init__(self, cfg: PTv3Config, in_channels: int,
                 grid_size: float = 0.01, serial_depth: int = 10):
        super().__init__()
        if cfg.enable_rpe:
            raise NotImplementedError(
                "relative-position attention bias (enable_rpe) is a later "
                "slice of the PyTorch port")
        if cfg.dense_nbr_extent <= 0:
            raise NotImplementedError(
                "the sorted-merge neighbour search (dense_nbr_extent 0) is "
                "a later slice of the PyTorch port")
        self.cfg = cfg
        self.grid_size = grid_size
        self.serial_depth = serial_depth
        self.out_channels = (cfg.dec_channels[0] if len(cfg.enc_depths) > 1
                             else cfg.enc_channels[0])
        n_orders = len(cfg.order)
        self.embedding_stem = SubMConv(in_channels, cfg.enc_channels[0], 5)
        self.embedding_norm = MaskedBatchNorm(cfg.enc_channels[0])
        n_stages = len(cfg.enc_depths)
        for s in range(n_stages):
            if s > 0:
                setattr(self, f"enc{s}_down", SerializedPooling(
                    cfg.enc_channels[s - 1], cfg.enc_channels[s],
                    cfg.stride[s - 1]))
            for b in range(cfg.enc_depths[s]):
                setattr(self, f"enc{s}_block{b}", PTBlock(
                    cfg.enc_channels[s], cfg.enc_n_head[s],
                    cfg.enc_patch_size[s], cfg.mlp_ratio, b % n_orders,
                    cfg.enable_cpe))
        dec_channels = list(cfg.dec_channels) + [cfg.enc_channels[-1]]
        for s in reversed(range(n_stages - 1)):
            setattr(self, f"dec{s}_up", SerializedUnpooling(
                dec_channels[s + 1], cfg.enc_channels[s], dec_channels[s]))
            for b in range(cfg.dec_depths[s]):
                setattr(self, f"dec{s}_block{b}", PTBlock(
                    dec_channels[s], cfg.dec_n_head[s],
                    cfg.dec_patch_size[s], cfg.mlp_ratio, b % n_orders,
                    cfg.enable_cpe))

    def _neighbors(self, grid_coord: torch.Tensor, k: int):
        valid = torch.ones(grid_coord.shape[0], dtype=torch.bool,
                           device=grid_coord.device)
        return subm_neighbors_dense(grid_coord, valid, k,
                                    self.cfg.dense_nbr_extent)[:2]

    def _blocks(self, prefix: str, depth: int, state) -> None:
        n = state["feat"].shape[0]
        orders_data = [(state["order"][i], state["inverse"][i])
                       for i in range(len(self.cfg.order))]
        for b in range(depth):
            state["feat"] = getattr(self, f"{prefix}_block{b}")(
                state["feat"], orders_data, n, state.get("nbrs"))

    def forward(self, feat: torch.Tensor, coord: torch.Tensor
                ) -> torch.Tensor:
        _eval_only(self)
        cfg = self.cfg
        n = feat.shape[0]
        if n == 0:
            return feat.new_zeros((0, self.out_channels))
        valid = torch.ones(n, dtype=torch.bool, device=feat.device)
        grid_coord, codes, order, inverse = ser.serialize(
            coord, valid, self.grid_size, tuple(cfg.order),
            self.serial_depth)
        x = self.embedding_stem(feat, self._neighbors(grid_coord, 5))
        x = gelu(self.embedding_norm(x))
        state = dict(feat=x, coord=coord, grid_coord=grid_coord,
                     codes=codes, order=order, inverse=inverse)
        if cfg.enable_cpe:
            state["nbrs"] = self._neighbors(grid_coord, 3)
        levels: List[Tuple[dict, torch.Tensor]] = []
        n_stages = len(cfg.enc_depths)
        for s in range(n_stages):
            if s > 0:
                pooled, cluster = getattr(self, f"enc{s}_down")(state)
                levels.append((state, cluster))
                state = pooled
                if cfg.enable_cpe:
                    state["nbrs"] = self._neighbors(state["grid_coord"], 3)
            self._blocks(f"enc{s}", cfg.enc_depths[s], state)
        for s in reversed(range(n_stages - 1)):
            parent, cluster = levels[s]
            up = getattr(self, f"dec{s}_up")(state["feat"], parent["feat"],
                                             cluster)
            state = dict(parent)
            state["feat"] = up
            self._blocks(f"dec{s}", cfg.dec_depths[s], state)
        return state["feat"]


class PointTransformerV3(nn.Module):
    """Batched wrapper: feat [B, N, C], coord [B, N, 3], valid [B, N] ->
    [B, N, out_channels].  Each sample runs on its valid points alone;
    invalid rows of the output are 0."""

    def __init__(self, cfg: PTv3Config, in_channels: int,
                 grid_size: float = 0.01, serial_depth: int = 10):
        super().__init__()
        self.net = PTv3Single(cfg, in_channels, grid_size, serial_depth)

    @property
    def out_channels(self) -> int:
        return self.net.out_channels

    def forward(self, feat: torch.Tensor, coord: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, N = feat.shape[:2]
        outs = []
        for b in range(B):
            if valid is None or bool(valid[b].all()):
                outs.append(self.net(feat[b], coord[b]))
                continue
            keep = torch.nonzero(valid[b]).squeeze(1)
            out = feat.new_zeros((N, self.out_channels))
            out[keep] = self.net(feat[b][keep], coord[b][keep])
            outs.append(out)
        return torch.stack(outs)
