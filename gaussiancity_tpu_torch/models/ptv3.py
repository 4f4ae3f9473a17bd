# -*- coding: utf-8 -*-
"""Point Transformer V3 (counterpart of ``gaussiancity_tpu/models/ptv3.py``;
upstream models/pt_v3.py:1137-1344).

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
  overflow counter reads 0.  So the pooling part of the JAX package's
  ``PTv3PoolOverflow`` diagnostic is 0 here by construction; the part
  that remains is the dense-neighbour overflow (valid points outside
  ``dense_nbr_extent``), which ``PTv3Single.overflow`` holds after each
  forward;
- the module's mode stands for the JAX ``train`` flag.  In training mode
  ``MaskedBatchNorm`` normalises with the batch statistics and folds them
  into its running averages, and drop path draws its masks from the
  ``torch.Generator`` the caller passes.  Since each sample runs alone,
  training mode takes one sample at a time (the JAX ``Trainer`` takes
  batch size 1 per device); B > 1 raises ``NotImplementedError``, as do
  ``enable_rpe`` and the sorted-merge neighbour search
  (``dense_nbr_extent == 0``): later slices.
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


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)  # exact (erf) GELU


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d (eps 1e-3, momentum 0.01) over the rows it is given, the
    valid points of one sample.  The running statistics live in the
    buffers ``mean`` and ``var`` (the Flax ``batch_stats`` collection).

    Eval normalises with them.  Training normalises with the batch mean
    and the biased variance, taken in two passes as the JAX package takes
    them (autograd flows through both), and folds the batch mean and the
    unbiased variance (denominator ``max(n - 1, 1)``) into the running
    averages: ``new = (1 - momentum) * old + momentum * batch``."""

    EPS = 1e-3
    MOMENTUM = 0.01

    def __init__(self, channels: int):
        super().__init__()
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
        if not self.training:
            y = (x - self.mean) * torch.rsqrt(self.var + self.EPS)
            return y * self.scale + self.bias
        n = max(x.shape[0], 1)
        mean = x.sum(dim=0) / n
        vs = ((x - mean) ** 2).sum(dim=0)
        with torch.no_grad():
            mom = self.MOMENTUM
            self.mean.copy_((1.0 - mom) * self.mean + mom * mean)
            self.var.copy_((1.0 - mom) * self.var
                           + mom * (vs / max(n - 1, 1)))
        y = (x - mean) * torch.rsqrt(vs / n + self.EPS)
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
    (residual) -> MLP (residual).  Drop path at rate ``drop_path`` scales
    the attention and MLP branches (not CPE) by a per-point Bernoulli keep
    mask over ``1 - drop_path``; it is the identity in eval mode or at
    rate 0."""

    def __init__(self, channels: int, num_heads: int, patch_size: int,
                 mlp_ratio: float, order_index: int, enable_cpe: bool,
                 drop_path: float = 0.0):
        super().__init__()
        self.order_index = order_index
        self.enable_cpe = enable_cpe
        self.drop_path = drop_path
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
        return x * (u < keep).to(x.dtype) / keep

    def forward(self, feat, orders_data, count, neighbors,
                dp_generator: Optional[torch.Generator] = None):
        order, inverse = orders_data[self.order_index]
        if self.enable_cpe:
            x = self.cpe_norm(self.cpe_fc(self.cpe_conv(feat, neighbors)))
            feat = feat + x
        x = self.attn(self.norm1(feat), order, inverse, count)
        feat = feat + self._drop_path(x, dp_generator)
        x = self.mlp_fc2(gelu(self.mlp_fc1(self.norm2(feat))))
        return feat + self._drop_path(x, dp_generator)


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
    codes those of the cluster heads, shifted.  The level holds one point
    per cluster, so it cannot overflow.  The max's gradient is shared
    equally by the points of a cluster that tie for it, as the gradient of
    the JAX package's ``segment_max`` is (the -inf start keeps the start
    value out of the tie)."""

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
        pooled = x.new_full((n_clusters, x.shape[1]), -math.inf
                            ).scatter_reduce(0, idx, x, reduce="amax",
                                             include_self=False)
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
    """PTv3 over the valid points of one sample: feat [n, in_channels],
    coord [n, 3] -> [n, dec_channels[0]].

    ``forward`` takes the drop-path generator (needed in training mode at
    a positive rate) and an optional shuffle generator: with one, and with
    ``cfg.shuffle_orders`` and at least two orders, the serialization
    orders are permuted after serializing and after every pooling, as the
    JAX package does when given a "shuffle" rng.  After each forward
    ``overflow`` holds the valid points that fell outside
    ``dense_nbr_extent``, summed over every neighbour search of the
    forward (a 0-dim int64 tensor on the features' device)."""

    def __init__(self, cfg: PTv3Config, in_channels: int,
                 grid_size: float = 0.01, serial_depth: int = 10,
                 drop_path: float = 0.3):
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
        self.overflow: Optional[torch.Tensor] = None
        n_orders = len(cfg.order)
        enc_dp, dec_dp = drop_path_rates(cfg, drop_path)
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
                    cfg.enable_cpe, enc_dp[sum(cfg.enc_depths[:s]) + b]))
        dec_channels = list(cfg.dec_channels) + [cfg.enc_channels[-1]]
        for s in reversed(range(n_stages - 1)):
            setattr(self, f"dec{s}_up", SerializedUnpooling(
                dec_channels[s + 1], cfg.enc_channels[s], dec_channels[s]))
            for b in range(cfg.dec_depths[s]):
                setattr(self, f"dec{s}_block{b}", PTBlock(
                    dec_channels[s], cfg.dec_n_head[s],
                    cfg.dec_patch_size[s], cfg.mlp_ratio, b % n_orders,
                    cfg.enable_cpe, dec_dp[s][b]))

    def _neighbors(self, grid_coord: torch.Tensor, k: int):
        valid = torch.ones(grid_coord.shape[0], dtype=torch.bool,
                           device=grid_coord.device)
        nb, found, overflow = subm_neighbors_dense(
            grid_coord, valid, k, self.cfg.dense_nbr_extent)
        self.overflow = self.overflow + overflow
        return nb, found

    def _shuffle(self, state, generator: Optional[torch.Generator]) -> None:
        n_orders = state["codes"].shape[0]
        if (not self.cfg.shuffle_orders or n_orders < 2
                or generator is None):
            return
        perm = torch.randperm(n_orders, generator=generator,
                              device=generator.device).to(
                                  state["codes"].device)
        for k in ("codes", "order", "inverse"):
            state[k] = state[k][perm]

    def _blocks(self, prefix: str, depth: int, state,
                dp_generator: Optional[torch.Generator]) -> None:
        n = state["feat"].shape[0]
        orders_data = [(state["order"][i], state["inverse"][i])
                       for i in range(len(self.cfg.order))]
        for b in range(depth):
            state["feat"] = getattr(self, f"{prefix}_block{b}")(
                state["feat"], orders_data, n, state.get("nbrs"),
                dp_generator)

    def forward(self, feat: torch.Tensor, coord: torch.Tensor,
                dp_generator: Optional[torch.Generator] = None,
                shuffle_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        cfg = self.cfg
        n = feat.shape[0]
        self.overflow = torch.zeros((), dtype=torch.int64,
                                    device=feat.device)
        if n == 0:
            return feat.new_zeros((0, self.out_channels))
        valid = torch.ones(n, dtype=torch.bool, device=feat.device)
        grid_coord, codes, order, inverse = ser.serialize(
            coord, valid, self.grid_size, tuple(cfg.order),
            self.serial_depth)
        state = dict(coord=coord, grid_coord=grid_coord, codes=codes,
                     order=order, inverse=inverse)
        self._shuffle(state, shuffle_generator)
        x = self.embedding_stem(feat, self._neighbors(grid_coord, 5))
        state["feat"] = gelu(self.embedding_norm(x))
        if cfg.enable_cpe:
            state["nbrs"] = self._neighbors(grid_coord, 3)
        levels: List[Tuple[dict, torch.Tensor]] = []
        n_stages = len(cfg.enc_depths)
        for s in range(n_stages):
            if s > 0:
                pooled, cluster = getattr(self, f"enc{s}_down")(state)
                levels.append((state, cluster))
                state = pooled
                self._shuffle(state, shuffle_generator)
                if cfg.enable_cpe:
                    state["nbrs"] = self._neighbors(state["grid_coord"], 3)
            self._blocks(f"enc{s}", cfg.enc_depths[s], state, dp_generator)
        for s in reversed(range(n_stages - 1)):
            parent, cluster = levels[s]
            up = getattr(self, f"dec{s}_up")(state["feat"], parent["feat"],
                                             cluster)
            state = dict(parent)
            state["feat"] = up
            self._blocks(f"dec{s}", cfg.dec_depths[s], state, dp_generator)
        return state["feat"]


class PointTransformerV3(nn.Module):
    """Batched wrapper: feat [B, N, C], coord [B, N, 3], valid [B, N] ->
    [B, N, out_channels].  Each sample runs on its valid points alone;
    invalid rows of the output are 0.  ``overflow`` holds the samples'
    dense-neighbour overflow, summed, after each forward.

    In training mode the batch statistics of ``MaskedBatchNorm`` would
    have to span every sample's valid points, as the JAX package's
    ``nn.vmap`` axis makes them; running one sample at a time cannot, so
    training mode takes B = 1 and raises ``NotImplementedError`` above."""

    def __init__(self, cfg: PTv3Config, in_channels: int,
                 grid_size: float = 0.01, serial_depth: int = 10,
                 drop_path: float = 0.3):
        super().__init__()
        self.net = PTv3Single(cfg, in_channels, grid_size, serial_depth,
                              drop_path)
        self.overflow: Optional[torch.Tensor] = None

    @property
    def out_channels(self) -> int:
        return self.net.out_channels

    def forward(self, feat: torch.Tensor, coord: torch.Tensor,
                valid: Optional[torch.Tensor] = None,
                dp_generator: Optional[torch.Generator] = None,
                shuffle_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        B, N = feat.shape[:2]
        if self.training and B > 1:
            raise NotImplementedError(
                "PTv3 in training mode takes one sample at a time in the "
                "PyTorch port: its BatchNorm statistics cannot span the "
                f"samples of a batch (got B={B})")
        outs = []
        overflow = torch.zeros((), dtype=torch.int64, device=feat.device)
        for b in range(B):
            gens = (dp_generator, shuffle_generator)
            if valid is None or bool(valid[b].all()):
                outs.append(self.net(feat[b], coord[b], *gens))
            else:
                keep = torch.nonzero(valid[b]).squeeze(1)
                out = feat.new_zeros((N, self.out_channels))
                out[keep] = self.net(feat[b][keep], coord[b][keep], *gens)
                outs.append(out)
            overflow = overflow + self.net.overflow
        self.overflow = overflow
        return torch.stack(outs)
