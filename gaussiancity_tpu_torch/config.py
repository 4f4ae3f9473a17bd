# -*- coding: utf-8 -*-
"""Configuration tree for the PyTorch port.

The port's own copy of the JAX package's dataclasses (same field names and
defaults, so a config written by either package loads in the other) and the
REST recipe preset.  Configs are frozen dataclasses that serialize to and
from nested dicts / JSON.

Some rasterizer fields shape the JAX package's static-shape binning
(``max_tiles_per_gaussian``, ``bin_tiers``, ``visible_cap``, ``chunk``,
``page``, ``backend``).  The port bins dynamically and ignores them; they
stay so that configs round-trip unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


def _asdict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _asdict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_asdict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _asdict(v) for k, v in obj.items()}
    return obj


def _fromdict(cls: Any, data: Any) -> Any:
    if not (dataclasses.is_dataclass(cls) and isinstance(data, dict)):
        return data
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        ftype = hints.get(f.name, f.type)
        if getattr(ftype, "__origin__", None) is typing.Union:
            args = [a for a in ftype.__args__ if a is not type(None)]
            if len(args) == 1:
                ftype = args[0]
        if dataclasses.is_dataclass(ftype) and isinstance(v, dict):
            kwargs[f.name] = _fromdict(ftype, v)
        elif isinstance(v, (list, tuple)):
            # nested tuples (bin_tiers) stay hashable after JSON
            kwargs[f.name] = tuple(
                tuple(e) if isinstance(e, (list, tuple)) else e for e in v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


class _Base:
    def to_dict(self) -> Dict[str, Any]:
        return _asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]):
        return _fromdict(cls, data)

    @classmethod
    def from_json(cls, s: str):
        return cls.from_dict(json.loads(s))

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)


# ---------------------------------------------------------------------------
# Datasets
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DatasetConfig(_Base):
    name: str = "GOOGLE_EARTH"
    dir: str = "./data/google-earth"
    pin_memory: Tuple[str, ...] = ("Rt", "centers")
    n_repeat: int = 1
    n_cities: int = 400
    n_views: int = 60
    train_n_instances: Optional[int] = None
    train_instance_range: Optional[Tuple[int, int]] = None
    train_crop_size: Tuple[int, int] = (448, 448)
    test_n_instances: Optional[int] = None
    test_instance_range: Optional[Tuple[int, int]] = None
    test_crop_size: Tuple[int, int] = (720, 405)
    train_min_pixels: int = 64
    train_max_points: int = 16384
    cam_k: Tuple[float, ...] = (
        1528.1469407006614, 0.0, 480.0,
        0.0, 1528.1469407006614, 270.0,
        0.0, 0.0, 1.0,
    )
    sensor_size: Tuple[int, int] = (960, 540)  # (W, H)
    flip_ud: bool = False
    n_classes: int = 8
    proj_size: int = 2048
    bldg_range: Tuple[int, int] = (100, 32768)
    bldg_facade_clsid: int = 2
    bldg_roof_clsid: int = 7
    car_range: Optional[Tuple[int, int]] = None
    car_clsid: Optional[int] = None
    z_scale_special_classes: Tuple[int, ...] = (1, 5, 6)  # ROAD, WATER, ZONE
    map_size: int = 2048
    scale: int = 1
    view_index_file: Optional[str] = None


def google_earth_dataset() -> DatasetConfig:
    return DatasetConfig()


def kitti_360_dataset() -> DatasetConfig:
    return DatasetConfig(
        name="KITTI_360",
        dir="./data/kitti-360/processed",
        view_index_file="./data/kitti-360/views.json",
        train_crop_size=(448, 224),
        test_crop_size=(704, 376),
        cam_k=(
            552.554261, 0.0, 682.049453,
            0.0, 552.554261, 238.769549,
            0.0, 0.0, 1.0,
        ),
        sensor_size=(1408, 376),
        flip_ud=True,
        bldg_range=(100, 10000),
        car_range=(10000, 16384),
        car_clsid=3,
        z_scale_special_classes=(1, 6),  # ROAD, ZONE
        map_size=0,
    )


# ---------------------------------------------------------------------------
# Rasterizer
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RasterizerConfig(_Base):
    # pixel tile of one blend thread block (tile_h * tile_w <= 1024)
    tile_h: int = 32
    tile_w: int = 32
    # static-binning knobs of the JAX package; ignored by the port
    max_tiles_per_gaussian: int = 32
    bin_tiers: Tuple[Tuple[int, int], ...] = (
        (16384, 32), (4096, 64), (1024, 128), (128, 0))
    # max Gaussians blended per tile, nearest first; the rest are counted
    # in RenderOutput.n_truncated
    tile_capacity: int = 1024
    # blending constants (upstream forward.cu:308-324)
    alpha_min: float = 1.0 / 255.0
    alpha_max: float = 0.99
    transmittance_eps: float = 1e-4
    near_z: float = 0.2
    # backward slot budgets (training)
    grad_capacity: int = 0
    grad_budget: int = 0
    visible_cap: int = 0
    # upstream 16x16-block gating: a Gaussian touches a pixel only if the
    # pixel's 16x16 sensor block lies inside its getRect() bbox
    ref_tile16_gate: bool = True
    chunk: int = 8
    backend: str = "auto"
    page: int = 0


# ---------------------------------------------------------------------------
# Network
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PTv3Config(_Base):
    enabled: bool = True
    order: Tuple[str, ...] = ("cord",)
    stride: Tuple[int, ...] = (2, 2, 2, 2)
    enc_depths: Tuple[int, ...] = (2, 2, 2, 6, 2)
    enc_channels: Tuple[int, ...] = (32, 64, 128, 256, 512)
    enc_n_head: Tuple[int, ...] = (2, 4, 8, 16, 32)
    enc_patch_size: Tuple[int, ...] = (1024, 1024, 1024, 1024, 1024)
    dec_depths: Tuple[int, ...] = (2, 2, 2, 2)
    dec_channels: Tuple[int, ...] = (64, 64, 128, 256)
    dec_n_head: Tuple[int, ...] = (4, 4, 8, 16)
    dec_patch_size: Tuple[int, ...] = (1024, 1024, 1024, 1024)
    mlp_ratio: float = 4.0
    enable_cpe: bool = True
    enable_rpe: bool = False
    shuffle_orders: bool = True
    pool_capacity_divisor: int = 1
    remat: bool = False
    dense_nbr_extent: int = 256


@dataclass(frozen=True)
class GaussianNetworkConfig(_Base):
    scale_factor: float = 0.65
    encoder: Optional[str] = "GLOBAL"  # "GLOBAL" | "LOCAL" | None
    encoder_out_dim: int = 5
    global_encoder_n_blocks: int = 6
    pos_emd: str = "HASH_GRID"  # "HASH_GRID" | "SIN_COS"
    hash_grid_n_levels: int = 16
    hash_grid_level_dim: int = 8
    hash_grid_map_size: int = 19  # log2 hashmap size
    hash_grid_base_res: int = 16
    sin_cos_freq_bends: int = 10
    z_dim: Optional[int] = None  # None | 256
    mlp_hidden_dim: int = 512
    mlp_n_shared_layers: int = 1
    attr_factors: Dict[str, float] = field(
        default_factory=lambda: {"rgb": 2.0})
    attr_n_layers: Dict[str, int] = field(default_factory=lambda: {"rgb": 1})
    dis_n_channel_base: int = 128
    ptv3: PTv3Config = field(default_factory=PTv3Config)
    compute_dtype: str = "float32"


# ---------------------------------------------------------------------------
# Train / test
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GeneratorOptim(_Base):
    lr: float = 1e-4


@dataclass(frozen=True)
class DiscriminatorOptim(_Base):
    enabled: bool = True
    lr: float = 1e-5
    n_warmup_iters: int = 100000


@dataclass(frozen=True)
class TrainConfig(_Base):
    batch_size: int = 1
    eps: float = 1e-8
    weight_decay: float = 0.0
    betas: Tuple[float, float] = (0.9, 0.999)
    allow_random_vgg: bool = False
    perceptual_loss_model: str = "vgg19"
    perceptual_loss_layers: Tuple[str, ...] = (
        "relu_3_1", "relu_4_1", "relu_5_1")
    perceptual_loss_weights: Tuple[float, ...] = (0.125, 0.25, 1.0)
    n_epochs: int = 500
    l1_loss_factor: float = 10.0
    perceptual_loss_factor: float = 10.0
    gan_loss_factor: float = 0.5
    ckpt_save_freq: int = 25
    log_freq: int = 10
    generator: GeneratorOptim = field(default_factory=GeneratorOptim)
    discriminator: DiscriminatorOptim = field(
        default_factory=DiscriminatorOptim)
    seed: int = 0
    max_points: int = 16384
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    n_workers: int = 8
    prefetch_batches: int = 8


@dataclass(frozen=True)
class TestConfig(_Base):
    test_freq: int = 1


@dataclass(frozen=True)
class ParallelConfig(_Base):
    data_axis: int = -1
    tile_axis: int = 1


@dataclass(frozen=True)
class MemcachedConfig(_Base):
    enabled: bool = False
    servers: Tuple[str, ...] = ("127.0.0.1:11211",)
    timeout_s: float = 2.0


# ---------------------------------------------------------------------------
# Root config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Config(_Base):
    exp_name: str = ""
    dataset: DatasetConfig = field(default_factory=google_earth_dataset)
    network: GaussianNetworkConfig = field(
        default_factory=GaussianNetworkConfig)
    rasterizer: RasterizerConfig = field(default_factory=RasterizerConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    test: TestConfig = field(default_factory=TestConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    memcached: MemcachedConfig = field(default_factory=MemcachedConfig)
    output_dir: str = "./output"
    n_workers: int = 8


def rest_recipe(dataset: str = "GOOGLE_EARTH") -> Config:
    """Background (REST) generator: GLOBAL encoder, hash grid, PTv3 off."""
    ds = (google_earth_dataset() if dataset == "GOOGLE_EARTH"
          else kitti_360_dataset())
    ds = ds.replace(
        train_instance_range=(0, 100),
        test_instance_range=(0, 100),
        train_crop_size=(640, 448),
    )
    net = GaussianNetworkConfig(
        scale_factor=0.5,
        encoder="GLOBAL",
        encoder_out_dim=5,
        pos_emd="HASH_GRID",
        z_dim=None,
        ptv3=PTv3Config(enabled=False),
    )
    return Config(exp_name="REST", dataset=ds, network=net,
                  rasterizer=RasterizerConfig(grad_budget=65536))
