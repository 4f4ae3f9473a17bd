# -*- coding: utf-8 -*-
"""Weights carried across: the JAX ``Generator``'s Flax parameter tree ->
the port's ``state_dict``, and the port's own generator checkpoints.

``generator_state_from_flax`` takes the tree as nested dicts of numpy
arrays.  Dense kernels ``[in, out]`` become ``[out, in]``, conv kernels
HWIO become OIHW, and the ``ModLinear`` and hash-table arrays are copied
as they are (the port keeps the JAX package's ``[L, R_max, C]`` table).
"""

from __future__ import annotations

import json
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from gaussiancity_tpu_torch.config import Config, GaussianNetworkConfig


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float32))


def _dense(p: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def _conv(p: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    conv = p["Conv_0"]
    out[f"{prefix}.weight"] = _t(
        np.asarray(conv["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in conv:
        out[f"{prefix}.bias"] = _t(conv["bias"])


_MODLINEAR = ("weight", "weight_alpha", "bias_alpha", "weight_beta",
              "bias_beta", "bias")


def generator_state_from_flax(params_np: Mapping,
                              cfg: GaussianNetworkConfig
                              ) -> Dict[str, torch.Tensor]:
    """Flax ``Generator`` params (the ``"params"`` collection) -> the
    port's ``Generator.state_dict()``."""
    if "params" in params_np:
        params_np = params_np["params"]
    out: Dict[str, torch.Tensor] = {}
    if cfg.encoder == "GLOBAL":
        enc = params_np["proj_encoder"]
        _conv(enc["TorchConv_0"], "proj_encoder.hf_conv", out)
        _conv(enc["TorchConv_1"], "proj_encoder.seg_conv", out)
        for i in range(cfg.global_encoder_n_blocks - 1):
            blk = enc[f"SRTConvBlock_{i}"]
            _conv(blk["TorchConv_0"], f"proj_encoder.blocks.{i}.conv1", out)
            _conv(blk["TorchConv_1"], f"proj_encoder.blocks.{i}.conv2", out)
        _dense(enc["TorchDense_0"], "proj_encoder.fc1", out)
        _dense(enc["TorchDense_1"], "proj_encoder.fc2", out)
    elif cfg.encoder is not None:
        raise NotImplementedError(f"encoder {cfg.encoder!r} is not ported")
    if cfg.pos_emd == "HASH_GRID":
        out["pos_encoder.embeddings"] = _t(
            params_np["pos_encoder"]["embeddings"])
    for name, p in params_np["ga_mlp"].items():
        if "kernel" in p:
            _dense(p, f"ga_mlp.{name}", out)
        else:
            for k in _MODLINEAR:
                if k in p:
                    out[f"ga_mlp.{name}.{k}"] = _t(p[k])
    return out


def save_generator(path: str, state: Mapping[str, torch.Tensor],
                   cfg: Config) -> None:
    """A ``torch.save`` file holding the weights and the config as JSON."""
    torch.save({"config": cfg.to_json(),
                "state_dict": {k: v.detach().cpu()
                               for k, v in state.items()}}, path)


def load_generator(path: str, device="cpu"
                   ) -> Tuple["torch.nn.Module", Config]:
    """Rebuild the generator saved by ``save_generator`` on ``device``."""
    from gaussiancity_tpu_torch.models.generator import Generator

    blob = torch.load(path, map_location="cpu", weights_only=True)
    cfg = Config.from_dict(json.loads(blob["config"]))
    gen = Generator(cfg.network, n_classes=cfg.dataset.n_classes,
                    proj_size=cfg.dataset.proj_size)
    gen.load_state_dict(blob["state_dict"])
    return gen.to(device).eval(), cfg
