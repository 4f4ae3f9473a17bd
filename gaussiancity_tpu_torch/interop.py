# -*- coding: utf-8 -*-
"""Weights carried across: the JAX ``Generator``'s Flax parameter tree ->
the port's ``state_dict``, and the port's own generator checkpoints.

``generator_state_from_flax`` takes the tree as nested dicts of numpy
arrays.  Dense kernels ``[in, out]`` become ``[out, in]``, conv kernels
HWIO become OIHW, transposed-conv kernels HWIO become [in, out, kh, kw]
(not flipped), GroupNorm scale and bias become weight and bias, and the
``ModLinear`` and hash-table arrays are copied as they are (the port keeps the JAX package's ``[L, R_max, C]`` table).
The PTv3 subtree (``pt_net``) keeps its names: its ``SubMConv`` kernels
``[K^3, C, F]`` and the attention's ``rpe_table`` are copied as they are, ``LayerNorm_0`` scale and bias
become the ``nn.LayerNorm`` weight and bias, and the ``MaskedBatchNorm``
running ``mean`` / ``var`` come from the ``batch_stats`` collection.
``load_train_state`` carries a whole JAX ``TrainState``, Adam's moments
and counts included, into the port's ``Trainer``.
"""

from __future__ import annotations

import json
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from gaussiancity_tpu_torch.config import Config, GaussianNetworkConfig
from gaussiancity_tpu_torch.device import resolve_device


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


def _group_norm(p: Mapping, prefix: str,
                out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def _local_encoder(enc: Mapping, prefix: str,
                   out: Dict[str, torch.Tensor]) -> None:
    """The Flax ``LocalEncoder`` subtree -> the port's names."""
    _conv(enc["TorchConv_0"], f"{prefix}.hf_conv", out)
    _conv(enc["TorchConv_1"], f"{prefix}.seg_conv", out)
    _group_norm(enc["GroupNorm_0"], f"{prefix}.norm", out)
    for i in range(3):
        blk, name = enc[f"ResConvBlock_{i}"], f"{prefix}.block{i + 1}"
        for j, (gn, conv) in enumerate((("gn1", "conv1"), ("gn2", "conv2"),
                                        ("gn3", "conv3"),
                                        ("gn_res", "conv_res"))):
            if f"TorchConv_{j}" in blk:
                _group_norm(blk[f"GroupNorm_{j}"], f"{name}.{gn}", out)
                _conv(blk[f"TorchConv_{j}"], f"{name}.{conv}", out)
    for i in range(2):
        p = enc[f"TorchConvTranspose_{i}"]
        out[f"{prefix}.up{i + 1}.weight"] = _t(
            np.asarray(p["kernel"]).transpose(2, 3, 0, 1))
        out[f"{prefix}.up{i + 1}.bias"] = _t(p["bias"])
    _conv(enc["TorchConv_2"], f"{prefix}.out_conv", out)


_MODLINEAR = ("weight", "weight_alpha", "bias_alpha", "weight_beta",
              "bias_beta", "bias")


def ptv3_state_from_flax(tree: Mapping, prefix: str = "",
                         out: Optional[Dict[str, torch.Tensor]] = None
                         ) -> Dict[str, torch.Tensor]:
    """Flatten a Flax PTv3 subtree (params or batch_stats) into the port's
    names under ``prefix``; a ``MaskedBatchNorm`` without statistics gets
    the defaults (mean 0, var 1)."""
    out = {} if out is None else out
    for name, value in tree.items():
        key = f"{prefix}.{name}" if prefix else name
        if isinstance(value, Mapping):
            if name == "LayerNorm_0":
                out[f"{prefix}.weight"] = _t(value["scale"])
                out[f"{prefix}.bias"] = _t(value["bias"])
            else:
                ptv3_state_from_flax(value, key, out)
        elif name == "kernel" and np.ndim(value) == 2:
            out[key[:-len("kernel")] + "weight"] = _t(np.asarray(value).T)
        else:
            out[key] = _t(value)
            if name == "scale":  # a MaskedBatchNorm
                stem = key[:-len("scale")]
                out.setdefault(stem + "mean", torch.zeros(len(value)))
                out.setdefault(stem + "var", torch.ones(len(value)))
    return out


def generator_state_from_flax(variables_np: Mapping,
                              cfg: GaussianNetworkConfig
                              ) -> Dict[str, torch.Tensor]:
    """Flax ``Generator`` variables -> the port's
    ``Generator.state_dict()``.  Takes the full variable dict
    ``{"params", "batch_stats"}`` or the bare params (then a PTv3 keeps
    its default running statistics, mean 0 and var 1)."""
    params_np = variables_np.get("params", variables_np)
    batch_stats = variables_np.get("batch_stats", {})
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
    elif cfg.encoder == "LOCAL":
        _local_encoder(params_np["proj_encoder"], "proj_encoder", out)
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
    if cfg.ptv3.enabled:
        ptv3_state_from_flax(params_np["pt_net"], "pt_net", out)
        ptv3_state_from_flax(batch_stats.get("pt_net", {}), "pt_net", out)
    return out


def save_generator(path: str, state: Mapping[str, torch.Tensor],
                   cfg: Config) -> None:
    """A ``torch.save`` file holding the weights and the config as JSON."""
    torch.save({"config": cfg.to_json(),
                "state_dict": {k: v.detach().cpu()
                               for k, v in state.items()}}, path)


def load_generator(path: str, device=None
                   ) -> Tuple["torch.nn.Module", Config]:
    """Rebuild the generator saved by ``save_generator`` on ``device``
    (the card unless the caller asks for the CPU)."""
    from gaussiancity_tpu_torch.models.generator import Generator

    blob = torch.load(path, map_location="cpu", weights_only=True)
    cfg = Config.from_dict(json.loads(blob["config"]))
    gen = Generator(cfg.network, n_classes=cfg.dataset.n_classes,
                    proj_size=cfg.dataset.proj_size)
    gen.load_state_dict(blob["state_dict"])
    return gen.to(resolve_device(device)).eval(), cfg


_SN_LAYERS = ("enc1", "enc2", "enc3", "enc4", "enc5", "lat5", "lat4",
              "lat3", "lat2", "final2")


def discriminator_state_from_flax(params_np: Mapping,
                                  batch_stats_np: Optional[Mapping]
                                  ) -> Dict[str, torch.Tensor]:
    """Flax ``Discriminator`` params and ``batch_stats`` (the spectral-norm
    ``u`` and ``sigma``) -> the port's ``Discriminator.state_dict()``.
    Without ``batch_stats`` it gives the parameters alone (as for Adam's
    moments, which have the params' tree)."""
    if "params" in params_np:
        params_np = params_np["params"]
    if batch_stats_np is not None and "batch_stats" in batch_stats_np:
        batch_stats_np = batch_stats_np["batch_stats"]
    out: Dict[str, torch.Tensor] = {}
    for name in _SN_LAYERS:
        _conv(params_np[name], name, out)
        if batch_stats_np is None:
            continue
        sn = batch_stats_np[name]["SpectralNorm_0"]
        out[f"{name}.u"] = _t(sn["Conv_0/kernel/u"])
        out[f"{name}.sigma"] = _t(sn["Conv_0/kernel/sigma"])
    _conv({"Conv_0": params_np["output"]}, "output", out)
    return out


def vgg_state_from_flax(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``VGGFeatures`` params -> the port's ``VGGFeatures``
    state_dict (HWIO kernels -> OIHW)."""
    if "params" in params_np:
        params_np = params_np["params"]
    out: Dict[str, torch.Tensor] = {}
    for name, p in params_np.items():
        _conv({"Conv_0": p}, name, out)
    return out


def _field(tree, name: str):
    """``tree[name]`` of a mapping (a tree read from an Orbax checkpoint),
    else the attribute (a JAX ``TrainState`` or an optax state); None where
    absent."""
    if isinstance(tree, Mapping):
        return tree.get(name)
    return getattr(tree, name, None)


def _load_adam(opt: torch.optim.Optimizer, module: torch.nn.Module,
               adam_state, to_state, what: str) -> int:
    """Carry optax's ``ScaleByAdamState(count, mu, nu)`` into ``opt``:
    ``mu`` -> ``exp_avg``, ``nu`` -> ``exp_avg_sq`` through the converter
    of the parameters (``to_state``), matched to ``module``'s parameters
    by name, and ``count`` -> each parameter's ``step``.  Returns the
    count."""
    count = int(np.asarray(_field(adam_state, "count")))
    params = dict(module.named_parameters())
    buffers = {n for n, _ in module.named_buffers()}
    moments = {}
    for key in ("mu", "nu"):
        tree = _field(adam_state, key)
        if tree is None:
            raise ValueError(f"{what}: the optimizer state has no {key!r}")
        moments[key] = {n: t for n, t in to_state(tree).items()
                        if n not in buffers}
        extra = sorted(set(moments[key]) - set(params))
        missing = sorted(set(params) - set(moments[key]))
        if extra or missing:
            raise ValueError(
                f"{what}: Adam's {key!r} does not match the parameters: "
                f"{len(missing)} parameters without a moment "
                f"{missing[:4]}, {len(extra)} moments without a parameter "
                f"{extra[:4]}")
    for name, p in params.items():
        for key in ("mu", "nu"):
            if moments[key][name].shape != p.shape:
                raise ValueError(
                    f"{what}: Adam's {key!r} of {name} has shape "
                    f"{tuple(moments[key][name].shape)}, the parameter "
                    f"{tuple(p.shape)}")
        # the step tensor as torch.optim.Adam keeps it (float32, on the
        # host unless the optimizer is capturable or fused)
        opt.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": moments["mu"][name].to(p.device, p.dtype).clone(),
            "exp_avg_sq": moments["nu"][name].to(p.device, p.dtype).clone(),
        }
    return count


def load_train_state(trainer, state_np) -> None:
    """Load a JAX ``TrainState`` whose leaves are numpy arrays (or the
    same tree as nested dicts and tuples, as ``training.orbax_reader``
    reads it) into the port's ``Trainer``: the generator's params with its
    ``g_stats`` (PTv3's running statistics), the discriminator's params
    with ``d_stats`` (its spectral-norm state), the VGG params of the
    perceptual loss, the step, and both optimizers: Adam's moments and
    counts from ``g_opt[0]`` / ``d_opt[0]``.  D's learning rate follows
    the trainer's step (``Trainer.d_learning_rate``), so the warm-up
    schedule's count ``d_opt[1].count`` must equal the step; a state where
    they differ raises.  A state without optimizer states (the moments
    left out) raises as well."""
    cfg = trainer.cfg
    step = int(np.asarray(_field(state_np, "step")))
    g_stats = _field(state_np, "g_stats") or {}
    trainer.generator.load_state_dict(generator_state_from_flax(
        {"params": _field(state_np, "g_params"), "batch_stats": g_stats},
        cfg.network))
    g_opt = _field(state_np, "g_opt")
    if not g_opt:
        raise ValueError("the train state has no generator optimizer state")
    _load_adam(trainer.g_opt, trainer.generator, g_opt[0],
               lambda t: generator_state_from_flax({"params": t},
                                                   cfg.network), "g_opt")
    if trainer.use_disc:
        trainer.discriminator.load_state_dict(discriminator_state_from_flax(
            _field(state_np, "d_params"), _field(state_np, "d_stats")))
        d_opt = _field(state_np, "d_opt")
        if not d_opt:
            raise ValueError("the train state has no discriminator "
                             "optimizer state")
        _load_adam(trainer.d_opt, trainer.discriminator, d_opt[0],
                   lambda t: discriminator_state_from_flax(t, None), "d_opt")
        warm = int(np.asarray(_field(d_opt[1], "count")))
        if warm != step:
            raise ValueError(
                f"d_opt: the warm-up schedule's count {warm} differs from "
                f"the train state's step {step}; the port derives D's "
                "learning rate from the step")
    trainer.ploss.model.load_state_dict(
        vgg_state_from_flax(_field(state_np, "ploss_params")))
    trainer.step = step
