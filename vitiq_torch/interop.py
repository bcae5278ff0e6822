"""A `vitiq` parameter tree as the port's `state_dict` — the exact inverse of
`vitiq.interop.load_torch_state_dict` — and back.

Keys are the reference PyTorch checkpoint's (see `vitiq/interop.py`); layout
conversions go the other way:
  kernel [in, out]          -> Linear weight [out, in]
  kernel [(C*p*p), d]       -> Conv2d weight [d, C, p, p]  ((C, kh, kw) rows)
  kernel [(C*k), d]         -> Conv1d weight [d, C, k]     ((C, k) rows)
The tree's leaves may be numpy arrays or anything `numpy.asarray` accepts.
`vitiq_tree_from_state_dict` is the inverse, with numpy leaves (the layout
`vitiq`'s parameter files store, `train/checkpoint.py`); `tree_leaves` and
`tree_unflatten` walk a tree in `jax.tree_util`'s order.
`mdf_state_dict_from_vitiq` carries vitiq's MDF-NET parameters over to
`models/mdf.py`. `load_torch_checkpoint` reads a reference ``.pth`` and runs
the softmax calibration guard on it (counterpart of
`vitiq.interop.load_torch_checkpoint`).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Iterator, List, Mapping

import numpy as np
import torch

from vitiq_torch.config import ModelConfig


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a nested dict / list tree in `jax.tree_util` order:
    dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def tree_unflatten(template: Any, leaves: Iterator[Any]) -> Any:
    """`template`'s structure with its leaves taken in order from `leaves`."""
    if isinstance(template, dict):
        return {key: tree_unflatten(template[key], leaves) for key in sorted(template)}
    if isinstance(template, (list, tuple)):
        return [tree_unflatten(item, leaves) for item in template]
    return next(leaves)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _linear(sd: Dict, prefix: str, p: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv(sd: Dict, prefix: str, p: Mapping[str, Any], shape: tuple) -> None:
    kernel = np.asarray(p["kernel"])  # [(C*k...), d]
    sd[f"{prefix}.weight"] = _t(kernel.T.reshape((kernel.shape[1],) + shape))
    sd[f"{prefix}.bias"] = _t(p["bias"])


def encoder_layer_state_dict(layer: Mapping[str, Any],
                             prefix: str = "") -> "OrderedDict[str, torch.Tensor]":
    """One vitiq encoder-layer tree -> `EncoderLayer` state_dict entries."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for name in ("w_q", "w_k", "w_v", "w_concat"):
        _linear(sd, f"{prefix}attention.{name}", layer["attention"][name])
    for norm in ("norm1", "norm2"):
        sd[f"{prefix}{norm}.gamma"] = _t(layer[norm]["gamma"])
        sd[f"{prefix}{norm}.beta"] = _t(layer[norm]["beta"])
    _linear(sd, f"{prefix}ffn.linear1", layer["ffn"]["linear1"])
    _linear(sd, f"{prefix}ffn.linear2", layer["ffn"]["linear2"])
    return sd


def state_dict_from_vitiq(params: Mapping[str, Any], cfg: ModelConfig) -> "OrderedDict[str, torch.Tensor]":
    """vitiq parameter tree for `cfg` -> the port's (reference-keyed) state_dict."""
    cfg.validate()
    enc = params["encoder"]
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    if cfg.arm == "vit":
        _conv(sd, "encoder.patch_embedding.projection", enc["embedding"]["proj"],
              (cfg.in_channels, cfg.patch_size, cfg.patch_size))
    else:
        k = 1 if cfg.embedding_type == "conv1d" else cfg.segment_size
        _conv(sd, "encoder.sequence_embedding.projection", enc["embedding"]["proj"],
              (cfg.in_channels, k))
    for i, layer in enumerate(enc["layers"]):
        sd.update(encoder_layer_state_dict(layer, f"encoder.layers.{i}."))
    if "cls_token" in enc:
        sd["encoder.cls_token"] = _t(enc["cls_token"])
    if cfg.arm == "vit":
        _linear(sd, "mlp_head", params["mlp_head"])
    else:
        sd["mlp_head.0.weight"] = _t(params["head_norm"]["gamma"])
        sd["mlp_head.0.bias"] = _t(params["head_norm"]["beta"])
        _linear(sd, "mlp_head.1", params["mlp_head"])
    return sd


def _np(t) -> np.ndarray:
    return np.array(t.detach().cpu().float().numpy(), dtype=np.float32, copy=True)


def _dense(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, np.ndarray]:
    """Linear weight [out, in] or conv weight [d, C, *k] -> kernel [in, d]."""
    w = _np(sd[f"{prefix}.weight"])
    return {"kernel": np.ascontiguousarray(w.reshape(w.shape[0], -1).T),
            "bias": _np(sd[f"{prefix}.bias"])}


def vitiq_tree_from_state_dict(sd: Mapping[str, torch.Tensor], cfg: ModelConfig) -> Dict[str, Any]:
    """The port's state_dict for `cfg` -> a `vitiq` parameter tree of numpy
    f32 leaves, the inverse of `state_dict_from_vitiq` (the structure of
    `vitiq.models.init_amc_params`)."""
    cfg.validate()
    layers = []
    for i in range(cfg.n_layers):
        p = f"encoder.layers.{i}"
        layers.append({
            "attention": {name: _dense(sd, f"{p}.attention.{name}")
                          for name in ("w_q", "w_k", "w_v", "w_concat")},
            "norm1": {"gamma": _np(sd[f"{p}.norm1.gamma"]), "beta": _np(sd[f"{p}.norm1.beta"])},
            "ffn": {"linear1": _dense(sd, f"{p}.ffn.linear1"),
                    "linear2": _dense(sd, f"{p}.ffn.linear2")},
            "norm2": {"gamma": _np(sd[f"{p}.norm2.gamma"]), "beta": _np(sd[f"{p}.norm2.beta"])},
        })
    embed = ("encoder.patch_embedding.projection" if cfg.arm == "vit"
             else "encoder.sequence_embedding.projection")
    encoder: Dict[str, Any] = {"embedding": {"proj": _dense(sd, embed)}, "layers": layers}
    if cfg.arm == "vit" or cfg.use_cls_token:
        encoder["cls_token"] = _np(sd["encoder.cls_token"])
    if cfg.arm == "vit":
        return {"encoder": encoder, "mlp_head": _dense(sd, "mlp_head")}
    return {"encoder": encoder,
            "head_norm": {"gamma": _np(sd["mlp_head.0.weight"]),
                          "beta": _np(sd["mlp_head.0.bias"])},
            "mlp_head": _dense(sd, "mlp_head.1")}


def mdf_state_dict_from_vitiq(params: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """vitiq's MDF-NET parameter tree (`vitiq/models/mdf.py: init_fn`) ->
    the state_dict of `models.mdf.MultiDomainModel`. Conv kernels are OIHW in
    both; the LSTM's weight_ih = wx.kernel^T, bias_ih = wx.bias, weight_hh =
    wh.kernel^T, bias_hh = wh.bias (gates i, f, g, o in both)."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for tower in ("amp_cnn", "phase_cnn"):
        for i, conv in enumerate(params[tower]):
            sd[f"{tower}.{i}.weight"] = _t(conv["kernel"])
            sd[f"{tower}.{i}.bias"] = _t(conv["bias"])
    sd["iq_conv.weight"] = _t(params["iq_conv"]["kernel"])
    sd["iq_conv.bias"] = _t(params["iq_conv"]["bias"])
    lstm = params["lstm"]
    sd["lstm.weight_ih_l0"] = _t(np.asarray(lstm["wx"]["kernel"]).T)
    sd["lstm.weight_hh_l0"] = _t(np.asarray(lstm["wh"]["kernel"]).T)
    sd["lstm.bias_ih_l0"] = _t(lstm["wx"]["bias"])
    sd["lstm.bias_hh_l0"] = _t(lstm["wh"]["bias"])
    _linear(sd, "fuse1", params["fuse1"])
    _linear(sd, "head", params["head"])
    return sd


def load_reference_state_dict(model: torch.nn.Module, sd: Mapping[str, torch.Tensor]) -> None:
    """Load a reference state dict into `model` (the port keeps the
    reference's parameter names): entries the model does not have, such as
    buffers, are ignored; a missing parameter raises KeyError."""
    missing = model.load_state_dict(sd, strict=False).missing_keys
    if missing:
        raise KeyError(f"the checkpoint has no {missing[0]!r} for this config "
                       f"({len(missing)} parameters missing)")


def load_torch_checkpoint(path, cfg: ModelConfig, check_bounds: bool = True
                          ) -> "OrderedDict[str, torch.Tensor]":
    """A reference ``.pth`` training checkpoint (its ``model_state_dict``,
    or a bare state dict; read with ``torch.load(weights_only=True)``) as the
    state_dict of an `AMCModel` for `cfg`; a parameter the checkpoint lacks
    raises KeyError. With `check_bounds`, runs the softmax calibration guard
    (`ops.guards.check_softmax_bound`) on the weights, which warns where
    their attention scores near the bound of the TPU kernels' max-free
    softmax."""
    from vitiq_torch.models.amc import AMCModel
    from vitiq_torch.ops.guards import check_softmax_bound

    blob = torch.load(path, map_location="cpu", weights_only=True)
    model = AMCModel(cfg)
    load_reference_state_dict(model, blob.get("model_state_dict", blob)
                              if isinstance(blob, dict) else blob)
    if check_bounds:
        check_softmax_bound(model)
    return model.state_dict()
