"""Parameter trees of the JAX package -> this package's state dicts.

The JAX package's flax trees (nested mappings of arrays, e.g. read back
with :func:`load_flax_npz`) convert to state dicts in the reference's key
names, which ``load_state_dict(strict=True)`` takes.  Numpy only: no JAX is
needed, so JAX-trained weights load on a machine that has none.  The .npz
storage of the trees (``save_flax_npz``, ``load_flax_npz``) lives in
``flax_npz.py`` and is re-exported here.

Each model's mapping is a *plan*, a list of (state-dict key, flax path,
layout) entries; the same plan runs both ways (``*_from_flax`` and
:func:`to_flax`).
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..flax_npz import (  # noqa: F401  (re-exported)
    flatten_tree, load_flax_npz, save_flax_npz, unflatten_tree)

Plan = List[Tuple[str, Tuple[str, ...], str]]

# layout: flax leaf -> state-dict tensor, and back
_TO_TORCH = {
    "id": lambda a: a,
    "T": lambda a: a.T,                               # (in, out) -> (out, in)
    "hwio": lambda a: a.transpose(3, 2, 0, 1),        # HWIO -> OIHW
    "dense_v": lambda a: a.T[:, :, None, None],  # (in, out) -> (out, in, 1, 1)
    "g": lambda a: a.reshape(-1, 1, 1, 1),
    "c4": lambda a: a.reshape(1, -1, 1, 1),
    "perm": lambda a: a.astype(np.int64),
}
_TO_FLAX = {
    "id": lambda a: a,
    "T": lambda a: a.T,
    "hwio": lambda a: a.transpose(2, 3, 1, 0),
    "dense_v": lambda a: a[:, :, 0, 0].T,
    "g": lambda a: a.reshape(-1),
    "c4": lambda a: a.reshape(-1),
    "perm": lambda a: a.astype(np.int32),
}


def _params(tree: Mapping) -> Mapping:
    return tree["params"] if "params" in tree else tree


def _get(tree: Mapping, path: Tuple[str, ...]):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


def _count(keys, prefix: str) -> int:
    """Number of keys ``prefix<int>``."""
    return sum(1 for k in keys if k.startswith(prefix)
               and k[len(prefix):].isdigit())


def from_flax(tree: Mapping, plan: Plan) -> Dict[str, torch.Tensor]:
    return {key: torch.from_numpy(np.array(_TO_TORCH[kind](_get(tree, path))))
            for key, path, kind in plan}


def to_flax(state_dict: Mapping, plan: Plan) -> Dict[str, Any]:
    """The inverse of :func:`from_flax`: a nested dict of numpy arrays."""
    tree: Dict[str, Any] = {}
    for key, path, kind in plan:
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(
            _TO_FLAX[kind](state_dict[key].detach().cpu().numpy()))
    return tree


def _norm_conv(key: str, path: Tuple[str, ...], v_kind: str = "hwio") -> Plan:
    return [(f"{key}.conv.weight_v", path + ("v",), v_kind),
            (f"{key}.conv.weight_g", path + ("g",), "g"),
            (f"{key}.conv.bias", path + ("bias",), "id"),
            (f"{key}.gamma", path + ("gamma",), "c4"),
            (f"{key}.beta", path + ("beta",), "c4")]


# -- behavior net -----------------------------------------------------------

def behavior_net_plan(ib: bool = True, nin: bool = False) -> Plan:
    plan: Plan = [
        (f"b_enc.rnn.{w}_l0", ("b_enc", "rnn", f), kind)
        for w, f, kind in (("weight_ih", "w_ih", "T"),
                           ("weight_hh", "w_hh", "T"),
                           ("bias_ih", "b_ih", "id"),
                           ("bias_hh", "b_hh", "id"))]
    if ib:
        for head in ("mu_fn", "std_fn"):
            plan += _norm_conv(f"b_enc.{head}", ("b_enc", head), "dense_v")
    plan += [(f"decoder.rnn.{w}", ("decoder", f), kind)
             for w, f, kind in (("weight_ih", "w_ih", "T"),
                                ("weight_hh", "w_hh", "T"),
                                ("bias_ih", "b_ih", "id"),
                                ("bias_hh", "b_hh", "id"))]
    plan += [("decoder.n_out.weight", ("decoder", "w_out"), "T"),
             ("decoder.n_out.bias", ("decoder", "b_out"), "id")]
    if nin:
        plan += [("decoder.n_in.weight", ("decoder", "w_nin"), "T"),
                 ("decoder.n_in.bias", ("decoder", "b_nin"), "id")]
    return plan


def behavior_net_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """ResidualBehaviorNet params ({"params": ...} or bare) -> state dict."""
    p = _params(tree)
    return from_flax(p, behavior_net_plan("mu_fn" in p["b_enc"],
                                          "w_nin" in p["decoder"]))


def behavior_net_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    return to_flax(state_dict, behavior_net_plan(
        "b_enc.mu_fn.conv.weight_v" in state_dict,
        "decoder.n_in.weight" in state_dict))


# -- latent flow ------------------------------------------------------------

def latent_flow_plan(n_flows: int, n_dense: int) -> Plan:
    plan: Plan = []
    for i in range(n_flows):
        key, path = f"flow.sub_layers.{i}", ("flow", f"sub_layers_{i}")
        plan += [(f"{key}.norm_layer.{n}", ("params",) + path
                  + ("norm_layer", n), "c4") for n in ("loc", "scale")]
        for net in ("s", "t"):
            for j in range(2):
                for k in range(n_dense):
                    dense = ("params",) + path + ("coupling", f"{net}_{j}",
                                                  f"Dense_{k}")
                    main = f"{key}.coupling.{net}.{j}.main.{2 * k}"
                    plan += [(f"{main}.weight", dense + ("kernel",), "T"),
                             (f"{main}.bias", dense + ("bias",), "id")]
        plan.append((f"{key}.shuffle.forward_shuffle_idx",
                     ("buffers",) + path + ("shuffle", "perm"), "perm"))
    return plan


def latent_flow_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """LatentFlow variables ({"params", "buffers"}) -> state dict with the
    Shuffle permutations as buffers."""
    flow = variables["params"]["flow"]
    n_dense = _count(flow["sub_layers_0"]["coupling"]["s_0"], "Dense_")
    return from_flax(variables, latent_flow_plan(
        _count(flow, "sub_layers_"), n_dense))


def latent_flow_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    n_flows = sum(1 for k in state_dict if k.endswith(".norm_layer.loc"))
    n_dense = sum(1 for k in state_dict
                  if k.startswith("flow.sub_layers.0.coupling.s.0.main.")
                  and k.endswith(".weight"))
    return to_flax(state_dict, latent_flow_plan(n_flows, n_dense))


# -- VUNet (alter) ----------------------------------------------------------

def _rnb(key: str, path: Tuple[str, ...], residual: bool) -> Plan:
    if residual:
        return (_norm_conv(f"{key}.nin", path + ("NormConv2d_0",))
                + _norm_conv(f"{key}.conv", path + ("NormConv2d_1",)))
    return _norm_conv(f"{key}.conv", path + ("NormConv2d_0",))


def vunet_alter_plan(n_scales: int, n_scales_x: int,
                     n_latent_scales: int = 2) -> Plan:
    """The mapping of ``convert_vunet_alter`` in the JAX package."""
    plan: Plan = []
    for net, ns in (("eu", n_scales_x), ("du", n_scales)):
        plan += _norm_conv(f"{net}.nin", (net, "NormConv2d_0"))
        for k in range(2 * ns):
            plan += _rnb(f"{net}.blocks.{k}", (net, f"VunetRNB_{k}"), False)
        for i in range(ns - 1):
            plan += _norm_conv(f"{net}.downs.{i}.down",
                               (net, f"Downsample_{i}", "NormConv2d_0"))
    plan += _norm_conv("ed.nin", ("ed", "NormConv2d_0"))
    for i in range(n_latent_scales):
        plan += _rnb(f"ed.blocks.{2 * i}", ("ed", f"VunetRNB_{2 * i}"), True)
        plan += _norm_conv(f"ed.make_latent_params.{i}",
                           ("ed", f"NormConv2d_{1 + 2 * i}"))
        plan += _norm_conv(f"ed.make_logstds.{i}",
                           ("ed", f"NormConv2d_{2 + 2 * i}"))
        plan += _rnb(f"ed.blocks.{2 * i + 1}",
                     ("ed", f"VunetRNB_{2 * i + 1}"), True)
        plan += _norm_conv(f"ed.ups.{i}.up",
                           ("ed", f"Upsample_{i}", "NormConv2d_0"))
    plan += _rnb("ed.fin_block", ("ed", f"VunetRNB_{2 * n_latent_scales}"),
                 True)
    plan += _norm_conv("dd.nin", ("dd", "NormConv2d_0"))
    rnb = 0
    for i in range(n_scales):
        names = [f"dd.blocks.{2 * i}"]
        if i < n_latent_scales:
            names.append(f"dd.auto_blocks.{i}")
        names.append(f"dd.blocks.{2 * i + 1}")
        for name in names:
            plan += _rnb(name, ("dd", f"VunetRNB_{rnb}"), True)
            rnb += 1
        if i + 1 < n_scales:
            plan += _norm_conv(f"dd.ups.{i}.up",
                               ("dd", f"Upsample_{i}", "NormConv2d_0"))
    plan += _norm_conv("dd.out_conv", ("dd", "NormConv2d_1"))
    return plan


def vunet_alter_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """VUNet(variant="alter") params ({"params": ...} or bare) -> state
    dict; the scale counts are read off the tree."""
    p = _params(tree)
    return from_flax(p, vunet_alter_plan(
        _count(p["du"], "VunetRNB_") // 2, _count(p["eu"], "VunetRNB_") // 2,
        _count(p["ed"], "Upsample_")))


def vunet_alter_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    def n_blocks(net):
        return sum(1 for k in state_dict if k.startswith(f"{net}.blocks.")
                   and k.endswith(".conv.conv.weight_v"))
    n_latent = sum(1 for k in state_dict if k.startswith("ed.ups.")
                   and k.endswith(".conv.weight_v"))
    return to_flax(state_dict, vunet_alter_plan(
        n_blocks("du") // 2, n_blocks("eu") // 2, n_latent))
