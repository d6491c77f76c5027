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
    "conv1d": lambda a: a.transpose(2, 1, 0),         # (K, I, O) -> (O, I, K)
    # flax flattens a (T, 32) map T-major, the reference (32, T) C-major
    "fc_cmajor": lambda a: a.reshape(-1, 32, a.shape[1]).transpose(
        2, 1, 0).reshape(a.shape[1], -1),
}
_TO_FLAX = {
    "id": lambda a: a,
    "T": lambda a: a.T,
    "hwio": lambda a: a.transpose(2, 3, 1, 0),
    "dense_v": lambda a: a[:, :, 0, 0].T,
    "g": lambda a: a.reshape(-1),
    "c4": lambda a: a.reshape(-1),
    "perm": lambda a: a.astype(np.int32),
    "conv1d": lambda a: a.transpose(2, 1, 0),
    "fc_cmajor": lambda a: a.reshape(a.shape[0], 32, -1).transpose(
        2, 1, 0).reshape(-1, a.shape[0]),
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


def _rnn_l0(key: str, path: Tuple[str, ...]) -> Plan:
    """An ``nn.LSTM``'s or ``nn.GRU``'s layer-0 weights <-> a flax cell's
    ``w_ih``, ``w_hh``, ``b_ih``, ``b_hh``."""
    return [(f"{key}.{w}_l0", path + (f,), kind)
            for w, f, kind in (("weight_ih", "w_ih", "T"),
                               ("weight_hh", "w_hh", "T"),
                               ("bias_ih", "b_ih", "id"),
                               ("bias_hh", "b_hh", "id"))]


def _norm_conv(key: str, path: Tuple[str, ...], v_kind: str = "hwio") -> Plan:
    return [(f"{key}.conv.weight_v", path + ("v",), v_kind),
            (f"{key}.conv.weight_g", path + ("g",), "g"),
            (f"{key}.conv.bias", path + ("bias",), "id"),
            (f"{key}.gamma", path + ("gamma",), "c4"),
            (f"{key}.beta", path + ("beta",), "c4")]


# -- behavior net -----------------------------------------------------------

def behavior_net_plan(ib: bool = True, nin: bool = False) -> Plan:
    plan = _rnn_l0("b_enc.rnn", ("b_enc", "rnn"))
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


# -- VUNet (alter and org) ---------------------------------------------------

def _rnb(key: str, path: Tuple[str, ...], residual: bool) -> Plan:
    if residual:
        return (_norm_conv(f"{key}.nin", path + ("NormConv2d_0",))
                + _norm_conv(f"{key}.conv", path + ("NormConv2d_1",)))
    return _norm_conv(f"{key}.conv", path + ("NormConv2d_0",))


def _vunet_plan(n_scales: int, n_scales_x: int, n_latent_scales: int,
                org: bool) -> Plan:
    plan: Plan = []
    for net, ns in (("eu", n_scales_x), ("du", n_scales)):
        plan += _norm_conv(f"{net}.nin", (net, "NormConv2d_0"))
        for k in range(2 * ns):
            plan += _rnb(f"{net}.blocks.{k}", (net, f"VunetRNB_{k}"), False)
        for i in range(ns - 1):
            plan += _norm_conv(f"{net}.downs.{i}.down",
                               (net, f"Downsample_{i}", "NormConv2d_0"))
    plan += _norm_conv("ed.nin", ("ed", "NormConv2d_0"))
    # ed's NormConv2d: the latent means (and, alter, logstds) in order
    per_scale = 1 if org else 2
    for i in range(n_latent_scales):
        plan += _rnb(f"ed.blocks.{2 * i}", ("ed", f"VunetRNB_{2 * i}"), True)
        plan += _norm_conv(f"ed.make_latent_params.{i}",
                           ("ed", f"NormConv2d_{1 + per_scale * i}"))
        if not org:
            plan += _norm_conv(f"ed.make_logstds.{i}",
                               ("ed", f"NormConv2d_{2 + 2 * i}"))
        plan += _rnb(f"ed.blocks.{2 * i + 1}",
                     ("ed", f"VunetRNB_{2 * i + 1}"), True)
        plan += _norm_conv(f"ed.ups.{i}.up",
                           ("ed", f"Upsample_{i}", "NormConv2d_0"))
    plan += _rnb("ed.fin_block", ("ed", f"VunetRNB_{2 * n_latent_scales}"),
                 True)
    plan += _norm_conv("dd.nin", ("dd", "NormConv2d_0"))
    rnb, conv = 0, 1       # flax numbers dd's VunetRNB and NormConv2d apart

    def dd_rnb(key, residual=True):
        nonlocal rnb
        rnb += 1
        return _rnb(key, ("dd", f"VunetRNB_{rnb - 1}"), residual)

    def dd_conv(key):
        nonlocal conv
        conv += 1
        return _norm_conv(key, ("dd", f"NormConv2d_{conv - 1}"))

    for i in range(n_scales):
        plan += dd_rnb(f"dd.blocks.{2 * i}")
        if i < n_latent_scales and not org:
            plan += dd_rnb(f"dd.auto_blocks.{i}")
        elif i < n_latent_scales:
            # the order of the JAX DecDown._autoregressive_scale
            plan += dd_rnb(f"dd.auto_blocks.l_{i}.0", residual=False)
            for l in range(4):
                plan += dd_conv(f"dd.auto_lp.l_{i}.{l}")
                if l + 1 < 4:
                    plan += dd_rnb(f"dd.auto_blocks.l_{i}.{l + 1}")
            plan += dd_conv(f"dd.latent_nins.l_{i}")
        plan += dd_rnb(f"dd.blocks.{2 * i + 1}")
        if i + 1 < n_scales:
            plan += _norm_conv(f"dd.ups.{i}.up",
                               ("dd", f"Upsample_{i}", "NormConv2d_0"))
    plan += dd_conv("dd.out_conv")
    return plan


def vunet_alter_plan(n_scales: int, n_scales_x: int,
                     n_latent_scales: int = 2) -> Plan:
    """The mapping of ``convert_vunet_alter`` in the JAX package."""
    return _vunet_plan(n_scales, n_scales_x, n_latent_scales, org=False)


def vunet_org_plan(n_scales: int, n_scales_x: int,
                   n_latent_scales: int = 2) -> Plan:
    """The mapping of ``convert_vunet_org`` in the JAX package: the
    autoregressive prior's ``dd.auto_blocks.l_{i}.{0..3}``,
    ``dd.auto_lp.l_{i}.{0..3}`` and ``dd.latent_nins.l_{i}``."""
    return _vunet_plan(n_scales, n_scales_x, n_latent_scales, org=True)


def _vunet_from_flax(tree: Mapping, plan_fn) -> Dict[str, torch.Tensor]:
    p = _params(tree)
    return from_flax(p, plan_fn(
        _count(p["du"], "VunetRNB_") // 2, _count(p["eu"], "VunetRNB_") // 2,
        _count(p["ed"], "Upsample_")))


def _vunet_to_flax(state_dict: Mapping, plan_fn) -> Dict[str, Any]:
    def n_blocks(net):
        return sum(1 for k in state_dict if k.startswith(f"{net}.blocks.")
                   and k.endswith(".conv.conv.weight_v"))
    n_latent = sum(1 for k in state_dict if k.startswith("ed.ups.")
                   and k.endswith(".conv.weight_v"))
    return to_flax(state_dict, plan_fn(
        n_blocks("du") // 2, n_blocks("eu") // 2, n_latent))


def vunet_alter_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """VUNet(variant="alter") params ({"params": ...} or bare) -> state
    dict; the scale counts are read off the tree."""
    return _vunet_from_flax(tree, vunet_alter_plan)


def vunet_alter_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    return _vunet_to_flax(state_dict, vunet_alter_plan)


def vunet_org_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """VUNet(variant="org") params ({"params": ...} or bare) -> state dict;
    the scale counts are read off the tree."""
    return _vunet_from_flax(tree, vunet_org_plan)


def vunet_org_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    return _vunet_to_flax(state_dict, vunet_org_plan)


# -- VUNet latent regressor ---------------------------------------------------

def vunet_regressor_plan(n_embedders: int, n_linear: int) -> Plan:
    """``VunetRegressor``: ``embedders.{i}`` <-> flax ``Conv_{i}`` (HWIO
    kernel), ``linears.{j}`` <-> ``Dense_{j}`` ((in, out) kernel)."""
    plan: Plan = []
    for i in range(n_embedders):
        plan += [(f"embedders.{i}.weight", (f"Conv_{i}", "kernel"), "hwio"),
                 (f"embedders.{i}.bias", (f"Conv_{i}", "bias"), "id")]
    for j in range(n_linear):
        plan += [(f"linears.{j}.weight", (f"Dense_{j}", "kernel"), "T"),
                 (f"linears.{j}.bias", (f"Dense_{j}", "bias"), "id")]
    return plan


def vunet_regressor_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    p = _params(tree)
    return from_flax(p, vunet_regressor_plan(_count(p, "Conv_"),
                                             _count(p, "Dense_")))


def vunet_regressor_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    def n(prefix):
        return sum(1 for k in state_dict
                   if k.startswith(prefix) and k.endswith(".weight"))
    return to_flax(state_dict, vunet_regressor_plan(n("embedders."),
                                                    n("linears.")))


# -- probes of the behavior experiment ----------------------------------------

def _dense(key: str, path: Tuple[str, ...]) -> Plan:
    return [(f"{key}.weight", path + ("kernel",), "T"),
            (f"{key}.bias", path + ("bias",), "id")]


def regressor_fly_plan() -> Plan:
    """``RegressorFly``: ``fc{i+1}`` <-> ``Dense_{i}`` (the mapping of the
    JAX package's ``convert_regressor_fly``)."""
    return [e for i in range(5) for e in _dense(f"fc{i + 1}", (f"Dense_{i}",))]


def classifier_action_plan() -> Plan:
    """``ClassifierAction``: ``RNN`` <-> ``LSTM_0``, ``fc1`` <-> ``Dense_0``,
    ``fc3`` <-> ``Dense_1`` (``convert_classifier_action``)."""
    return (_rnn_l0("RNN", ("LSTM_0",)) + _dense("fc1", ("Dense_0",))
            + _dense("fc3", ("Dense_1",)))


def classifier_plan() -> Plan:
    """The post-hoc real/fake ``Classifier``: ``RNN`` (a GRU, torch gate
    order) <-> ``GRUCell_0``, ``fc`` <-> ``Dense_0``."""
    return _rnn_l0("RNN", ("GRUCell_0",)) + _dense("fc", ("Dense_0",))


def regressor_plan() -> Plan:
    """The post-hoc start-pose ``Regressor``: ``fc{i+1}`` <->
    ``Dense_{i}``."""
    return [e for i in range(3) for e in _dense(f"fc{i + 1}", (f"Dense_{i}",))]


def classifier_action_beta_plan() -> Plan:
    """``ClassifierActionBeta``: ``fc1`` <-> ``Dense_0``."""
    return _dense("fc1", ("Dense_0",))


def sequence_disc_michael_plan(layers: Tuple[int, int] = (2, 1)) -> Plan:
    """``SequenceDiscMichael`` with ``layers[i]`` blocks in ``layer{i+1}``
    (the mapping of ``convert_sequence_disc_michael``): Conv1d weights
    (O, I, K) <-> (K, I, O), GroupNorm weight <-> scale, and ``fc`` (C-major
    over (32, T')) <-> ``Dense_0`` (T-major)."""
    def norm(key, path):
        return [(f"{key}.weight", path + ("scale",), "id"),
                (f"{key}.bias", path + ("bias",), "id")]
    plan: Plan = ([("conv1.weight", ("Conv_0", "kernel"), "conv1d")]
                  + norm("bn1", ("GroupNorm_0",)))
    block = 0
    for li, n_blocks in enumerate(layers):
        for bi in range(n_blocks):
            key, path = f"layer{li + 1}.{bi}", (f"_BasicBlock1D_{block}",)
            for j in (1, 2):
                plan.append((f"{key}.conv{j}.weight",
                             path + (f"Conv_{j - 1}", "kernel"), "conv1d"))
                plan += norm(f"{key}.bn{j}", path + (f"GroupNorm_{j - 1}",))
            if bi == 0:       # the first block of a layer strides by 2
                plan.append((f"{key}.downsample.0.weight",
                             path + ("Conv_2", "kernel"), "conv1d"))
                plan += norm(f"{key}.downsample.1", path + ("GroupNorm_2",))
            block += 1
    plan.append(("fc.weight", ("Dense_0", "kernel"), "fc_cmajor"))
    return plan


def regressor_fly_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    return from_flax(_params(tree), regressor_fly_plan())


def regressor_fly_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    return to_flax(state_dict, regressor_fly_plan())


def classifier_action_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    return from_flax(_params(tree), classifier_action_plan())


def classifier_action_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    return to_flax(state_dict, classifier_action_plan())


def classifier_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    return from_flax(_params(tree), classifier_plan())


def classifier_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    return to_flax(state_dict, classifier_plan())


def regressor_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    return from_flax(_params(tree), regressor_plan())


def regressor_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    return to_flax(state_dict, regressor_plan())


def classifier_action_beta_from_flax(tree: Mapping
                                     ) -> Dict[str, torch.Tensor]:
    return from_flax(_params(tree), classifier_action_beta_plan())


def classifier_action_beta_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    return to_flax(state_dict, classifier_action_beta_plan())


def sequence_disc_michael_from_flax(tree: Mapping
                                    ) -> Dict[str, torch.Tensor]:
    """The layer split is read off the tree: a block with a shortcut
    (``Conv_2``) starts a layer."""
    p = _params(tree)
    firsts = ["Conv_2" in p[f"_BasicBlock1D_{i}"]
              for i in range(_count(p, "_BasicBlock1D_"))]
    starts = [i for i, first in enumerate(firsts) if first] + [len(firsts)]
    layers = tuple(b - a for a, b in zip(starts, starts[1:]))
    return from_flax(p, sequence_disc_michael_plan(layers))


def sequence_disc_michael_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    layers = tuple(sum(1 for k in state_dict
                       if k.startswith(f"layer{li}.")
                       and k.endswith(".conv1.weight")) for li in (1, 2))
    return to_flax(state_dict, sequence_disc_michael_plan(layers))


# -- MT-VAE -------------------------------------------------------------------

def mtvae_plan() -> Plan:
    """``MTVAE`` (the mapping of the JAX package's ``convert_mtvae``): the
    LSTMs' layer-0 weights <-> ``w_ih``.., an FCResnet's ``shortcut``,
    ``fc1``..``fc3`` <-> ``Dense_0``..``Dense_3``, the heads <-> Dense."""
    plan = _rnn_l0("lstm_enc", ("lstm_enc",)) + _rnn_l0("lstm_dec",
                                                           ("lstm_dec",))
    for net in ("latent_enc", "latent_dec"):
        for i, layer in enumerate(("shortcut", "fc1", "fc2", "fc3")):
            plan += _dense(f"{net}.{layer}", (net, f"Dense_{i}"))
    for head in ("make_keypoints", "inv_z", "make_h_dec", "make_c_dec"):
        plan += _dense(head, (head,))
    return plan


def mtvae_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    return from_flax(_params(tree), mtvae_plan())


def mtvae_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    return to_flax(state_dict, mtvae_plan())


# -- InceptionV3 (models/inception.py) ----------------------------------------
def inception_plan(with_logits: bool = True) -> Plan:
    """torchvision's key names <-> the JAX package's {"params",
    "batch_stats"} trees of ``InceptionV3Features``."""
    from .inception import basic_conv_names

    plan: Plan = []
    for name in basic_conv_names():
        path = tuple(name.split("."))
        plan += [(f"{name}.conv.weight", ("params", *path, "conv", "kernel"),
                  "hwio"),
                 (f"{name}.bn.weight", ("params", *path, "bn", "scale"), "id"),
                 (f"{name}.bn.bias", ("params", *path, "bn", "bias"), "id"),
                 (f"{name}.bn.running_mean",
                  ("batch_stats", *path, "bn", "mean"), "id"),
                 (f"{name}.bn.running_var",
                  ("batch_stats", *path, "bn", "var"), "id")]
    if with_logits:
        plan += [("fc.weight", ("params", "fc", "kernel"), "T"),
                 ("fc.bias", ("params", "fc", "bias"), "id")]
    return plan


def inception_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's Inception variables -> a state dict of
    ``InceptionV3Features`` (with ``fc`` where the tree has it)."""
    sd = from_flax(variables, inception_plan("fc" in variables["params"]))
    for key in [k for k in sd if k.endswith(".bn.running_mean")]:
        sd[key[:-len("running_mean")] + "num_batches_tracked"] = \
            torch.zeros((), dtype=torch.int64)
    return sd


def inception_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    return to_flax(state_dict, inception_plan("fc.weight" in state_dict))
