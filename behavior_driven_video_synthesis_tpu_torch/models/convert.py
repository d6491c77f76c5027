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


def _dense(key: str, path: Tuple[str, ...]) -> Plan:
    return [(f"{key}.weight", path + ("kernel",), "T"),
            (f"{key}.bias", path + ("bias",), "id")]


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

def _mlp(key: str, path: Tuple[str, ...], n_dense: int) -> Plan:
    """A ``FullyConnectedNet``'s ``main.{2k}`` <-> flax ``Dense_{k}``."""
    return [e for k in range(n_dense)
            for e in _dense(f"{key}.main.{2 * k}", path + (f"Dense_{k}",))]


# the MLPs of each coupling type, ``coupling.{net}.{j}`` <-> ``{net}_{j}``
COUPLING_NETS = {"affine": ("s", "t"), "gin": ("s", "t"), "nice": ("t",),
                 "rqs": ("nets",)}


def _flow_blocks(key: str, path: Tuple[str, ...], n_flows: int,
                 n_dense: int, nets: Tuple[str, ...] = ("s", "t")) -> Plan:
    """``{key}sub_layers.{i}`` <-> ``params``/``buffers`` + path +
    ``sub_layers_{i}``: ActNorm, the coupling's MLPs and the Shuffle
    permutation (a buffer)."""
    plan: Plan = []
    for i in range(n_flows):
        k, p = f"{key}sub_layers.{i}", path + (f"sub_layers_{i}",)
        plan += [(f"{k}.norm_layer.{n}", ("params",) + p + ("norm_layer", n),
                  "c4") for n in ("loc", "scale")]
        for net in nets:
            for j in range(2):
                plan += _mlp(f"{k}.coupling.{net}.{j}",
                             ("params",) + p + ("coupling", f"{net}_{j}"),
                             n_dense)
        plan.append((f"{k}.shuffle.forward_shuffle_idx",
                     ("buffers",) + p + ("shuffle", "perm"), "perm"))
    return plan


def latent_flow_plan(n_flows: int, n_dense: int) -> Plan:
    return _flow_blocks("flow.", ("flow",), n_flows, n_dense)


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

# flax names a VUNet's conv by the class of its conv_layer_type
_CONV_CLASS = {"l1": "NormConv2d", "l2": "L2NormConv2d",
               "ln": "LayerNormConv2d"}
# each conv layer's first state-dict entry, which marks its type
_CONV_FIRST = {"l1": "conv.weight_v", "l2": "weight", "ln": "conv.weight"}


def _vunet_conv(key: str, parent: Tuple[str, ...], index: int,
                conv: str) -> Plan:
    """Conv ``index`` of its flax parent in layer type ``conv``: ``l1``
    NormConv2d (v, g, bias, gamma, beta), ``l2`` L2NormConv2d (w, bias,
    gamma, beta -> ``weight``, ``bias``, ``gamma``, ``beta``), ``ln``
    LayerNormConv2d (its ``Conv_0`` -> ``conv.weight``, ``conv.bias``)."""
    path = parent + (f"{_CONV_CLASS[conv]}_{index}",)
    if conv == "l1":
        return _norm_conv(key, path)
    if conv == "l2":
        return [(f"{key}.weight", path + ("w",), "hwio"),
                (f"{key}.bias", path + ("bias",), "id"),
                (f"{key}.gamma", path + ("gamma",), "c4"),
                (f"{key}.beta", path + ("beta",), "c4")]
    return [(f"{key}.conv.weight", path + ("Conv_0", "kernel"), "hwio"),
            (f"{key}.conv.bias", path + ("Conv_0", "bias"), "id")]


def _rnb(key: str, path: Tuple[str, ...], residual: bool,
         conv: str = "l1") -> Plan:
    if residual:
        return (_vunet_conv(f"{key}.nin", path, 0, conv)
                + _vunet_conv(f"{key}.conv", path, 1, conv))
    return _vunet_conv(f"{key}.conv", path, 0, conv)


def _vunet_plan(n_scales: int, n_scales_x: int, n_latent_scales: int,
                org: bool, conv: str = "l1") -> Plan:
    plan: Plan = []
    for net, ns in (("eu", n_scales_x), ("du", n_scales)):
        plan += _vunet_conv(f"{net}.nin", (net,), 0, conv)
        for k in range(2 * ns):
            plan += _rnb(f"{net}.blocks.{k}", (net, f"VunetRNB_{k}"), False,
                         conv)
        for i in range(ns - 1):
            plan += _vunet_conv(f"{net}.downs.{i}.down",
                                (net, f"Downsample_{i}"), 0, conv)
    plan += _vunet_conv("ed.nin", ("ed",), 0, conv)
    # ed's convs: the latent means (and, alter, logstds) in order
    per_scale = 1 if org else 2
    for i in range(n_latent_scales):
        plan += _rnb(f"ed.blocks.{2 * i}", ("ed", f"VunetRNB_{2 * i}"), True,
                     conv)
        plan += _vunet_conv(f"ed.make_latent_params.{i}", ("ed",),
                            1 + per_scale * i, conv)
        if not org:
            plan += _vunet_conv(f"ed.make_logstds.{i}", ("ed",), 2 + 2 * i,
                                conv)
        plan += _rnb(f"ed.blocks.{2 * i + 1}",
                     ("ed", f"VunetRNB_{2 * i + 1}"), True, conv)
        plan += _vunet_conv(f"ed.ups.{i}.up", ("ed", f"Upsample_{i}"), 0,
                            conv)
    plan += _rnb("ed.fin_block", ("ed", f"VunetRNB_{2 * n_latent_scales}"),
                 True, conv)
    plan += _vunet_conv("dd.nin", ("dd",), 0, conv)
    rnb, n_conv = 0, 1     # flax numbers dd's VunetRNB and convs apart

    def dd_rnb(key, residual=True):
        nonlocal rnb
        rnb += 1
        return _rnb(key, ("dd", f"VunetRNB_{rnb - 1}"), residual, conv)

    def dd_conv(key):
        nonlocal n_conv
        n_conv += 1
        return _vunet_conv(key, ("dd",), n_conv - 1, conv)

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
            plan += _vunet_conv(f"dd.ups.{i}.up", ("dd", f"Upsample_{i}"),
                                0, conv)
    plan += dd_conv("dd.out_conv")
    return plan


def vunet_alter_plan(n_scales: int, n_scales_x: int,
                     n_latent_scales: int = 2, conv: str = "l1") -> Plan:
    """The mapping of ``convert_vunet_alter`` in the JAX package (for
    ``conv`` ``l1``; ``l2`` and ``ln`` map the other conv layers' trees,
    which the JAX package does not convert)."""
    return _vunet_plan(n_scales, n_scales_x, n_latent_scales, org=False,
                       conv=conv)


def vunet_org_plan(n_scales: int, n_scales_x: int,
                   n_latent_scales: int = 2, conv: str = "l1") -> Plan:
    """The mapping of ``convert_vunet_org`` in the JAX package: the
    autoregressive prior's ``dd.auto_blocks.l_{i}.{0..3}``,
    ``dd.auto_lp.l_{i}.{0..3}`` and ``dd.latent_nins.l_{i}``."""
    return _vunet_plan(n_scales, n_scales_x, n_latent_scales, org=True,
                       conv=conv)


def _tree_conv(p: Mapping) -> str:
    """The conv layer type of a VUNet tree, read off its du."""
    for conv, cls in _CONV_CLASS.items():
        if f"{cls}_0" in p["du"]:
            return conv
    raise KeyError("the VUNet tree's du holds no known conv layer")


def _state_dict_conv(state_dict: Mapping) -> str:
    for conv, first in _CONV_FIRST.items():
        if f"du.nin.{first}" in state_dict:
            return conv
    raise KeyError("the VUNet state dict's du.nin is no known conv layer")


def _vunet_from_flax(tree: Mapping, plan_fn) -> Dict[str, torch.Tensor]:
    p = _params(tree)
    return from_flax(p, plan_fn(
        _count(p["du"], "VunetRNB_") // 2, _count(p["eu"], "VunetRNB_") // 2,
        _count(p["ed"], "Upsample_"), _tree_conv(p)))


def _state_dict_plan(state_dict: Mapping, plan_fn) -> Plan:
    conv = _state_dict_conv(state_dict)
    first = _CONV_FIRST[conv]

    def n_blocks(net):
        return sum(1 for k in state_dict if k.startswith(f"{net}.blocks.")
                   and k.endswith(f".conv.{first}"))
    n_latent = sum(1 for k in state_dict if k.startswith("ed.ups.")
                   and k.endswith(f".up.{first}"))
    return plan_fn(n_blocks("du") // 2, n_blocks("eu") // 2, n_latent, conv)


def _vunet_to_flax(state_dict: Mapping, plan_fn) -> Dict[str, Any]:
    return to_flax(state_dict, _state_dict_plan(state_dict, plan_fn))


def vunet_alter_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """VUNet(variant="alter") params ({"params": ...} or bare) -> state
    dict; the scale counts and the conv layer type are read off the
    tree."""
    return _vunet_from_flax(tree, vunet_alter_plan)


def vunet_alter_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    return _vunet_to_flax(state_dict, vunet_alter_plan)


def vunet_org_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """VUNet(variant="org") params ({"params": ...} or bare) -> state dict;
    the scale counts and the conv layer type are read off the tree."""
    return _vunet_from_flax(tree, vunet_org_plan)


def vunet_org_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    return _vunet_to_flax(state_dict, vunet_org_plan)


def _quant_paths(vunet) -> Dict[str, Tuple[str, ...]]:
    """Each NormConv2d of ``vunet`` (by module name) -> its flax path."""
    plan_fn = vunet_org_plan if vunet.variant == "org" else vunet_alter_plan
    suffix = ".conv.weight_v"
    return {key[:-len(suffix)]: path[:-1]
            for key, path, _ in _state_dict_plan(vunet.state_dict(), plan_fn)
            if key.endswith(suffix)}


def quant_to_flax(vunet, scales: Mapping) -> Dict[str, Any]:
    """int8 activation scales of ``vunet`` (``ops.nn.quant_scales``'s keys,
    ``<module>.ax`` / ``.ax_aux``) -> the JAX package's ``quant``
    collection (a nested dict of f32 scalars at each conv's path)."""
    paths = _quant_paths(vunet)
    tree: Dict[str, Any] = {}
    for key, v in scales.items():
        name, leaf = key.rsplit(".", 1)
        node = tree
        for p in paths[name]:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(torch.as_tensor(v).detach().cpu(),
                                np.float32)
    return tree


def quant_from_flax(vunet, tree: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ``quant`` collection -> ``vunet``'s scales, for
    ``ops.nn.load_quant_scales`` or ``BehaviorTransferPipeline.generate``;
    the inverse of :func:`quant_to_flax`."""
    tree = tree.get("quant", tree)
    scales = {}
    for name, path in _quant_paths(vunet).items():
        node = tree
        for p in path:
            node = node.get(p) if isinstance(node, Mapping) else None
            if node is None:
                break
        if isinstance(node, Mapping):
            for leaf in ("ax", "ax_aux"):
                if leaf in node:
                    scales[f"{name}.{leaf}"] = torch.from_numpy(
                        np.array(node[leaf], np.float32))
    return scales


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


# -- image-synthesis discriminators (models/synth_discriminators.py) --------

def patchgan_plan(n_convs: int) -> Plan:
    """``PatchGANDiscriminator`` with ``n_convs`` convs (n_layers + 2):
    ``convs.{i}`` <-> flax ``Conv_{i}`` (OIHW <-> HWIO kernel, bias)."""
    return [e for i in range(n_convs) for e in (
        (f"convs.{i}.weight", (f"Conv_{i}", "kernel"), "hwio"),
        (f"convs.{i}.bias", (f"Conv_{i}", "bias"), "id"))]


def patchgan_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    p = _params(tree)
    return from_flax(p, patchgan_plan(_count(p, "Conv_")))


def patchgan_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    return to_flax(state_dict, patchgan_plan(sum(
        1 for k in state_dict if k.endswith(".weight"))))


def part_discriminator_plan(n_scales: int) -> Plan:
    """``PartDiscriminator``: ``conv_in`` <-> ``NormConv2d_0``,
    ``blocks.{i}`` <-> ``VunetRNB_{i}``, ``downs.{i}`` <->
    ``Downsample_{i}``, ``dense`` <-> ``Dense_0``."""
    plan = _norm_conv("conv_in", ("NormConv2d_0",))
    for i in range(n_scales):
        plan += _rnb(f"blocks.{i}", (f"VunetRNB_{i}",), False)
        plan += _norm_conv(f"downs.{i}.down",
                           (f"Downsample_{i}", "NormConv2d_0"))
    return plan + _dense("dense", ("Dense_0",))


def part_discriminator_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    p = _params(tree)
    return from_flax(p, part_discriminator_plan(_count(p, "VunetRNB_")))


def part_discriminator_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    return to_flax(state_dict, part_discriminator_plan(sum(
        1 for k in state_dict
        if k.startswith("blocks.") and k.endswith(".conv.conv.weight_v"))))


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


# -- the dormant modules: layers, flows, RIM, discriminators ------------------

def _n(keys, prefix: str, suffix: str = "") -> int:
    """The number of consecutive indices i from 0 with
    ``prefix{i}suffix`` in keys."""
    n = 0
    while f"{prefix}{n}{suffix}" in keys:
        n += 1
    return n


def basic_unconnected_net_plan(n_dense: int) -> Plan:
    """``BasicUnConnectedNet``: ``net.main.{2k}`` <-> ``Dense_{k}``."""
    return _mlp("net", (), n_dense)


def basic_unconnected_net_from_flax(tree: Mapping
                                    ) -> Dict[str, torch.Tensor]:
    p = _params(tree)
    return from_flax(p, basic_unconnected_net_plan(_count(p, "Dense_")))


def basic_unconnected_net_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    return to_flax(state_dict, basic_unconnected_net_plan(
        sum(1 for k in state_dict if k.endswith(".weight"))))


def feature_layer_plan(key: str = "", path: Tuple[str, ...] = ()) -> Plan:
    """``FeatureLayer``: ``conv.weight`` <-> ``Conv_0/kernel`` (HWIO),
    ``loc`` and ``scale`` as they are."""
    return [(f"{key}conv.weight", path + ("Conv_0", "kernel"), "hwio"),
            (f"{key}loc", path + ("loc",), "id"),
            (f"{key}scale", path + ("scale",), "id")]


def feature_layer_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    return from_flax(_params(tree), feature_layer_plan())


def feature_layer_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    return to_flax(state_dict, feature_layer_plan())


def dense_encoder_layer_plan(key: str = "",
                             path: Tuple[str, ...] = ()) -> Plan:
    """``DenseEncoderLayer``: ``dense`` <-> ``Dense_0`` (the (H, W, C)
    flatten of both sides is the same, so the kernel only transposes)."""
    return _dense(f"{key}dense", path + ("Dense_0",))


def dense_encoder_layer_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    return from_flax(_params(tree), dense_encoder_layer_plan())


def dense_encoder_layer_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    return to_flax(state_dict, dense_encoder_layer_plan())


def _coupling_type(has) -> str:
    """The coupling type whose MLPs are there (``has(net)``); affine and
    GIN share one layout, which :func:`unconditional_flow_plan` reads the
    same either way."""
    return next(t for t, nets in COUPLING_NETS.items()
                if all(has(n) for n in nets))


def _sd_flow(state_dict: Mapping, key: str):
    """(n_flows, n_dense, coupling type) of a flow stack's state dict under
    key."""
    n_flows = _n(state_dict, f"{key}sub_layers.", ".norm_layer.loc")
    coupling = f"{key}sub_layers.0.coupling."
    ctype = _coupling_type(
        lambda n: f"{coupling}{n}.0.main.0.weight" in state_dict)
    net = f"{coupling}{COUPLING_NETS[ctype][0]}.0."
    n_dense = sum(1 for k in state_dict
                  if k.startswith(net) and k.endswith(".weight"))
    return n_flows, n_dense, ctype


def unconditional_flow_plan(n_flows: int, n_dense: int,
                            coupling_type: str = "affine") -> Plan:
    """``UnconditionalFlow`` of any coupling type <-> its flax variables
    (``params`` and the Shuffles' ``buffers``); a spline coupling's MLPs
    are ``coupling.nets.{j}`` <-> ``nets_{j}``, and NICE has t alone."""
    return _flow_blocks("", (), n_flows, n_dense,
                        COUPLING_NETS[coupling_type])


def unconditional_flow_from_flax(variables: Mapping
                                 ) -> Dict[str, torch.Tensor]:
    p = variables["params"]
    coupling = p["sub_layers_0"]["coupling"]
    ctype = _coupling_type(lambda n: f"{n}_0" in coupling)
    n_dense = _count(coupling[f"{COUPLING_NETS[ctype][0]}_0"], "Dense_")
    return from_flax(variables, unconditional_flow_plan(
        _count(p, "sub_layers_"), n_dense, ctype))


def unconditional_flow_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    return to_flax(state_dict, unconditional_flow_plan(
        *_sd_flow(state_dict, "")))


def conditional_flow_plan(n_flows: int, n_dense: int, conditioned: bool,
                          key: str = "", path: Tuple[str, ...] = ()) -> Plan:
    """``ConditionalFlow``: the flow blocks as in
    :func:`unconditional_flow_plan` (affine), and with a
    ``conditioning_option`` other than "none" ``conditioning_layers.{i}``
    <-> ``conditioning_layers_{i}``."""
    plan = _flow_blocks(key, path, n_flows, n_dense)
    if conditioned:
        plan += [e for i in range(n_flows) for e in _dense(
            f"{key}conditioning_layers.{i}",
            ("params",) + path + (f"conditioning_layers_{i}",))]
    return plan


def _tree_conditional_flow(p: Mapping):
    return (_count(p, "sub_layers_"),
            _count(p["sub_layers_0"]["coupling"]["s_0"], "Dense_"),
            "conditioning_layers_0" in p)


def conditional_flow_from_flax(variables: Mapping
                               ) -> Dict[str, torch.Tensor]:
    return from_flax(variables, conditional_flow_plan(
        *_tree_conditional_flow(variables["params"])))


def _sd_conditional_flow(state_dict: Mapping, key: str = ""):
    n_flows, n_dense, _ = _sd_flow(state_dict, key)
    return (n_flows, n_dense,
            f"{key}conditioning_layers.0.weight" in state_dict)


def conditional_flow_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    return to_flax(state_dict, conditional_flow_plan(
        *_sd_conditional_flow(state_dict)))


def dense_embedder_plan(n_hidden: int, key: str = "",
                        path: Tuple[str, ...] = ()) -> Plan:
    """``DenseEmbedder`` with ``n_hidden`` hidden widths: ``net.{3l}`` <->
    ``Dense_{l}``, ``net.{3l+1}`` (ActNorm) <-> ``ActNorm_{l}``, the last
    ``net.{3 n_hidden}`` <-> ``Dense_{n_hidden}``."""
    plan: Plan = []
    for i in range(n_hidden):
        plan += _dense(f"{key}net.{3 * i}", path + (f"Dense_{i}",))
        plan += [(f"{key}net.{3 * i + 1}.{n}", path + (f"ActNorm_{i}", n),
                  "c4") for n in ("loc", "scale")]
    return plan + _dense(f"{key}net.{3 * n_hidden}",
                         path + (f"Dense_{n_hidden}",))


def dense_embedder_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    p = _params(tree)
    return from_flax(p, dense_embedder_plan(_count(p, "ActNorm_")))


def dense_embedder_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    return to_flax(state_dict, dense_embedder_plan(
        sum(1 for k in state_dict if k.endswith(".loc"))))


def embedder_plan(n_down: int, key: str = "",
                  path: Tuple[str, ...] = ()) -> Plan:
    """``Embedder``: ``feature_layers.{i}`` <-> ``FeatureLayer_{i}``,
    ``dense_encode`` <-> ``DenseEncoderLayer_0``."""
    plan: Plan = []
    for i in range(n_down):
        plan += feature_layer_plan(f"{key}feature_layers.{i}.",
                                   path + (f"FeatureLayer_{i}",))
    return plan + dense_encoder_layer_plan(f"{key}dense_encode.",
                                           path + ("DenseEncoderLayer_0",))


def embedder_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    p = _params(tree)
    return from_flax(p, embedder_plan(_count(p, "FeatureLayer_")))


def embedder_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    return to_flax(state_dict, embedder_plan(
        _n(state_dict, "feature_layers.", ".loc")))


def conditional_transformer_plan(n_flows: int, n_dense: int,
                                 conditioned: bool, image: bool,
                                 n_embed: int) -> Plan:
    """``ConditionalTransformer``: ``flow`` <-> ``flow`` (variables, as
    :func:`conditional_flow_plan`), ``embedder`` <-> ``params/embedder``:
    an :func:`embedder_plan` of ``n_embed`` scales for an image
    conditioning, else a :func:`dense_embedder_plan` of ``n_embed``
    hidden widths."""
    embed = embedder_plan if image else dense_embedder_plan
    return (conditional_flow_plan(n_flows, n_dense, conditioned, "flow.",
                                  ("flow",))
            + embed(n_embed, "embedder.", ("params", "embedder")))


def conditional_transformer_from_flax(variables: Mapping
                                      ) -> Dict[str, torch.Tensor]:
    p = variables["params"]
    image = "FeatureLayer_0" in p["embedder"]
    n_embed = _count(p["embedder"], "FeatureLayer_" if image
                     else "ActNorm_")
    return from_flax(variables, conditional_transformer_plan(
        *_tree_conditional_flow(p["flow"]), image, n_embed))


def conditional_transformer_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    image = "embedder.feature_layers.0.loc" in state_dict
    n_embed = (_n(state_dict, "embedder.feature_layers.", ".loc") if image
               else sum(1 for k in state_dict
                        if k.startswith("embedder.") and k.endswith(".loc")))
    return to_flax(state_dict, conditional_transformer_plan(
        *_sd_conditional_flow(state_dict, "flow."), image, n_embed))


def made_plan(n_layers: int, conditioned: bool) -> Plan:
    """``ARFullyConnectedNet``: ``net.{i}`` (MaskedDense) <-> ``net_{i}``,
    ``condnet.{i}`` <-> ``condnet_{i}``; the masks are not parameters."""
    plan = [e for i in range(n_layers)
            for e in _dense(f"net.{i}", (f"net_{i}",))]
    if conditioned:
        plan += [e for i in range(n_layers)
                 for e in _dense(f"condnet.{i}", (f"condnet_{i}",))]
    return plan


def made_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    p = _params(tree)
    return from_flax(p, made_plan(_count(p, "net_"), "condnet_0" in p))


def made_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    return to_flax(state_dict, made_plan(_n(state_dict, "net.", ".weight"),
                                         "condnet.0.weight" in state_dict))


def rim_cell_plan(key: str = "", path: Tuple[str, ...] = ()) -> Plan:
    """``RIMCell``: ``key_net`` and ``value_net`` <-> Dense, the
    GroupDense ``w`` (units, din, dout) as it is; the grouped cell's
    ``rnn.x2h`` and ``rnn.h2h`` <-> ``rnn/GroupDense_0`` and ``_1``."""
    plan = (_dense(f"{key}key_net", path + ("key_net",))
            + _dense(f"{key}value_net", path + ("value_net",)))
    for name in ("query_net", "comm_query", "comm_key", "comm_value",
                 "comm_out"):
        plan.append((f"{key}{name}.w", path + (name, "w"), "id"))
    for i, name in enumerate(("x2h", "h2h")):
        plan.append((f"{key}rnn.{name}.w",
                     path + ("rnn", f"GroupDense_{i}", "w"), "id"))
    return plan


def rim_cell_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    return from_flax(_params(tree), rim_cell_plan())


def rim_cell_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    return to_flax(state_dict, rim_cell_plan())


def rim_plan(n_cells: int) -> Plan:
    """``RIM``: ``cells.{i}`` <-> ``cells_{i}/RIMCell_0`` (layer-major,
    then direction)."""
    return [e for i in range(n_cells)
            for e in rim_cell_plan(f"cells.{i}.",
                                   (f"cells_{i}", "RIMCell_0"))]


def rim_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    p = _params(tree)
    return from_flax(p, rim_plan(_count(p, "cells_")))


def rim_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    return to_flax(state_dict, rim_plan(_n(state_dict, "cells.",
                                           ".key_net.weight")))


def _fc_head(n_hidden: int, hidden_key: str) -> Plan:
    """``{hidden_key}.{i}`` <-> ``Dense_{i}``, ``out`` <-> the last
    Dense."""
    return [e for i in range(n_hidden)
            for e in _dense(f"{hidden_key}.{i}", (f"Dense_{i}",))] \
        + _dense("out", (f"Dense_{n_hidden}",))


def sequence_disc_plan(n_layers_class: int) -> Plan:
    """``SequenceDisc``: ``rnn`` <-> ``LSTM_0``, ``fc.{i}`` <->
    ``Dense_{i}``, ``out`` <-> the last Dense."""
    return _rnn_l0("rnn", ("LSTM_0",)) + _fc_head(n_layers_class, "fc")


def sequence_disc_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    p = _params(tree)
    return from_flax(p, sequence_disc_plan(_count(p, "Dense_") - 1))


def sequence_disc_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    return to_flax(state_dict, sequence_disc_plan(
        _n(state_dict, "fc.", ".weight")))


def sequence_disc_conv_plan(n_layers_class: int) -> Plan:
    """``SequenceDiscConv``: ``conv1`` and ``conv2`` <-> ``Conv_0`` and
    ``Conv_1`` (HWIO), the head as in :func:`sequence_disc_plan`."""
    return [e for i in (0, 1) for e in (
        (f"conv{i + 1}.weight", (f"Conv_{i}", "kernel"), "hwio"),
        (f"conv{i + 1}.bias", (f"Conv_{i}", "bias"), "id"))] \
        + _fc_head(n_layers_class, "fc")


def sequence_disc_conv_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    p = _params(tree)
    return from_flax(p, sequence_disc_conv_plan(_count(p, "Dense_") - 1))


def sequence_disc_conv_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    return to_flax(state_dict, sequence_disc_conv_plan(
        _n(state_dict, "fc.", ".weight")))


def midisc_plan(n_layers: int) -> Plan:
    """``MIDisc``: ``net.{i}`` <-> ``Dense_{i}``, ``out`` <-> the last
    Dense."""
    return _fc_head(n_layers, "net")


def midisc_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    p = _params(tree)
    return from_flax(p, midisc_plan(_count(p, "Dense_") - 1))


def midisc_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    return to_flax(state_dict, midisc_plan(_n(state_dict, "net.",
                                              ".weight")))


def midisc_conv_plan(n_layers: int) -> Plan:
    """``MIDiscConv``: ``conv_in`` and ``conv_out`` <-> ``L2NormConv2d_0``
    and ``_1``, ``blocks.{i}`` <-> ``VunetRNB_{i}`` (l2 convs)."""
    plan = _vunet_conv("conv_in", (), 0, "l2")
    for i in range(n_layers):
        plan += _rnb(f"blocks.{i}", (f"VunetRNB_{i}",), False, "l2")
    return plan + _vunet_conv("conv_out", (), 1, "l2")


def midisc_conv_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    p = _params(tree)
    return from_flax(p, midisc_conv_plan(_count(p, "VunetRNB_")))


def midisc_conv_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    return to_flax(state_dict, midisc_conv_plan(
        _n(state_dict, "blocks.", ".conv.weight")))


def resnet_block_2d_plan(shortcut: bool) -> Plan:
    """``ResnetBlock2D``: flax names its convs in creation order, the
    shortcut (when there is one) first: ``shortcut``, ``conv1``, ``conv2``
    <-> ``Conv_{0,1,2}`` (else ``conv1``, ``conv2`` <-> ``Conv_{0,1}``);
    ``norm{1,2}`` <-> ``GroupNorm_{0,1}`` (weight <-> scale)."""
    convs = (["shortcut"] if shortcut else []) + ["conv1", "conv2"]
    plan: Plan = []
    for i, name in enumerate(convs):
        plan += [(f"{name}.weight", (f"Conv_{i}", "kernel"), "hwio"),
                 (f"{name}.bias", (f"Conv_{i}", "bias"), "id")]
    for i in (0, 1):
        plan += [(f"norm{i + 1}.weight", (f"GroupNorm_{i}", "scale"), "id"),
                 (f"norm{i + 1}.bias", (f"GroupNorm_{i}", "bias"), "id")]
    return plan


def resnet_block_2d_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    p = _params(tree)
    return from_flax(p, resnet_block_2d_plan(_count(p, "Conv_") == 3))


def resnet_block_2d_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    return to_flax(state_dict, resnet_block_2d_plan(
        "shortcut.weight" in state_dict))


def self_attention_2d_plan() -> Plan:
    """``SelfAttention2D``: ``W{f,g,h,v}.weight`` <-> ``W{f,g,h,v}/kernel``
    (1x1 HWIO), ``beta`` as it is."""
    return [(f"{n}.weight", (n, "kernel"), "hwio")
            for n in ("Wf", "Wg", "Wh", "Wv")] + [("beta", ("beta",), "id")]


def self_attention_2d_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    return from_flax(_params(tree), self_attention_2d_plan())


def self_attention_2d_to_flax(state_dict: Mapping) -> Dict[str, Any]:
    return to_flax(state_dict, self_attention_2d_plan())
