"""The parameters of the served networks, named and shaped from a
configuration alone.

Names follow the original PyTorch code's state dicts (the CompVis
reference's ``behavior_net`` and VUNet modules), which is also how the
program under test names them, so one set of tensors made by the
benchmark loads into the program by name and feeds this reference as it
is.  Each entry is ``(name, shape, kind)``; ``kind`` says how the
benchmark draws the values (``weights.py``).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

Spec = List[Tuple[str, Tuple[int, ...], str]]


def variant(cfg: dict) -> str:
    """"alter" for the cvbae synthesis net, "org" for the original VUNet."""
    return "org" if cfg["synthesis_net"]["experiment"] == "vunet" else "alter"


def n_scales(cfg: dict) -> int:
    s = cfg["synthesis_net"]
    if int(s["n_scales"]) >= 6:
        return int(s["n_scales"])
    size = int(s["spatial_size"])
    return 1 + (size.bit_length() - 1) - int(s["bottleneck_factor"])


def appearance_shape(cfg: dict) -> Tuple[int, int, int]:
    """(H, W, C) of one video's appearance input: an RGB image, or the
    30-channel part stack at 1 / 2**box_factor of the image's size."""
    s = cfg["synthesis_net"]
    size = int(s["spatial_size"])
    if s["inplane_normalize"]:
        side = size // 2 ** int(s["box_factor"])
        return (side, side, 30)
    return (size, size, 3)


def _normconv(spec: Spec, name: str, cin: int, cout: int, k: int) -> None:
    spec += [(f"{name}.gamma", (1, cout, 1, 1), "gamma"),
             (f"{name}.beta", (1, cout, 1, 1), "beta"),
             (f"{name}.conv.weight_v", (cout, cin, k, k), "direction"),
             (f"{name}.conv.weight_g", (cout, 1, 1, 1), "magnitude"),
             (f"{name}.conv.bias", (cout,), "bias")]


def _rnb(spec: Spec, name: str, c: int, aux: int = 0) -> None:
    if aux:
        _normconv(spec, f"{name}.nin", aux, c, 1)
    _normconv(spec, f"{name}.conv", 2 * c if aux else c, c, 3)


def _enc_up(spec: Spec, name: str, cin: int, scales: int, nf: int,
            nf_max: int) -> List[int]:
    out = []
    _normconv(spec, f"{name}.nin", cin, nf, 1)
    for i in range(scales):
        for j in range(2):
            _rnb(spec, f"{name}.blocks.{2 * i + j}", nf)
            out.append(nf)
        if i + 1 < scales:
            nxt = min(2 * nf, nf_max)
            _normconv(spec, f"{name}.downs.{i}.down", nf, nxt, 3)
            nf = nxt
    return out


def _enc_down(spec: Spec, skips: List[int], nf: int, latent: int,
              alter: bool) -> None:
    skips = list(skips)
    _normconv(spec, "ed.nin", skips[-1], nf, 1)
    for i in range(latent):
        _rnb(spec, f"ed.blocks.{2 * i}", nf, skips.pop())
        _normconv(spec, f"ed.make_latent_params.{i}", nf, nf, 3)
        if alter:
            _normconv(spec, f"ed.make_logstds.{i}", nf, nf, 3)
        _rnb(spec, f"ed.blocks.{2 * i + 1}", nf, skips.pop() + nf)
        _normconv(spec, f"ed.ups.{i}.up", nf, 4 * nf, 3)
    _rnb(spec, "ed.fin_block", nf, skips.pop())


def dec_down_widths(scales: int, nf_in: int, nf_last: int) -> List[int]:
    """The generator's width at each scale, coarsest first."""
    widths = [nf_in]
    for i in range(scales - 1):
        widths.append(min(nf_in, nf_last * 2 ** (scales - (i + 2))))
    return widths


def _dec_down(spec: Spec, skips: List[int], scales: int, nf_in: int,
              nf_last: int, latent: int, alter: bool) -> None:
    skips = list(skips)
    widths = dec_down_widths(scales, nf_in, nf_last)
    _normconv(spec, "dd.nin", skips[-1], nf_in, 1)
    for i, nf in enumerate(widths):
        _rnb(spec, f"dd.blocks.{2 * i}", nf, skips.pop())
        if i < latent and alter:
            _rnb(spec, f"dd.auto_blocks.{i}", nf, nf)
        elif i < latent:
            # the autoregressive prior of the original VUNet: sampling
            # only, so serving from posterior means never runs it
            _rnb(spec, f"dd.auto_blocks.l_{i}.0", nf)
            for j in range(1, 4):
                _rnb(spec, f"dd.auto_blocks.l_{i}.{j}", 4 * nf, nf)
            for j in range(4):
                _normconv(spec, f"dd.auto_lp.l_{i}.{j}", 4 * nf, nf, 3)
            _normconv(spec, f"dd.latent_nins.l_{i}", 2 * nf, nf, 1)
        _rnb(spec, f"dd.blocks.{2 * i + 1}", nf, skips.pop())
        if i + 1 < scales:
            _normconv(spec, f"dd.ups.{i}.up", nf, 4 * widths[i + 1], 3)
    _normconv(spec, "dd.out_conv", widths[-1], 3, 3)


def vunet_spec(cfg: dict) -> Spec:
    s = cfg["synthesis_net"]
    if s["conv_layer_type"] != "l1" or not s["subpixel_upsampling"]:
        raise ValueError("the reference covers the l1 conv layer with "
                         "subpixel upsampling")
    alter = variant(cfg) == "alter"
    scales = n_scales(cfg)
    cx = appearance_shape(cfg)[2]
    scales_x = scales - int(s["box_factor"]) if cx > 3 else scales
    nf, nf_max, latent = (int(s["nf_start"]), int(s["nf_max"]),
                          int(s["n_latent_scales"]))
    spec: Spec = []
    eu = _enc_up(spec, "eu", cx, scales_x, nf, nf_max)
    _enc_down(spec, eu, nf_max, latent, alter)
    du = _enc_up(spec, "du", 3, scales, nf, nf_max)
    _dec_down(spec, du, scales, nf_max, nf, latent, alter)
    return spec


def n_kps_used(cfg: dict) -> int:
    return len(cfg["assumed"]["dim_to_use"])


def behavior_spec(cfg: dict) -> Spec:
    """The behavior net: its encoder (used by ``reenact``, loaded all the
    same) and the residual LSTM decoder."""
    b = cfg["behavior_net"]
    if b["decoder_arch"] != "lstm" or b["linear_in_decoder"]:
        raise ValueError("the reference covers the LSTM decoder without nin")
    k, h = n_kps_used(cfg), int(b["dim_hidden_b"])
    spec: Spec = [("b_enc.rnn.weight_ih_l0", (4 * h, k), "weight"),
                  ("b_enc.rnn.weight_hh_l0", (4 * h, h), "weight"),
                  ("b_enc.rnn.bias_ih_l0", (4 * h,), "bias"),
                  ("b_enc.rnn.bias_hh_l0", (4 * h,), "bias")]
    for head in ("mu_fn", "std_fn"):
        _normconv(spec, f"b_enc.{head}", h, h, 1)
    spec += [("decoder.rnn.weight_ih", (4 * h, k), "weight"),
             ("decoder.rnn.weight_hh", (4 * h, h), "weight"),
             ("decoder.rnn.bias_ih", (4 * h,), "bias"),
             ("decoder.rnn.bias_hh", (4 * h,), "bias"),
             ("decoder.n_out.weight", (k, h), "step"),
             ("decoder.n_out.bias", (k,), "step_bias")]
    return spec


def flow_dims(cfg: dict) -> Dict[str, int]:
    b = cfg["behavior_net"]
    c = int(b["dim_hidden_b"])
    return dict(c=c, mid=c * int(b["flow_mid_channels_factor"]),
                depth=int(b["flow_hidden_depth"]), n_flows=int(b["n_flows"]),
                dim1=c // 2 + c % 2, dim2=c // 2)


def mlp_layers(d: Dict[str, int]) -> List[Tuple[int, int]]:
    """(in, out) of each Linear of one coupling MLP."""
    return ([(d["dim1"], d["mid"])] + [(d["mid"], d["mid"])] * d["depth"]
            + [(d["mid"], d["dim2"])])


def flow_spec(cfg: dict) -> Spec:
    """The affine coupling flow: ActNorm, two couplings of an s and a t MLP
    each, and a fixed shuffle, per flow.  The last Linear of each MLP is
    kind ``head``, drawn smaller (``weights.py``)."""
    d = flow_dims(cfg)
    layers = mlp_layers(d)
    spec: Spec = []
    for f in range(d["n_flows"]):
        p = f"flow.sub_layers.{f}"
        spec += [(f"{p}.norm_layer.loc", (1, d["c"], 1, 1), "loc"),
                 (f"{p}.norm_layer.scale", (1, d["c"], 1, 1), "scale")]
        for net in ("s", "t"):
            for i in range(2):
                for j, (fin, fout) in enumerate(layers):
                    kind = "head" if j + 1 == len(layers) else "weight"
                    q = f"{p}.coupling.{net}.{i}.main.{2 * j}"
                    spec += [(f"{q}.weight", (fout, fin), kind),
                             (f"{q}.bias", (fout,), "bias")]
        spec.append((f"{p}.shuffle.forward_shuffle_idx", (d["c"],),
                     "permutation"))
    return spec
