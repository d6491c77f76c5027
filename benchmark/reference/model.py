"""The served video program in plain PyTorch: flow inverse, residual LSTM
rollout, unnormalize, camera projection, stickman raster and the VUNet's
appearance encoder and per-frame generator.

Written from the published description (the CompVis reference code and
the configuration), in float32 with TF32 off, NHWC, without kernels,
caches or chunking.  It imports nothing of the program under test, and
takes only the parameters ``P`` (name -> tensor, named as in ``spec.py``)
and the request's inputs; everything derived from them (weight-norm
kernels, the appearance means, the per-step products) it works out again.

Each stage takes a ``low`` switch: the same stage one precision below
what the configuration states, which is the control that the comparison
must reject (TF32 for the flow's float32 products, scaled fp8 operands
for the rollout's bfloat16 ones, bfloat16 for the camera's and the
raster's float32 arithmetic).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from . import spec as S

Params = Dict[str, torch.Tensor]


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Float32 products and convolutions in full float32 (or, ``tf32``,
    in TF32), restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# -- behavior: flow inverse and rollout ---------------------------------------
def _mlp(P: Params, prefix: str, n_layers: int, x, tanh: bool):
    for j in range(n_layers):
        q = f"{prefix}.main.{2 * j}"
        x = F.linear(x, P[f"{q}.weight"].float(), P[f"{q}.bias"].float())
        if j + 1 < n_layers:
            x = F.leaky_relu(x, 0.01)
    return torch.tanh(x) if tanh else x


@torch.no_grad()
def flow_reverse(P: Params, cfg: dict, z: torch.Tensor,
                 low: bool = False) -> torch.Tensor:
    """Gaussian codes z (B, C) -> behavior latents b (B, C)."""
    d = S.flow_dims(cfg)
    n_layers = len(S.mlp_layers(d))
    x = z.float()
    with matmul_precision(tf32=low):
        for f in reversed(range(d["n_flows"])):
            p = f"flow.sub_layers.{f}"
            x = x[:, torch.argsort(P[f"{p}.shuffle.forward_shuffle_idx"])]
            for i in (1, 0):
                if i == 0:
                    x = torch.cat([x[:, d["dim2"]:], x[:, :d["dim2"]]], 1)
                xa, xb = x[:, :d["dim1"]], x[:, d["dim1"]:]
                s = _mlp(P, f"{p}.coupling.s.{i}", n_layers, xa, True)
                t = _mlp(P, f"{p}.coupling.t.{i}", n_layers, xa, False)
                x = torch.cat([xa, (xb - t) * torch.exp(-s)], 1)
            x = (x / P[f"{p}.norm_layer.scale"].reshape(1, -1)
                 - P[f"{p}.norm_layer.loc"].reshape(1, -1))
    return x


def fp8(v: torch.Tensor) -> torch.Tensor:
    """v rounded to float8 e4m3 with one scale for the tensor."""
    scale = v.abs().amax().clamp_min(1e-30) / 448.0
    return (v / scale).to(torch.float8_e4m3fn).float() * scale


@torch.no_grad()
def rollout(P: Params, b: torch.Tensor, x0: torch.Tensor, length: int,
            low: bool = False) -> torch.Tensor:
    """x_{t+1} = x_t + W_out h_t + b_out after an LSTM step on x_t, from
    h = c = b: (B, length, K) in float32."""
    op = fp8 if low else (lambda v: v)
    w_ih = op(P["decoder.rnn.weight_ih"].float()).t()
    w_hh = op(P["decoder.rnn.weight_hh"].float()).t()
    w_out = op(P["decoder.n_out.weight"].float()).t()
    bias = (P["decoder.rnn.bias_ih"] + P["decoder.rnn.bias_hh"]).float()
    b_out = P["decoder.n_out.bias"].float()
    h = c = b.float()
    x = x0.float()
    xs = []
    with matmul_precision(tf32=False):
        for _ in range(length):
            gates = op(x) @ w_ih + op(h) @ w_hh + bias
            i, f, g, o = torch.chunk(gates, 4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            x = x + (op(h) @ w_out + b_out)
            xs.append(x)
    return torch.stack(xs, dim=1)


def unnormalize(cfg: dict, xs: torch.Tensor) -> torch.Tensor:
    """Normalized poses (B, T, K_used) -> world joints (B, T, J, 3)."""
    a = cfg["assumed"]
    mean = torch.tensor(a["norm_mean"], dtype=torch.float32,
                        device=xs.device)
    std = torch.tensor(a["norm_std"], dtype=torch.float32, device=xs.device)
    idx = torch.tensor(a["dim_to_use"], dtype=torch.long, device=xs.device)
    full = torch.zeros(xs.shape[:-1] + mean.shape, dtype=torch.float32,
                       device=xs.device)
    full[..., idx] = xs.float()
    full = full * std + mean
    return full.reshape(xs.shape[:2] + (-1, 3))


@torch.no_grad()
def poses(P: Params, cfg: dict, z, x_start, length: int,
          low: bool = False) -> torch.Tensor:
    """World joints (B, T, J, 3) of the sampled behavior codes z."""
    b = flow_reverse(P, cfg, z, low)
    return unnormalize(cfg, rollout(P, b, x_start, length, low))


# -- geometry ---------------------------------------------------------------
@torch.no_grad()
def project(world, extrinsics, intrinsics, image_size, spatial: int,
            low: bool = False) -> torch.Tensor:
    """World joints (B, T, J, 3) -> stickman pixels (B, T, J, 2): R x + t,
    then the pinhole (f_x, x_0, f_y, y_0), scaled to the stickman's size."""
    dt = torch.bfloat16 if low else torch.float32
    M = extrinsics.to(dt)[:, None, None]
    cam = torch.sum(M[..., :, :3] * world.to(dt)[..., None, :], -1) \
        + M[..., :, 3]
    f_x, x_0, f_y, y_0 = intrinsics.to(dt)[:, None].unbind(-1)
    zero, one = torch.zeros_like(f_x), torch.ones_like(f_x)
    K = torch.stack([torch.stack([f_x, zero, x_0], -1),
                     torch.stack([zero, f_y, y_0], -1),
                     torch.stack([zero, zero, one], -1)], -2)
    p = cam / cam[..., -1:]
    px = torch.sum(K[..., None, :, :] * p[..., None, :], -1)[..., :2]
    scale = (spatial / image_size.to(dt))[:, None, None, :]
    return (px * scale).float()


def _segments(px, py, a, b, half):
    ax, ay = a[:, 0, None, None], a[:, 1, None, None]
    abx = (b[:, 0] - a[:, 0])[:, None, None]
    aby = (b[:, 1] - a[:, 1])[:, None, None]
    pa_x, pa_y = px[None] - ax, py[None] - ay
    t = torch.clamp((pa_x * abx + pa_y * aby)
                    / (abx * abx + aby * aby + 1e-8), 0.0, 1.0)
    dx, dy = pa_x - t * abx, pa_y - t * aby
    return torch.sqrt(dx * dx + dy * dy) <= half


def _lines(j, lines, px, py, half):
    cov = torch.zeros((j.shape[0],) + px.shape, dtype=torch.bool,
                      device=j.device)
    for ia, ib in lines:
        a, b = j[:, ia], j[:, ib]
        valid = ((a >= 0).all(-1) & (b >= 0).all(-1))[:, None, None]
        cov |= _segments(px, py, a, b, half) & valid
    return cov


def _polygon(px, py, verts):
    """Crossing-number test; an edge with an invalid vertex is skipped."""
    valid = (verts >= 0).all(-1)
    n = verts.shape[1]
    inside = torch.zeros((verts.shape[0],) + px.shape, dtype=torch.bool,
                         device=verts.device)
    for i in range(n):
        k = (i - 1) % n
        xi, yi = verts[:, i, 0, None, None], verts[:, i, 1, None, None]
        xk, yk = verts[:, k, 0, None, None], verts[:, k, 1, None, None]
        cross = ((yi > py) != (yk > py)) & (
            px < (xk - xi) * (py - yi) / (yk - yi + 1e-8) + xi)
        inside ^= cross & (valid[:, i] & valid[:, k])[:, None, None]
    return inside & (valid.sum(-1) > 2)[:, None, None]


@torch.no_grad()
def raster(cfg: dict, joints: torch.Tensor, low: bool = False,
           frames_per_block: int = 64) -> torch.Tensor:
    """Joints (..., J, 2) in pixels -> stickman (..., S, S, 3) on 0..255:
    lines of the configured thickness (right limbs in channel 1, left
    limbs in channel 0, head lines at 127 in both), over the body polygon
    (0, 127, 255); a joint with a negative coordinate is left out."""
    sk = cfg["assumed"]["skeleton"]
    size = int(cfg["synthesis_net"]["spatial_size"])
    half = float(cfg["serving"]["stickman_thickness"]) / 2.0
    dt = torch.bfloat16 if low else torch.float32
    flat = joints.reshape((-1,) + joints.shape[-2:]).to(dt)
    grid = torch.arange(size, dtype=torch.float32, device=joints.device)
    grid = (grid + 0.5).to(dt)
    py, px = torch.meshgrid(grid, grid, indexing="ij")
    out = []
    for s in range(0, flat.shape[0], frames_per_block):
        j = flat[s:s + frames_per_block]
        right = _lines(j, sk["right_lines"], px, py, half)
        left = _lines(j, sk["left_lines"], px, py, half)
        head = _lines(j, sk["head_lines"], px, py, half)
        body = _polygon(px, py, j[:, sk["body"]])
        head = head.float() * 127.0
        ch0 = torch.maximum(left.float() * 255.0, head)
        ch1 = torch.maximum(torch.maximum(right.float() * 255.0, head),
                            body.float() * 127.0)
        out.append(torch.stack([ch0, ch1, body.float() * 255.0], -1))
    out = torch.cat(out)
    return out.reshape(joints.shape[:-2] + out.shape[1:])


def stickman_input(stick: torch.Tensor) -> torch.Tensor:
    """The raster on 0..255 as the VUNet's bfloat16 input in [-1, 1]."""
    return ((stick - 127.5) / 127.5).to(torch.bfloat16)


# -- the VUNet ----------------------------------------------------------------
def _conv(P: Params, name: str, x, aux=None, stride: int = 1):
    """The weight-normalized conv: W = g v / |v| per output channel,
    y = gamma (conv(x, W) + bias) + beta; aux joins x's channels."""
    v = P[f"{name}.conv.weight_v"].float()
    w = v * (P[f"{name}.conv.weight_g"].float()
             / torch.sqrt(torch.sum(v * v, dim=(1, 2, 3), keepdim=True)
                          + 1e-12))
    if aux is not None:
        x = torch.cat([x, aux], -1)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, P[f"{name}.conv.bias"].float(),
                 stride, w.shape[-1] // 2)
    y = y.permute(0, 2, 3, 1)
    return (P[f"{name}.gamma"].reshape(-1) * y
            + P[f"{name}.beta"].reshape(-1))


def _rnb(P: Params, name: str, x, a=None):
    """x + conv(elu(x) [, elu(nin(elu(a)))])."""
    if a is None:
        return x + _conv(P, f"{name}.conv", F.elu(x))
    a = _conv(P, f"{name}.nin", F.elu(a))
    return x + _conv(P, f"{name}.conv", F.elu(x), F.elu(a))


def depth_to_space(x, bs: int = 2):
    """NHWC; channel (i * bs + j) * C + c -> pixel (h * bs + i, w * bs + j)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, bs, bs, c // bs ** 2).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * bs, w * bs, c // bs ** 2)


def _enc_up(P: Params, name: str, x, scales: int) -> List[torch.Tensor]:
    hs = []
    h = _conv(P, f"{name}.nin", x)
    for i in range(scales):
        for j in range(2):
            h = _rnb(P, f"{name}.blocks.{2 * i + j}", h)
            hs.append(h)
        if i + 1 < scales:
            h = _conv(P, f"{name}.downs.{i}.down", h, stride=2)
    return hs


def _scales(cfg: dict):
    s = cfg["synthesis_net"]
    scales = S.n_scales(cfg)
    cx = S.appearance_shape(cfg)[2]
    scales_x = scales - int(s["box_factor"]) if cx > 3 else scales
    return scales, scales_x, int(s["n_latent_scales"])


@torch.no_grad()
def encode_means(P: Params, cfg: dict, app: torch.Tensor,
                 eps: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The posterior means of each latent scale for appearances app
    (B, H, W, C) in [-1, 1]; eps is the posterior noise, one tensor per
    latent scale, which feeds the next scale's features."""
    scales, scales_x, latent = _scales(cfg)
    alter = S.variant(cfg) == "alter"
    with matmul_precision(tf32=False):
        gs = _enc_up(P, "eu", app.float(), scales_x)
        h = _conv(P, "ed.nin", gs[-1])
        means = []
        for i in range(latent):
            h = _rnb(P, f"ed.blocks.{2 * i}", h, gs.pop())
            mu = _conv(P, f"ed.make_latent_params.{i}", h)
            means.append(mu)
            noise = eps[i].float()
            if alter:
                logstd = torch.sigmoid(_conv(P, f"ed.make_logstds.{i}", h))
                z = mu + torch.exp(logstd) * noise
            else:
                z = mu + noise
            if i + 1 < latent:
                # (after the last latent scale the encoder's features feed
                # no mean: its last upsample and final block are not run)
                h = _rnb(P, f"ed.blocks.{2 * i + 1}", h,
                         torch.cat([gs.pop(), z], -1))
                h = depth_to_space(_conv(P, f"ed.ups.{i}.up", h))
    return means


@torch.no_grad()
def transfer(P: Params, cfg: dict, means: Sequence[torch.Tensor],
             stick: torch.Tensor) -> torch.Tensor:
    """Frames (N, S, S, 3) of stickman inputs stick (N, S, S, 3) in
    [-1, 1], each with its video's posterior means (N, ...)."""
    scales, _, latent = _scales(cfg)
    alter = S.variant(cfg) == "alter"
    with matmul_precision(tf32=False):
        gs = _enc_up(P, "du", stick.float(), scales)
        h = _conv(P, "dd.nin", gs[-1])
        for i in range(scales):
            h = _rnb(P, f"dd.blocks.{2 * i}", h, gs.pop())
            if i < latent:
                z = means[i].float()
                if alter:
                    h = _rnb(P, f"dd.auto_blocks.{i}", h, z)
                else:
                    h = _conv(P, f"dd.latent_nins.l_{i}", torch.cat([h, z],
                                                                     -1))
            h = _rnb(P, f"dd.blocks.{2 * i + 1}", h, gs.pop())
            if i + 1 < scales:
                h = depth_to_space(_conv(P, f"dd.ups.{i}.up", h))
        return _conv(P, "dd.out_conv", h)


@torch.no_grad()
def frames(P: Params, cfg: dict, means: Sequence[torch.Tensor],
           stick: torch.Tensor, frames_per_block: int = 25) -> torch.Tensor:
    """Frames (B, T, S, S, 3) of stickmen (B, T, S, S, 3) with the means
    of each video (B, ...), computed a block of frames at a time."""
    B, T = stick.shape[:2]
    flat = stick.reshape((B * T,) + stick.shape[2:])
    out = []
    for s in range(0, B * T, frames_per_block):
        video = torch.arange(s, min(s + frames_per_block, B * T),
                             device=stick.device) // T
        out.append(transfer(P, cfg, [m[video] for m in means],
                            flat[s:s + frames_per_block]))
    out = torch.cat(out)
    return out.reshape((B, T) + out.shape[1:])
