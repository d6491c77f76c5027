"""The benchmark's yardstick: the card's published peaks, the least time of
the hand-written kernels' work, and the model FLOPs of one request.

Peaks are NVIDIA's H100 SXM data sheet figures (dense, at the 700 W
limit).  ``rollout_bound_ms`` and ``fused_rnb_bound_ms`` are frozen copies
of the bring-up's ``chip_smoke.py`` functions of those names.  The FLOPs
are those of the reference's float32 program (``reference/model.py``) at
the request's shapes, counted by ``torch.utils.flop_counter`` on the meta
device, so the count reads the same work whatever computes it.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference import model as R
from .reference import spec as S
from .traffic import latent_sizes
from .weights import full_spec

# NVIDIA's H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12


def rollout_bound_ms(B, K, H, T):
    """Least time of the rollout at (B, K, H, T): its bytes (bf16 weights
    and f32 inputs read once, the f32 output written once) over the HBM
    rate, against its gate and output products at the bf16 tensor-core
    peak.  (The T steps depend on each other, which this bound ignores.)"""
    weights = 2 * (4 * H * K + 4 * H * H + K * H)
    vectors = 4 * (2 * 4 * H + K + B * H + B * K) + 4 * B * T * K
    flops = T * (2 * B * (K + H) * 4 * H + 2 * B * H * K)
    t_bytes = (weights + vectors) / HBM_BYTES_PER_S
    t_ops = flops / BF16_TENSOR_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def fused_rnb_bound_ms(B, H, W, C):
    """Least time of one fused RNB at (B, H, W, C) bf16: x read and out
    written once, the bf16 W and the f32 scale and shift read once, against
    the 3x3 conv's 2 * 9 * C * C operations a pixel at the bf16
    tensor-core peak."""
    n = B * H * W * C
    t_bytes = (2 * n * 2 + 9 * C * C * 2 + 2 * C * 4) / HBM_BYTES_PER_S
    t_ops = 2 * 9 * C * n / BF16_TENSOR_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def chunk_size(n: int, vunet_chunk: int) -> Tuple[int, int]:
    """(frames a VUNet call, padded frames) of n frames: an exact divisor
    in (vunet_chunk / 2, vunet_chunk], else chunks of vunet_chunk and the
    tail padded (the serving program's documented chunking)."""
    if n <= vunet_chunk:
        return n, n
    for cs in range(vunet_chunk, vunet_chunk // 2, -1):
        if n % cs == 0:
            return cs, n
    return vunet_chunk, -(-n // vunet_chunk) * vunet_chunk


def _enc_up_sites(batch: int, side: int, scales: int, nf: int,
                  nf_max: int) -> List[Tuple[int, int, int, int]]:
    sites = []
    for _ in range(scales):
        sites += [(batch, side, side, nf)] * 2
        side, nf = side // 2, min(2 * nf, nf_max)
    return sites


def fused_rnb_sites(cfg: dict, traffic: dict) -> List[Tuple[int, int, int,
                                                            int]]:
    """(B, H, W, C) of each fused RNB launch of one request, in order: the
    two blocks a scale of the appearance encoder, once a request, then of
    the shape encoder, once a chunk of frames.  Empty unless the
    configuration serves ``rnb_impl: fused``."""
    if cfg["serving"]["rnb_impl"] != "fused":
        return []
    s = cfg["synthesis_net"]
    V, T = int(traffic["videos"]), int(traffic["frames"])
    nf, nf_max = int(s["nf_start"]), int(s["nf_max"])
    scales = S.n_scales(cfg)
    h, _, c = S.appearance_shape(cfg)
    scales_x = scales - int(s["box_factor"]) if c > 3 else scales
    sites = _enc_up_sites(V, h, scales_x, nf, nf_max)
    cs, padded = chunk_size(V * T, int(cfg["serving"]["vunet_chunk"]))
    for _ in range(padded // cs):
        sites += _enc_up_sites(cs, int(s["spatial_size"]), scales, nf,
                               nf_max)
    return sites


def _meta_params(cfg: dict) -> Dict[str, torch.Tensor]:
    return {n: torch.empty(shape, device="meta",
                           dtype=torch.long if kind == "permutation"
                           else torch.float32)
            for n, shape, kind in full_spec(cfg)}


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def request_flops(cfg: dict, traffic: dict) -> Dict[str, int]:
    """Model FLOPs of one request, by part: the flow inverse's products,
    the rollout's gate and output products, the appearance encoder's and
    the per-frame generator's convolutions."""
    P = _meta_params(cfg)
    V, T = int(traffic["videos"]), int(traffic["frames"])
    H = int(cfg["behavior_net"]["dim_hidden_b"])
    K = S.n_kps_used(cfg)
    size = int(cfg["synthesis_net"]["spatial_size"])
    nf = int(cfg["synthesis_net"]["nf_max"])

    def meta(*shape):
        return torch.empty(shape, device="meta")
    eps = [meta(V, s, s, nf) for s in latent_sizes(cfg)]
    means1 = [meta(1, s, s, nf) for s in latent_sizes(cfg)]
    return dict(
        flow=_count(lambda: R.flow_reverse(P, cfg, meta(V, H))),
        rollout=_count(lambda: R.rollout(P, meta(V, H), meta(V, K), T)),
        encode=_count(lambda: R.encode_means(
            P, cfg, meta(V, *S.appearance_shape(cfg)), eps)),
        transfer=V * T * _count(lambda: R.transfer(
            P, cfg, means1, meta(1, size, size, 3))))
