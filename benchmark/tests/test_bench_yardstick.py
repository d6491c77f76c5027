"""The yardstick's counts against hand counts at tiny shapes, and the
VUNet's count against the program's own modules under the same counter."""
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness, yardstick as Y
from benchmark.reference import model as R
from benchmark.reference import spec as S
from benchmark.traffic import latent_sizes, make_pool
from benchmark.weights import make_params

from .conftest import tiny


def test_flow_and_rollout_flops_by_hand():
    cell = tiny("alter256.bulk_b20_t50")
    cfg, traffic = cell.config, cell.traffic
    V, T = traffic["videos"], traffic["frames"]
    d = S.flow_dims(cfg)
    H, K = d["c"], S.n_kps_used(cfg)
    mlp = sum(fin * fout for fin, fout in S.mlp_layers(d))
    f = Y.request_flops(cfg, traffic)
    # 4 MLPs (s and t of two couplings) a flow, 2 FLOPs a multiply-add
    assert f["flow"] == d["n_flows"] * 4 * 2 * V * mlp
    assert f["rollout"] == T * (2 * V * (K + H) * 4 * H + 2 * V * H * K)


def test_vunet_flops_match_the_program(tiny_cell):
    """The reference's count of encode_means and transfer equals the
    program's modules' count under the same FLOP counter."""
    cfg, traffic = tiny_cell.config, tiny_cell.traffic
    params = make_params(cfg, 3, "cpu")
    r = make_pool(cfg, traffic, 3, "cpu")[0]
    pipe, _ = harness.program(cfg, params, "cpu")
    V, T = traffic["videos"], traffic["frames"]
    size = cfg["synthesis_net"]["spatial_size"]
    with torch.inference_mode(), FlopCounterMode(display=False) as c:
        means, _ = pipe.vunet.encode_means(r["app"], r["eps"])
    encode = c.get_total_flops()
    with torch.inference_mode(), FlopCounterMode(display=False) as c:
        pipe.vunet.transfer_cached(
            [torch.repeat_interleave(m, T, 0) for m in means],
            torch.zeros(V * T, size, size, 3, dtype=torch.bfloat16))
    f = Y.request_flops(cfg, traffic)
    assert f["transfer"] == c.get_total_flops()
    # the program also runs the encoder past its last mean (the last
    # latent scale's second block and upsample, and the final block),
    # whose output nothing reads: not model FLOPs
    nf, s = cfg["synthesis_net"]["nf_max"], latent_sizes(cfg)[-1]
    skips = [c for c in _eu_channels(cfg)]
    c_last, c_fin = skips[-(2 * len(latent_sizes(cfg)))], skips[
        -(2 * len(latent_sizes(cfg)) + 1)]
    dead = V * (2 * nf * (c_last + nf) * s * s          # second block's nin
                + 2 * nf * 2 * nf * 9 * s * s           # and its conv
                + 2 * 4 * nf * nf * 9 * s * s           # the upsample
                + 2 * nf * c_fin * 4 * s * s            # final block's nin
                + 2 * nf * 2 * nf * 9 * 4 * s * s)      # and its conv
    assert f["encode"] == encode - dead


def _eu_channels(cfg):
    """Channels of the appearance encoder's outputs, two a scale."""
    s = cfg["synthesis_net"]
    nf, out = s["nf_start"], []
    scales = S.n_scales(cfg)
    if S.appearance_shape(cfg)[2] > 3:
        scales -= s["box_factor"]
    for _ in range(scales):
        out += [nf, nf]
        nf = min(2 * nf, s["nf_max"])
    return out


def test_one_conv_by_hand():
    """2 * Cout * Cin * k * k FLOPs an output pixel."""
    cfg = tiny("alter256.bulk_b20_t50").config
    P = {n: torch.empty(s, device="meta") for n, s, _ in S.vunet_spec(cfg)}
    x = torch.empty(3, 16, 16, 8, device="meta")
    with FlopCounterMode(display=False) as c:
        R._conv(P, "du.blocks.0.conv", x)
    assert c.get_total_flops() == 2 * 8 * 8 * 9 * 3 * 16 * 16


def test_rollout_bound_by_hand():
    B, K, H, T = 1, 48, 1024, 50
    bytes_ = (2 * (4 * H * K + 4 * H * H + K * H)
              + 4 * (8 * H + K + B * H + B * K) + 4 * B * T * K)
    ms, by = Y.rollout_bound_ms(B, K, H, T)
    assert by == "bytes"
    assert ms == pytest.approx(bytes_ / 3.35e12 * 1e3, rel=1e-12)


def test_fused_rnb_bound_by_hand():
    ms, by = Y.fused_rnb_bound_ms(125, 64, 64, 128)
    flops = 2 * 9 * 128 * 125 * 64 * 64 * 128
    assert by == "operations"
    assert ms == pytest.approx(flops / 989e12 * 1e3, rel=1e-12)
    ms, by = Y.fused_rnb_bound_ms(125, 256, 256, 32)
    n = 125 * 256 * 256 * 32
    assert by == "bytes"
    assert ms == pytest.approx((4 * n + 9 * 32 * 32 * 2 + 8 * 32)
                               / 3.35e12 * 1e3, rel=1e-12)


def test_fused_rnb_sites():
    """An org B=20, T=50 request: 2 launches at each of the 5 appearance
    scales, then 2 at each of 7 scales for each of 8 chunks of 125 frames;
    none under the cudnn route."""
    org = harness.load_cell("org256_fused.bulk_b20_t50")
    sites = Y.fused_rnb_sites(org.config, org.traffic)
    assert len(sites) == 2 * 5 + 2 * 7 * 8
    assert sites[0] == (20, 64, 64, 32) and sites[10] == (125, 256, 256, 32)
    assert sites[-1] == (125, 4, 4, 128)
    alter = harness.load_cell("alter256.bulk_b20_t50")
    assert Y.fused_rnb_sites(alter.config, alter.traffic) == []


@pytest.mark.parametrize("n,chunk,want", [(1000, 128, (125, 1000)),
                                          (50, 128, (50, 50)),
                                          (129, 128, (128, 256))])
def test_chunking(n, chunk, want):
    assert Y.chunk_size(n, chunk) == want


def test_request_flops_at_full_size():
    cell = harness.load_cell("alter256.bulk_b20_t50")
    f = Y.request_flops(cell.config, cell.traffic)
    mlp = 512 * 2048 + 2 * 2048 * 2048 + 2048 * 512
    assert f["flow"] == 2 * 20 * 15 * 4 * mlp
    assert math.isclose(sum(f.values()) / 1e12, 33.498, rel_tol=1e-4)
