"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; without a CUDA device every test skips.  The card's machine
has no JAX, which ``tests/conftest.py`` imports, so run them there with

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest -q

Tolerances.  Rollout: the kernel and the bf16-operand plain version round
the same operands to bf16 and accumulate in f32; they differ only in
summation order and in the rare bf16 rounding flip of h that this causes,
so atol 1e-2, rtol 1e-2; two launches of the kernel on the same operands
are equal (it sums in a fixed order).  ELU+dropout: the plain version
computes the kernel's Philox stream, so the keep decisions agree exactly;
values within one bf16 ulp (bf16) or 1e-6 (f32), for the kernel's
expm1 (a polynomial near 0, __expf(x) - 1 below -0.5) and expf may differ
from torch's in the last f32 bits; non-finite values as the plain
version's.  Fused RNB: the kernel and its
plain version round elu(x) and W to bf16 and accumulate in f32; they
differ in summation order and, rarely, in a bf16 rounding of elu(x) or of
the output, so atol 1e-2, rtol 1e-2.  int8 conv: the kernel and its
plain version quantize alike and sum integers exactly, so the int32
accumulators are equal and the outputs within one bf16 ulp (bf16; the
epilogue's arithmetic is the same, aux and the affine included, but the
cast of a sum on a bf16 midpoint may break either way) or equal (f32).
The int8 library route (F.unfold + torch._int_mm, the shapes the kernel
does not take) and the plain version: equal sums, equal outputs.  Conv
epilogue: the kernel and the float32 reference (its plain version) sum
(y + b) + r in f32 and round once, so they are equal; the folded
NormConv2d route against the unfolded one rounds W' = gamma * W instead of
W, and the conv's output before the affine, so whole networks agree to
bf16 noise (rel L2 below 2e-2, as the fused RNB route).  Stickman
raster: the kernel rounds each operation where the eager version does, so
both of its outputs (f32 on 0..255, normalized bf16) are bit-equal to
``render_stickman_plain`` run on the card; against the JAX package's
raster (``tests/golden/torch_port_stickman_small.npz``) at most 0.1 % of
the pixels may differ, a pixel centre within an ulp of a line's edge, as
``tests/test_torch_geometry.py`` holds the eager version.
"""
import json
import os

import numpy as np
import pytest
import torch

from behavior_driven_video_synthesis_tpu_torch.data.deepfashion import (
    deepfashion_joint_model)
from behavior_driven_video_synthesis_tpu_torch.data.human36m import (
    detailed_joint_model)
from behavior_driven_video_synthesis_tpu_torch.data.market import (
    market_joint_model)
from behavior_driven_video_synthesis_tpu_torch.generate import (
    chain_joint_model)
from behavior_driven_video_synthesis_tpu_torch.geometry.stickman import (
    render_stickman, render_stickman_plain)
from behavior_driven_video_synthesis_tpu_torch.models import (
    ResidualBehaviorNet, decoder_rollout_kernel)
from behavior_driven_video_synthesis_tpu_torch.models.init import init_random_
from behavior_driven_video_synthesis_tpu_torch.models.vunet import VUNet
from behavior_driven_video_synthesis_tpu_torch.ops import nn as pnn
from behavior_driven_video_synthesis_tpu_torch.ops.cuda import (
    conv_epilogue as CE)
from behavior_driven_video_synthesis_tpu_torch.ops.cuda import (
    conv_int8 as CI)
from behavior_driven_video_synthesis_tpu_torch.ops.cuda import (
    elu_dropout as E)
from behavior_driven_video_synthesis_tpu_torch.ops.cuda import (
    fused_rnb as FR)
from behavior_driven_video_synthesis_tpu_torch.ops.cuda import rollout as R
from behavior_driven_video_synthesis_tpu_torch.ops.cuda import (
    stickman as SK)
from behavior_driven_video_synthesis_tpu_torch.pipeline import (
    BehaviorTransferPipeline)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _args(B, K, H, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)

    def u(*shape, scale=1.0):
        return (torch.rand(*shape, generator=g, device=device) * 2 - 1) * scale
    s = H ** -0.5
    return (u(B, H), u(B, K, scale=0.5), u(4 * H, K, scale=s),
            u(4 * H, H, scale=s), u(4 * H, scale=s), u(4 * H, scale=s),
            u(K, H, scale=s), u(K, scale=s))


@pytest.mark.parametrize("B,K,H,T", [
    (20, 48, 1024, 50), (1, 48, 1024, 50), (3, 51, 1024, 7), (1, 5, 32, 1),
    (37, 48, 256, 9), (64, 17, 64, 3), (33, 1, 8, 2), (5, 48, 2048, 4),
    (256, 48, 1024, 50)])
def test_rollout_kernel_matches_plain(cuda, B, K, H, T):
    args = _args(B, K, H, cuda)
    before = R.rollout_launches
    with torch.no_grad():
        out = R.residual_lstm_rollout(*args, T)
        torch.cuda.synchronize()
        ref = R.residual_lstm_rollout_plain(*args, T,
                                            operand_dtype=torch.bfloat16)
    assert R.rollout_launches == before + 1
    assert out.shape == (B, T, K) and out.dtype == torch.float32
    torch.testing.assert_close(out, ref, atol=1e-2, rtol=1e-2)


def test_rollout_kernel_refuses_grad_and_bad_shapes(cuda):
    args = list(_args(2, 6, 16, cuda))
    args[2].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        R.residual_lstm_rollout(*args, 3)
    with torch.no_grad():
        with pytest.raises(ValueError, match="H % 8"):
            R.residual_lstm_rollout(*_args(2, 6, 12, cuda), 3)
        with pytest.raises(ValueError, match="on cpu"):
            R.residual_lstm_rollout(*args[:7], args[7].cpu(), 3)


def test_rollout_kernel_config(cuda):
    """U a multiple of 4 (whole m16 tiles of gate rows): 128 blocks of 8
    units at H=1024 with the weights resident; at H=2048 the weight rows
    do not fit and the products read them from global memory."""
    cfg = R.rollout_config(20, 48, 1024)
    assert cfg["units_per_block"] % 4 == 0 and cfg["weights_in_smem"]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert cfg["blocks"] * cfg["units_per_block"] >= 1024
    assert cfg["blocks"] <= sms and cfg["smem_bytes"] <= 232448
    assert not R.rollout_config(5, 48, 2048)["weights_in_smem"]


def test_decoder_rollout_reuses_its_operands(cuda):
    """A second call with unchanged parameters casts no weight; an
    in-place update rebuilds the operands, and the kernel follows it."""
    net = init_random_(ResidualBehaviorNet(48, 64),
                       np.random.RandomState(0)).to(cuda)
    d = net.decoder
    g = torch.Generator(device=cuda).manual_seed(0)
    b = torch.randn(5, 64, generator=g, device=cuda)
    x0 = torch.randn(5, 48, generator=g, device=cuda) * 0.5
    builds = pnn.prepared_builds["rollout"]
    launches = R.rollout_launches
    with torch.no_grad():
        first = decoder_rollout_kernel(d, b, x0, 6)
        again = decoder_rollout_kernel(d, b, x0, 6)
        assert pnn.prepared_builds["rollout"] == builds + 1
        d.rnn.weight_hh.mul_(0.5)
        moved = decoder_rollout_kernel(d, b, x0, 6)
        assert pnn.prepared_builds["rollout"] == builds + 2
        ref = R.residual_lstm_rollout_prepared_plain(
            b, x0, d.rollout_operands(), 6)
    torch.cuda.synchronize()
    assert R.rollout_launches == launches + 3
    torch.testing.assert_close(again, first, atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(moved, ref, atol=1e-2, rtol=1e-2)
    with pytest.raises(RuntimeError, match="no backward"):
        decoder_rollout_kernel(d, b, x0, 6)


def test_served_decoder_follows_training_steps(cuda):
    """A decoder served through the kernel, then trained by two cVAE steps
    on the card, then served again: the second request runs on operands
    rebuilt from the updated weights, not on the first request's."""
    from behavior_driven_video_synthesis_tpu_torch.models.discriminators \
        import SequenceDiscMichael
    from behavior_driven_video_synthesis_tpu_torch.models.probes import (
        ClassifierAction, ClassifierActionBeta, RegressorFly)
    from behavior_driven_video_synthesis_tpu_torch.train.behavior import (
        BehaviorTrainState, make_behavior_train_step)
    from behavior_driven_video_synthesis_tpu_torch.train.state import (
        make_behavior_optimizers)

    K, H, T, B, n_actions = 48, 64, 8, 4, 3
    rng = np.random.RandomState(0)
    modules = {
        "net": ResidualBehaviorNet(K, H), "regressor": RegressorFly(H, K, T),
        "cls_action": ClassifierAction(K, n_actions, dim=32),
        "cls_action2": SequenceDiscMichael(K, T - 1, out_dim=n_actions),
        "cls_beta": ClassifierActionBeta(H, n_actions)}
    for m in modules.values():
        init_random_(m, rng).to(cuda)
    training = {"lr_init": 1e-2, "information_max": 1.0, "gamma_step": 0.01}
    state = BehaviorTrainState(
        modules, make_behavior_optimizers(modules, training, 2),
        gamma=torch.zeros((), device=cuda))
    step = make_behavior_train_step({"training": training}, T)
    batch = {"keypoints": torch.from_numpy(
        rng.randn(B, T + 1, K).astype(np.float32)).to(cuda),
        "action": torch.arange(B, device=cuda) % n_actions}
    d = modules["net"].decoder
    g = torch.Generator(device=cuda).manual_seed(0)
    b = torch.randn(5, H, generator=g, device=cuda)
    x0 = torch.randn(5, K, generator=g, device=cuda) * 0.5

    def serve():
        builds = pnn.prepared_builds["rollout"]
        launches = R.rollout_launches
        with torch.inference_mode():
            xs = decoder_rollout_kernel(d, b, x0, T)
            r = d.rnn
            ref = R.residual_lstm_rollout_plain(
                b, x0, r.weight_ih, r.weight_hh, r.bias_ih, r.bias_hh,
                d.n_out.weight, d.n_out.bias, T,
                operand_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert R.rollout_launches == launches + 1
        assert pnn.prepared_builds["rollout"] == builds + 1
        torch.testing.assert_close(xs, ref, atol=1e-2, rtol=1e-2)
        return xs

    first = serve()
    for _ in range(2):
        m = step(state, batch, generator=g)
        assert bool(torch.isfinite(m["loss"]))
    assert state.step == 2
    second = serve()
    assert float((second - first).abs().max()) > 5e-2


def test_pipeline_on_cuda_launches_the_kernel_once(cuda):
    rng = np.random.RandomState(0)
    net = init_random_(ResidualBehaviorNet(48, 32), rng).to(cuda)
    vunet = init_random_(VUNet(spatial_size=32, nf_start=8, nf_max=16),
                         rng).to(cuda)
    pipe = BehaviorTransferPipeline(
        net, vunet, detailed_joint_model(True), np.zeros(51, np.float32),
        np.ones(51, np.float32), np.arange(51)[np.arange(51) % 17 != 0][:48],
        spatial_size=32)
    B, T = 3, 5
    extr = np.tile(np.hstack([np.eye(3), [[0], [0], [4.0]]]), (B, 1, 1))
    before = R.rollout_launches
    out = pipe.generate(rng.randn(B, 32), rng.randn(B, 48) * 0.1,
                        rng.rand(B, 32, 32, 3), extr,
                        np.tile([40.0, 16, 40.0, 16], (B, 1)),
                        np.full((B, 2), 32.0), length=T)
    torch.cuda.synchronize()
    assert R.rollout_launches == before + 1
    assert out["frames"].shape == (B, T, 32, 32, 3)
    assert bool(torch.isfinite(out["frames"]).all())


def _within_one_ulp(out, ref):
    if out.dtype == torch.bfloat16:
        ulp = torch.finfo(torch.bfloat16).eps * ref.float().abs().clamp(
            min=torch.finfo(torch.bfloat16).tiny)
        return bool(((out.float() - ref.float()).abs() <= ulp).all())
    return bool(((out - ref).abs() <= 1e-6).all())


@pytest.mark.parametrize("shape,dtype", [
    ((12, 256, 256, 32), torch.bfloat16), ((1000003,), torch.float32),
    ((2, 33, 17, 5), torch.bfloat16), ((3,), torch.float32),
    ((9,), torch.bfloat16), ((4, 64, 64, 128), torch.float32)])
@pytest.mark.parametrize("rate", [0.05, 0.5])
def test_elu_dropout_kernels_match_plain(cuda, shape, dtype, rate):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    ct = torch.randn(shape, generator=g, device=cuda).to(dtype)
    seed = E.draw_seed(cuda, g)
    before = (E.elu_dropout_fwd_launches, E.elu_dropout_bwd_launches)
    y = E.elu_dropout_forward(x, seed, rate)
    dx = E.elu_dropout_backward(x, ct, seed, rate)
    torch.cuda.synchronize()
    assert (E.elu_dropout_fwd_launches, E.elu_dropout_bwd_launches) == (
        before[0] + 1, before[1] + 1)
    y_ref = E.elu_dropout_plain(x, seed, rate)
    dx_ref = E.elu_dropout_backward_plain(x, ct, seed, rate)
    keep = E.dropout_bits(seed, x.numel()).reshape(shape) < \
        E.keep_params(rate)[0]
    assert y.dtype == dtype and dx.dtype == dtype
    assert torch.equal(y == 0, (y_ref == 0)) and torch.equal(
        y != 0, keep & (y_ref != 0))
    assert _within_one_ulp(y, y_ref) and _within_one_ulp(dx, dx_ref)


def _sweep_ok(out, ref):
    """_within_one_ulp where ref is finite; NaN exactly where ref is NaN,
    the same infinities where ref is infinite."""
    fin, inf = torch.isfinite(ref), torch.isinf(ref)
    return (torch.equal(torch.isnan(out), torch.isnan(ref))
            and torch.equal(out[inf], ref[inf])
            and _within_one_ulp(out[fin], ref[fin]))


def _sweep(x, ct, seed, rate, offset):
    """Forward and backward against the plain versions: the zero patterns
    equal, non-zero exactly where kept, values by _sweep_ok."""
    y = E.elu_dropout_forward(x, seed, rate, offset)
    dx = E.elu_dropout_backward(x, ct, seed, rate, offset)
    torch.cuda.synchronize()
    keep = E.dropout_bits(seed, x.numel(), offset) < E.keep_params(rate)[0]
    for out, ref in ((y, E.elu_dropout_plain(x, seed, rate, offset)),
                     (dx, E.elu_dropout_backward_plain(x, ct, seed, rate,
                                                       offset))):
        assert torch.equal(out == 0, ref == 0)
        assert torch.equal(out != 0, keep & (ref != 0))
        assert _sweep_ok(out, ref)


@pytest.mark.parametrize("rate", [1e-12, 0.05, 0.5])
@pytest.mark.parametrize("offset", [0, 3])
def test_elu_dropout_kernels_every_bf16_pattern(cuda, rate, offset):
    """All 65,536 bf16 bit patterns, the non-finite ones included (rate
    1e-12 keeps all but one element in 2**32)."""
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.arange(65536, dtype=torch.int32, device=cuda).to(
        torch.int16).view(torch.bfloat16)
    ct = torch.randn(x.shape, generator=g, device=cuda).to(torch.bfloat16)
    _sweep(x, ct, E.draw_seed(cuda, g), rate, offset)


@pytest.mark.parametrize("rate", [1e-12, 0.5])
def test_elu_dropout_kernels_f32_sweep_and_edges(cuda, rate):
    """Every 4,099th f32 bit pattern and the edges of the ELU's negative
    side: -0, denormals, the -0.5 switch, exp's underflow near -88,
    infinities and NaN."""
    g = torch.Generator(device=cuda).manual_seed(12)
    bits = torch.arange(0, 2 ** 32, 4099, dtype=torch.int64, device=cuda)
    x = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(
        torch.int32).view(torch.float32)
    below, above = (float(np.nextafter(np.float32(-0.5), np.float32(v)))
                    for v in (-1, 0))
    edges = torch.tensor([0.0, -0.0, 1e-45, -1e-45, -1e-39, -1e-30, -1e-7,
                          above, -0.5, below, -1.0, -87.3, -88.0, -88.73,
                          -103.0, -104.0, -3.4028235e38, 3.4028235e38,
                          float("inf"), float("-inf"), float("nan")],
                         device=cuda)
    x = torch.cat([x, edges])
    ct = torch.randn(x.shape, generator=g, device=cuda)
    _sweep(x, ct, E.draw_seed(cuda, g), rate, 0)


@pytest.mark.parametrize("shape,dtype", [
    ((12, 64, 64, 32), torch.bfloat16), ((1000003,), torch.float32),
    ((3, 37, 5), torch.bfloat16)])
def test_elu_dropout_kernels_keep_the_plain_bits_at_every_offset(
        cuda, shape, dtype):
    """At offsets 0-7, n and n + 1 an output is non-zero exactly where the
    plain version's bits keep its element (x and ct hold no zero)."""
    g = torch.Generator(device=cuda).manual_seed(13)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    ct = torch.randn(shape, generator=g, device=cuda).to(dtype)
    x[x == 0], ct[ct == 0] = 1.0, 1.0
    seed = E.draw_seed(cuda, g)
    n = x.numel()
    for off in list(range(8)) + [n, n + 1]:
        y = E.elu_dropout_forward(x, seed, 0.3, off)
        dx = E.elu_dropout_backward(x, ct, seed, 0.3, off)
        torch.cuda.synchronize()
        keep = (E.dropout_bits(seed, n, off) < E.keep_params(0.3)[0]
                ).reshape(shape)
        assert torch.equal(y != 0, keep) and torch.equal(dx != 0, keep), off
        assert _within_one_ulp(y, E.elu_dropout_plain(x, seed, 0.3, off))
        assert _within_one_ulp(dx, E.elu_dropout_backward_plain(
            x, ct, seed, 0.3, off))


@pytest.mark.parametrize("B", [20, 256])
def test_rollout_kernel_twice_is_bit_equal(cuda, B):
    """The kernel sums the blocks' partials in a fixed order: two launches
    on the same operands give the same bits (they varied with the
    atomics that summed them before)."""
    args = _args(B, 48, 1024, cuda, seed=B)
    ops = R.pack_operands(*args[2:])
    with torch.no_grad():
        a = R.residual_lstm_rollout_prepared(args[0], args[1], ops, 50)
        b = R.residual_lstm_rollout_prepared(args[0], args[1], ops, 50)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("shape,dtype", [
    ((12, 64, 64, 32), torch.bfloat16), ((6, 33, 17, 5), torch.bfloat16),
    ((4, 7, 3), torch.float32), ((2, 1000003), torch.float32)])
@pytest.mark.parametrize("world", [2, 3])
def test_elu_dropout_kernels_with_an_offset_are_the_global_slice(
        cuda, shape, dtype, world):
    """Each rank's rows launched at offset rank * n_local (any offset,
    also inside a Philox block of 4) equal the same rows of one launch
    over the global batch and of the plain version, forward and
    backward."""
    rows = shape[0] // world
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((rows * world,) + shape[1:], generator=g,
                    device=cuda).to(dtype)
    ct = torch.randn(x.shape, generator=g, device=cuda).to(dtype)
    seed = E.draw_seed(cuda, g)
    full = E.elu_dropout_forward(x, seed, 0.3)
    dfull = E.elu_dropout_backward(x, ct, seed, 0.3)
    n_local = x[:rows].numel()
    for r in range(world):
        sl = slice(r * rows, (r + 1) * rows)
        off = r * n_local
        part = E.elu_dropout_forward(x[sl], seed, 0.3, off)
        dpart = E.elu_dropout_backward(x[sl], ct[sl], seed, 0.3, off)
        torch.cuda.synchronize()
        assert torch.equal(part, full[sl]) and torch.equal(dpart, dfull[sl])
        ref = E.elu_dropout_plain(x[sl], seed, 0.3, off)
        dref = E.elu_dropout_backward_plain(x[sl], ct[sl], seed, 0.3, off)
        assert torch.equal(part == 0, ref == 0)
        assert _within_one_ulp(part, ref) and _within_one_ulp(dpart, dref)
    with pytest.raises(ValueError, match="offset"):
        E.elu_dropout_forward(x, seed, 0.3, -4)


@pytest.mark.parametrize("k,pad,stride", [(5, 2, 1), (7, 3, 1), (3, 0, 1),
                                          (3, 1, 3)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv_int8_unfold_route_matches_plain(cuda, k, pad, stride, dtype):
    """A quantized NormConv2d of a shape the kernel does not take runs
    through F.unfold + torch._int_mm on the card: the plain version's
    int32 sums and outputs, with aux and the affine, and no kernel
    launch."""
    g = torch.Generator(device=cuda).manual_seed(k + pad)
    cin, ca, n = 64, 64, 64
    x = (torch.randn(3, 64, 64, cin, generator=g, device=cuda) * 2).to(
        dtype)
    aux = torch.randn(3, 64, 64, ca, generator=g, device=cuda).to(dtype)
    w_q, aw = CI.quantize_weight(torch.randn(n, cin, k, k, generator=g,
                                             device=cuda))
    aux_w_q, aux_aw = CI.quantize_weight(torch.randn(
        n, ca, k, k, generator=g, device=cuda))
    kw = dict(padding=pad, aux=aux, aux_w_q=aux_w_q, aux_aw=aux_aw,
              ax_aux=CI.act_scale(aux),
              gamma=torch.randn(n, generator=g, device=cuda),
              beta=torch.randn(n, generator=g, device=cuda))
    args = (x, w_q, aw, CI.act_scale(x),
            torch.randn(n, generator=g, device=cuda), stride)
    before = (CI.conv_int8_launches, CI.conv_int8_unfold_calls)
    out = CI.conv_int8(*args[:6], **kw)
    sums = CI.conv_int8_unfold(*args, accumulators=True, **kw)
    torch.cuda.synchronize()
    assert (CI.conv_int8_launches, CI.conv_int8_unfold_calls) == (
        before[0], before[1] + 2)
    ref_sums = CI.conv_int8_plain(*args, accumulators=True, **kw)
    for u, v in zip(sums, ref_sums):
        assert torch.equal(u, v)
    assert torch.equal(out, CI.conv_int8_plain(*args, **kw))


def test_elu_dropout_kernel_refuses_what_it_does_not_take(cuda):
    seed = E.draw_seed(cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        E.elu_dropout_forward(torch.zeros(8, device=cuda,
                                          dtype=torch.float16), seed, 0.5)
    with pytest.raises(ValueError, match="int32"):
        E.elu_dropout_forward(torch.zeros(8, device=cuda), seed.cpu(), 0.5)


def test_rnb_trains_through_the_kernels(cuda):
    """A residual block with dropout_impl "pallas" launches the forward
    kernel at both branches and the backward kernel for each."""
    rng = np.random.RandomState(0)
    block = init_random_(pnn.VunetRNB(16, residual=True, aux_channels=8,
                                      dropout_prob=0.1,
                                      dropout_impl="pallas"), rng).to(cuda)
    x = torch.randn(2, 16, 16, 16, device=cuda, requires_grad=True)
    a = torch.randn(2, 16, 16, 8, device=cuda)
    before = (E.elu_dropout_fwd_launches, E.elu_dropout_bwd_launches)
    out = block(x, a, train=True,
                generator=torch.Generator(device=cuda).manual_seed(1))
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert (E.elu_dropout_fwd_launches - before[0],
            E.elu_dropout_bwd_launches - before[1]) == (2, 2)
    assert bool(torch.isfinite(x.grad).all())


def _rnb_block(C, device, **kw):
    """A bf16 block under rnb_impl "fused" from a numpy seed."""
    return init_random_(pnn.VunetRNB(C, dtype=torch.bfloat16,
                                     rnb_impl="fused", **kw),
                        np.random.RandomState(C)).to(device).eval()


def _fused_matches_plain(x, block):
    before = FR.fused_rnb_launches
    with torch.no_grad():
        out = block(x)
        torch.cuda.synchronize()
        ref = FR.fused_rnb_plain(x.contiguous(), *block.fused_weights())
    assert FR.fused_rnb_launches == before + 1
    assert out.shape == x.shape and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)


def _bf16_input(shape, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=device) * 0.5).bfloat16()


@pytest.mark.parametrize("shape", [
    (8, 256, 256, 32), (8, 128, 128, 64), (8, 64, 64, 128), (3, 37, 53, 64),
    (5, 4, 4, 128), (2, 5, 7, 8), (1, 9, 17, 24), (2, 16, 16, 40),
    (1, 1, 1, 16), (2, 8, 33, 120),
    # H and W off the 16x16 tile, a 1x1 image, W below the tile's width
    (2, 1, 1, 32), (3, 17, 5, 64), (1, 33, 15, 128), (2, 20, 3, 16),
    (1, 15, 47, 96), (4, 2, 40, 80), (1, 31, 16, 112), (2, 16, 17, 48)]
    # every instantiation of the dispatch (C rounded up to 16), with the
    # weights resident (C <= 64) and streamed through the ring
    + [(2, 19, 23, C) for C in range(8, 129, 8)])
def test_fused_rnb_kernel_matches_plain(cuda, shape):
    _fused_matches_plain(_bf16_input(shape, cuda), _rnb_block(shape[-1],
                                                              cuda))


def test_fused_rnb_kernel_refuses_what_it_does_not_take(cuda):
    block = _rnb_block(16, cuda)
    x = torch.zeros(2, 8, 8, 16, device=cuda, dtype=torch.bfloat16)
    with torch.no_grad():
        with pytest.raises(TypeError, match="bfloat16"):
            FR.fused_rnb_prepared(x.float(), block.fused_operands())
        with pytest.raises(ValueError, match="3x3"):
            block._forward_fused(x[..., :8])
        with pytest.raises(ValueError, match="C % 8"):
            _rnb_block(12, cuda)(torch.zeros(1, 4, 4, 12, device=cuda,
                                             dtype=torch.bfloat16))
        with pytest.raises(ValueError, match="C <= 128"):
            _rnb_block(136, cuda)(torch.zeros(1, 4, 4, 136, device=cuda,
                                              dtype=torch.bfloat16))
        # the kernel's 3x3 C -> C conv is fixed when the block is built
        assert not _rnb_block(16, cuda, residual=True).fused
        assert not _rnb_block(16, cuda, kernel_size=1).fused
        with pytest.raises(ValueError, match="on cpu"):
            FR.fused_rnb_prepared(x, _rnb_block(16, "cpu").fused_operands())
        # a strided view is copied, not refused
        wide = torch.randn(2, 8, 8, 32, device=cuda).bfloat16()
        torch.testing.assert_close(
            block(wide[..., ::2]).float(),
            FR.fused_rnb_plain(wide[..., ::2].contiguous(),
                               *block.fused_weights()).float(),
            atol=1e-2, rtol=1e-2)
    with pytest.raises(RuntimeError, match="no backward"):
        block.requires_grad_(True)(x)


def test_org_vunet_fused_route_on_the_card(cuda):
    """A bf16 org VUNet under rnb_impl "fused": one launch per RNB
    without auxiliary input, frames close to the cuDNN route's."""
    rng = np.random.RandomState(0)
    arch = dict(spatial_size=32, n_channels_x=30, nf_start=8, nf_max=16,
                box_factor=1, variant="org", dtype=torch.bfloat16)
    ref = init_random_(VUNet(**arch), rng).to(cuda).eval()
    fused = VUNet(**arch, rnb_impl="fused").to(cuda).eval()
    fused.load_state_dict(ref.state_dict())
    x = torch.from_numpy(rng.rand(3, 16, 16, 30)).float().to(cuda)
    c = torch.from_numpy(rng.rand(3, 32, 32, 3)).float().to(cuda)
    eps = [torch.from_numpy(rng.randn(3, s, s, 16)).float().to(cuda)
           for s in (4, 8)]
    prior = [[torch.from_numpy(rng.randn(3, s, s, 16)).float().to(cuda)
              for _ in range(4)] for s in (2, 4)]
    outs = {}
    with torch.inference_mode():
        for name, net in (("cudnn", ref), ("fused", fused)):
            n0 = FR.fused_rnb_launches
            means, _ = net.encode_means(x, eps)
            n1 = FR.fused_rnb_launches
            frames = net.transfer_cached(means, c)
            n2 = FR.fused_rnb_launches
            sample = net.test_forward(c, prior)
            torch.cuda.synchronize()
            counts = (n1 - n0, n2 - n1, FR.fused_rnb_launches - n2)
            assert counts == ((6, 8, 10) if name == "fused" else (0, 0, 0))
            outs[name] = (frames.float(), sample.float())
    for a, b in zip(outs["fused"], outs["cudnn"]):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).norm() / b.norm()) < 2e-2


@pytest.mark.parametrize("C", [32, 128])
def test_fused_rnb_kernel_over_partial_waves(cuda, C):
    """B=1, and B whose tiles leave the persistent grid's last pass with
    one tile (B = the grid's cap + 1, one tile an image)."""
    plan = FR.kernel_plan(C, cuda)
    assert plan["grid_cap"] >= plan["blocks_per_sm"] >= 1
    block = _rnb_block(C, cuda)
    for shape in ((1, 16, 16, C), (1, 80, 48, C),
                  (plan["grid_cap"] + 1, 16, 16, C),
                  (plan["grid_cap"] // 3 + 1, 16, 48, C)):
        _fused_matches_plain(_bf16_input(shape, cuda), block)


def test_fused_rnb_kernel_on_strided_inputs(cuda):
    """Views that are not contiguous (a channel slice, a spatial stride,
    a permuted NCHW tensor) are copied, not refused."""
    block = _rnb_block(32, cuda)
    wide = _bf16_input((2, 24, 30, 64), cuda)
    nchw = _bf16_input((2, 32, 20, 21), cuda, 1)
    for x in (wide[..., 16:48], wide[:, ::2, 1::3, :32],
              nchw.permute(0, 2, 3, 1)):
        assert not x.is_contiguous()
        _fused_matches_plain(x, block)


def test_fused_rnb_kernel_plan_fits_the_card(cuda):
    """Resident weights up to C=64, a ring of two taps above; every plan's
    shared memory fits a block, and the C=32 plan keeps two blocks an SM."""
    for C in range(16, 129, 16):
        plan = FR.kernel_plan(C, cuda)
        assert plan["smem_bytes"] <= 232448
        assert plan["tap_slots"] == (9 if C <= 64 else 2)
        assert plan["halo_buffers"] == (2 if C <= 64 else 1)
        # the warps split the tile's 16 rows and its C output channels
        assert plan["threads"] in (256, 512)
        assert plan["wgmma"] == (C in FR.WGMMA_CHANNELS)
        assert (plan["warp_rows"] * plan["warp_channels"]
                * plan["threads"] // 32) == 16 * C
    assert FR.kernel_plan(32, cuda)["blocks_per_sm"] >= 2


def _org_dropout_sites(vunet):
    """(forward, backward) ELU+dropout launches of one org training step:
    a site per RNB input (two for a residual block); EncDown's last two
    residual blocks reach no loss, so their backward never runs."""
    fwd = sum(1 + int(m.residual) for m in vunet.modules()
              if isinstance(m, pnn.VunetRNB))
    return fwd, fwd - 2 * 2


@pytest.mark.parametrize("remat", [False, "subnet"])
def test_org_step_through_the_elu_dropout_kernels(cuda, remat):
    """The org training step with dropout_impl pallas: every dropout site
    launches the forward kernel and every site that reaches the loss the
    backward kernel; the loss and the updates equal the same step through
    the kernels' plain Philox versions (bit-exact keep decisions)."""
    import torch_port_org_train as T

    tree, batch, noise = T.make_inputs(0)
    cfg = T.config(dropout_prob=0.05, dropout_impl="pallas", remat=remat)
    runs = {}
    for route in ("kernel", "plain"):
        launch = E._launch_fwd, E._launch_bwd
        if route == "plain":
            E._launch_fwd = E.elu_dropout_plain
            E._launch_bwd = E.elu_dropout_backward_plain
        E.elu_dropout_fwd_launches = E.elu_dropout_bwd_launches = 0
        try:
            gens = tuple(torch.Generator(device=cuda).manual_seed(s)
                         for s in (1, 2))
            runs[route] = T.port_steps(tree, batch, noise, n_steps=1,
                                       device=cuda, cfg=cfg,
                                       generators=gens)
        finally:
            E._launch_fwd, E._launch_bwd = launch
        if route == "kernel" and not remat:   # remat launches again
            sites = _org_dropout_sites(T.port_vunet(cfg))
            assert (E.elu_dropout_fwd_launches,
                    E.elu_dropout_bwd_launches) == sites
    (m_k, after_k), (m_p, after_p) = runs["kernel"], runs["plain"]
    assert abs(m_k[0]["loss"] - m_p[0]["loss"]) <= 1e-5 * abs(m_p[0]["loss"])
    errs = T.update_errors(tree, after_k, after_p)
    assert max(errs.values()) <= 1e-3, max(errs.values())


def test_mtvae_steps_on_the_card_hold_the_golden(cuda):
    """The small MT-VAE step (no hand-written kernel) on the card against
    the JAX package's golden, as chip_smoke.py phase [17] holds it: the
    metrics at rtol 1e-4, every leaf's update within 5 %."""
    import torch_port_mtvae as TM

    from behavior_driven_video_synthesis_tpu_torch.flax_npz import (
        unflatten_tree)

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "golden", "torch_port_mtvae_small.npz")
    with np.load(path) as data:
        golden = unflatten_tree({k: data[k] for k in data.files})
    tree, batch, noise = TM.golden_inputs(golden)
    metrics, after = TM.port_steps(tree, batch, noise, device=cuda)
    worst_m, worst_u = TM.check_against_golden(metrics, tree, after, golden)
    assert worst_m <= 1.0 and worst_u <= 1.0, (worst_m, worst_u)


def _int8_case(shape, cout, dtype, device, seed=0, scale=2.0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(*shape, generator=g, device=device) * scale).to(dtype)
    w = torch.randn(cout, shape[-1], 3, 3, generator=g, device=device)
    bias = torch.randn(cout, generator=g, device=device)
    w_q, aw = CI.quantize_weight(w)
    return x, w_q, aw, CI.act_scale(x), bias


def _bf16_ulp_ok(out, ref):
    """|out - ref| <= one bf16 ulp at ref, 2^(floor(log2|ref|) - 7)."""
    ref = ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
    return bool(((out.float() - ref).abs() <= ulp).all())


@pytest.mark.parametrize("shape,cout,stride", [
    ((2, 16, 16, 32), 32, 1), ((3, 9, 13, 64), 64, 1),
    ((2, 8, 8, 128), 256, 1), ((2, 17, 11, 64), 128, 2),
    ((1, 6, 6, 12), 20, 1), ((2, 5, 7, 8), 8, 2), ((1, 4, 4, 512), 128, 1)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv_int8_kernel_matches_plain(cuda, shape, cout, stride, dtype):
    x, w_q, aw, ax, bias = _int8_case(shape, cout, dtype, cuda)
    packed = CI.pack_weights(w_q, aw)
    before = CI.conv_int8_launches
    acc = CI.conv_int8_packed(x, packed, ax, stride=stride,
                              accumulators=True)
    out = CI.conv_int8(x, w_q, aw, ax, bias, stride, packed=packed)
    torch.cuda.synchronize()
    assert CI.conv_int8_launches == before + 2
    ref_acc = CI.conv_int8_plain(x, w_q, aw, ax, stride=stride,
                                 accumulators=True)
    ref = CI.conv_int8_plain(x, w_q, aw, ax, bias, stride)
    assert acc.dtype == torch.int32 and torch.equal(acc, ref_acc)
    assert out.dtype == dtype and out.shape == ref.shape
    if dtype == torch.float32:
        assert torch.equal(out, ref)
    else:
        assert _bf16_ulp_ok(out, ref)


def test_conv_int8_kernel_mixed_dtypes_and_no_bias(cuda):
    """f32 in, bf16 out and the reverse, without a bias."""
    for din, dout in ((torch.float32, torch.bfloat16),
                      (torch.bfloat16, torch.float32)):
        x, w_q, aw, ax, _ = _int8_case((2, 12, 12, 32), 64, din, cuda, 1)
        out = CI.conv_int8(x, w_q, aw, ax, None, 1, dout,
                           packed=CI.pack_weights(w_q, aw))
        ref = CI.conv_int8_plain(x, w_q, aw, ax, None, 1, dout)
        assert out.dtype == dout
        if dout == torch.float32:
            assert torch.equal(out, ref)
        else:
            assert _bf16_ulp_ok(out, ref)


def _fused_case(shape, cout, aux_cin, dtype, device, seed=0):
    """A NormConv2d int8 call's operands: x, its weights, scale and bias,
    gamma and beta in the output dtype, and aux with its own weights and
    scale where aux_cin > 0; (kernel kwargs, plain kwargs)."""
    x, w_q, aw, ax, bias = _int8_case(shape, cout, dtype, device, seed)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    gamma = torch.randn(cout, generator=g, device=device).to(dtype)
    beta = torch.randn(cout, generator=g, device=device).to(dtype)
    kernel = dict(packed=CI.pack_weights(w_q, aw), gamma=gamma, beta=beta)
    plain = dict(w_q=w_q, aw=aw, gamma=gamma, beta=beta)
    if aux_cin:
        a, a_q, a_aw, a_ax, _ = _int8_case(shape[:3] + (aux_cin,), cout,
                                           dtype, device, seed + 2, 3.0)
        kernel.update(aux=a, aux_packed=CI.pack_weights(a_q, a_aw),
                      ax_aux=a_ax)
        plain.update(aux=a, aux_w_q=a_q, aux_aw=a_aw, ax_aux=a_ax)
    return x, ax, bias, kernel, plain


@pytest.mark.parametrize("shape,cout,stride,aux_cin", [
    ((2, 16, 16, 32), 32, 1, 32), ((3, 9, 13, 64), 64, 1, 64),
    ((2, 8, 8, 128), 256, 1, 128), ((2, 17, 11, 64), 128, 2, 64),
    ((1, 6, 6, 12), 20, 1, 12), ((2, 5, 7, 8), 8, 2, 8),
    ((1, 4, 4, 512), 128, 1, 0), ((2, 12, 12, 48), 512, 1, 0),
    ((3, 10, 10, 48), 20, 1, 12), ((20, 4, 4, 128), 128, 1, 128),
    ((20, 80, 80, 64), 64, 1, 0), ((20, 80, 80, 64), 64, 1, 64),
    ((3, 33, 35, 64), 128, 2, 0)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv_int8_fused_call_matches_plain(cuda, shape, cout, stride,
                                            aux_cin, dtype):
    """The whole NormConv2d int8 call (aux, bias, gamma and beta) in one
    launch against the plain composition: int32 sums equal, bf16 within
    one ulp, f32 equal.  (20, 80, 80) has more tiles than the card holds
    persistent blocks; (20, 4, 4) packs whole frames into a tile."""
    x, ax, bias, kernel, plain = _fused_case(shape, cout, aux_cin, dtype,
                                             cuda)
    acc_kw = {k: v for k, v in kernel.items() if k not in ("gamma", "beta")}
    acc_kw.pop("packed")
    before = CI.conv_int8_launches
    out = CI.conv_int8(x, plain["w_q"], plain["aw"], ax, bias, stride,
                       aux_w_q=plain.get("aux_w_q"),
                       aux_aw=plain.get("aux_aw"), **kernel)
    torch.cuda.synchronize()
    assert CI.conv_int8_launches == before + 1
    acc = CI.conv_int8_packed(x, kernel["packed"], ax, stride=stride,
                              accumulators=True, **acc_kw)
    plain_acc = {k: v for k, v in plain.items()
                 if k not in ("w_q", "aw", "gamma", "beta")}
    ref_acc = CI.conv_int8_plain(x, plain["w_q"], plain["aw"], ax,
                                 stride=stride, accumulators=True,
                                 **plain_acc)
    pairs = list(zip(acc, ref_acc)) if aux_cin else [(acc, ref_acc)]
    assert all(a.dtype == torch.int32 and torch.equal(a, r)
               for a, r in pairs)
    ref = CI.conv_int8_plain(x, ax=ax, bias=bias, stride=stride, **plain)
    assert out.dtype == dtype and out.shape == ref.shape
    if dtype == torch.float32:
        assert torch.equal(out, ref)
    else:
        assert _bf16_ulp_ok(out, ref)


@pytest.mark.parametrize("cout", [8, 32, 64, 128, 256, 512])
def test_conv_int8_fused_call_every_pass_width(cuda, cout):
    """N from 8 to 512: one pass of 32, 64 or 128 channels, or 2 and 4
    passes over one quantized halo, with aux."""
    x, ax, bias, kernel, plain = _fused_case((3, 20, 18, 64), cout, 32,
                                             torch.bfloat16, cuda, 4)
    out = CI.conv_int8_packed(x, kernel.pop("packed"), ax, bias, **kernel)
    ref = CI.conv_int8_plain(x, ax=ax, bias=bias, **plain)
    assert _bf16_ulp_ok(out, ref)


def test_conv_int8_kernel_refuses_what_it_does_not_take(cuda):
    x, w_q, aw, ax, bias = _int8_case((1, 8, 8, 16), 16, torch.bfloat16,
                                      cuda)
    packed = CI.pack_weights(w_q, aw)
    with pytest.raises(ValueError, match="stride"):
        CI.conv_int8_packed(x, packed, ax, stride=3)
    with pytest.raises(ValueError, match="channels"):
        CI.conv_int8_packed(x[..., :8], packed, ax)
    with pytest.raises(TypeError):
        CI.conv_int8_packed(x.half(), packed, ax)
    with pytest.raises(ValueError, match="share a device"):
        CI.conv_int8_packed(x, packed, ax.cpu())
    with pytest.raises(ValueError, match="packed weights"):
        CI.conv_int8(x, w_q, aw, ax, bias)
    # the fused call's arguments: aux's channels against its weights, aux
    # without its weights, gamma or beta of the wrong size
    _, ax_aux, _, kernel, plain = _fused_case((1, 8, 8, 16), 16, 8,
                                              torch.bfloat16, cuda)
    aux_kw = dict(aux=kernel["aux"], aux_packed=kernel["aux_packed"],
                  ax_aux=kernel["ax_aux"])
    with pytest.raises(ValueError, match="channels"):
        CI.conv_int8_packed(x, packed, ax,
                            **dict(aux_kw, aux=kernel["aux"][..., :4]))
    with pytest.raises(ValueError, match="packed weights"):
        CI.conv_int8(x, w_q, aw, ax, bias, packed=packed, aux=kernel["aux"],
                     aux_w_q=plain["aux_w_q"], aux_aw=plain["aux_aw"],
                     ax_aux=kernel["ax_aux"])
    with pytest.raises(ValueError, match="16 values"):
        CI.conv_int8_packed(x, packed, ax, gamma=kernel["gamma"][:8],
                            beta=kernel["beta"])
    with pytest.raises(ValueError, match="16 values"):
        CI.conv_int8_packed(x, packed, ax, gamma=kernel["gamma"],
                            beta=kernel["beta"][:15])
    with pytest.raises(ValueError, match="share a device"):
        CI.conv_int8_packed(x, packed, ax, gamma=kernel["gamma"].cpu(),
                            beta=kernel["beta"].cpu())


def test_quantized_vunet_serves_through_the_kernel(cuda):
    """An int8_static VUNet on the card: calibrate, then transfer_cached
    launches the int8 kernel at every int8 conv and stays close to the same
    VUNet serving in bf16 without quant."""
    kw = dict(spatial_size=64, nf_start=16, nf_max=64, dtype=torch.bfloat16)
    plain = VUNet(**kw, device="meta").to_empty(device=cuda)
    init_random_(plain, torch.Generator(device=cuda).manual_seed(0))
    net = VUNet(**kw, quant="int8_static", quant_max_hw=32, device="meta")
    net = net.to_empty(device=cuda)
    net.load_state_dict(plain.state_dict())
    g = torch.Generator(device=cuda).manual_seed(1)
    c = (torch.rand(6, 64, 64, 3, generator=g, device=cuda) * 2 - 1).to(
        torch.bfloat16)
    app = (torch.rand(2, 64, 64, 3, generator=g, device=cuda) * 2 - 1)
    calls = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: calls.append(mod.route(args[0]) == "int8"))
        for m in net.modules() if isinstance(m, pnn.NormConv2d)]
    with torch.inference_mode():
        means, _ = plain.eval().encode_means(app, generator=g)
        means = [m.repeat_interleave(3, 0) for m in means]
        from behavior_driven_video_synthesis_tpu_torch.models.vunet import (
            calibrate_quant)
        scales = calibrate_quant(net.eval(), means, c)
        calls.clear()
        before = CI.conv_int8_launches
        out = net.transfer_cached(means, c)
        launches = CI.conv_int8_launches - before
        ref = plain.transfer_cached(means, c)
    for h in hooks:
        h.remove()
    # one launch an int8 NormConv2d call, aux included; x's scale, and
    # aux's where a call has one
    assert scales and launches == sum(calls)
    assert sum(calls) <= len(scales) <= 2 * sum(calls)
    rel = (out.float() - ref.float()).norm() / ref.float().norm()
    assert float(rel) < 5e-2


def _epilogue_case(shape, dtype, device, residual, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    y = (torch.randn(shape, generator=g, device=device) * 4).to(dtype)
    b = torch.randn(shape[-1], generator=g, device=device)
    r = ((torch.randn(shape, generator=g, device=device) * 2).to(dtype)
         if residual else None)
    return y, b, r


def _epilogue_matches_reference(y, b, r):
    """One launch, in place, equal to the float32 reference rounded once."""
    ref = CE.conv_epilogue_plain(y, b, r)
    ptr, before = y.data_ptr(), CE.conv_epilogue_launches
    out = CE.conv_epilogue(y, b, r)
    torch.cuda.synchronize()
    assert CE.conv_epilogue_launches == before + 1
    assert out.data_ptr() == ptr and out.dtype == ref.dtype
    assert torch.equal(out, ref)


@pytest.mark.parametrize("shape", [
    (125, 256, 256, 32), (125, 128, 128, 64), (125, 64, 64, 128),
    (125, 4, 4, 128), (125, 256, 256, 3)])
@pytest.mark.parametrize("residual", [False, True])
def test_conv_epilogue_kernel_at_chunk_shapes(cuda, shape, residual):
    """The 125-frame chunk's conv outputs, bf16, against the float32
    reference: the vector path (C a multiple of 8) and the scalar path
    (the RGB head's C = 3)."""
    _epilogue_matches_reference(*_epilogue_case(shape, torch.bfloat16, cuda,
                                                residual))


@pytest.mark.parametrize("shape,dtype", [
    ((3, 17, 19, 40), torch.bfloat16), ((2, 9, 7, 8), torch.bfloat16),
    ((2, 16, 16, 512), torch.bfloat16), ((1, 3, 5, 2056), torch.bfloat16),
    ((4, 11, 13, 5), torch.bfloat16), ((2, 33, 31, 64), torch.float16),
    ((3, 7, 9, 3), torch.float16), ((1, 1, 1, 1), torch.bfloat16)])
@pytest.mark.parametrize("residual", [False, True])
def test_conv_epilogue_kernel_off_the_chunk_shapes(cuda, shape, dtype,
                                                   residual):
    """Channel counts whose groups do not divide the block (40), above its
    groups (2056: the scalar path), odd (5), f16, a single element."""
    _epilogue_matches_reference(*_epilogue_case(shape, dtype, cuda,
                                                residual))


def test_conv_epilogue_kernel_strided_and_misaligned_operands(cuda):
    """A strided y is refused (the kernel writes it in place); a strided
    residual is copied and a residual off 16-byte alignment takes the
    scalar path: both equal the reference."""
    y, b, r = _epilogue_case((2, 8, 8, 32), torch.bfloat16, cuda, True)
    with pytest.raises(ValueError, match="contiguous"):
        CE.conv_epilogue(y.transpose(1, 2), b, r.transpose(1, 2))
    wide = torch.randn(2, 8, 8, 64, device=cuda).bfloat16()
    _epilogue_matches_reference(y.clone(), b, wide[..., ::2])
    flat = torch.randn(r.numel() + 1, device=cuda).bfloat16()
    off = flat[1:].view(r.shape)
    assert off.data_ptr() % 16
    _epilogue_matches_reference(y.clone(), b, off)
    with pytest.raises(TypeError, match="bfloat16 or float16"):
        CE.conv_epilogue(y.float(), b)
    with pytest.raises(ValueError, match="bias"):
        CE.conv_epilogue(y, b.bfloat16())
    with pytest.raises(ValueError, match="device"):
        CE.conv_epilogue(y, b.cpu())


def _act_store_matches_plain(y, buf, lo, b, r, fill):
    """One activated store into channels lo:lo + C of ``buf`` (filled with
    ``fill``), equal to the plain version, the other channels untouched;
    counted as an activated store, and as a conv's epilogue where it adds
    a bias."""
    C = y.shape[-1]
    ref = CE.conv_epilogue_act_plain(y, b, r)
    n0 = (CE.conv_epilogue_launches, CE.conv_epilogue_act_launches)
    out = CE.conv_epilogue_act(y, buf[..., lo:lo + C], b, r)
    torch.cuda.synchronize()
    assert out.data_ptr() == buf[..., lo:].data_ptr()
    assert (CE.conv_epilogue_launches, CE.conv_epilogue_act_launches) == (
        n0[0] + (b is not None), n0[1] + 1)
    assert torch.equal(out, ref)
    del ref
    assert bool((buf[..., :lo] == fill).all())
    assert bool((buf[..., lo + C:] == fill).all())


@pytest.mark.parametrize("shape", [
    (125, 256, 256, 32), (125, 128, 128, 64), (125, 64, 64, 128),
    (125, 4, 4, 128)])
@pytest.mark.parametrize("mode", ["x", "nin", "residual"])
def test_conv_epilogue_act_kernel_at_chunk_shapes(cuda, shape, mode):
    """The activated store at a 125-frame chunk's residual blocks, bf16,
    into a 2C buffer, bit-equal to its plain version (F.elu of the plain
    epilogue's output): ELU(x) into the lower half (no bias), the nin
    conv's ELU(y + b') into the upper half, and with a residual."""
    y, b, r = _epilogue_case(shape, torch.bfloat16, cuda, mode == "residual")
    C = shape[-1]
    buf = torch.full(shape[:-1] + (2 * C,), 3.0, dtype=torch.bfloat16,
                     device=cuda)
    _act_store_matches_plain(y, buf, 0 if mode == "x" else C,
                             None if mode == "x" else b, r, 3.0)


@pytest.mark.parametrize("C,width,offset,dtype", [
    (32, 65, 1, torch.bfloat16), (32, 72, 4, torch.bfloat16),
    (64, 128, 64, torch.float16), (3, 6, 3, torch.bfloat16),
    (40, 80, 40, torch.bfloat16), (2056, 4112, 2056, torch.bfloat16)])
@pytest.mark.parametrize("bias", [False, True])
def test_conv_epilogue_act_kernel_off_the_chunk_shapes(cuda, C, width,
                                                       offset, dtype, bias):
    """Slices off 16-byte alignment (offset 1 of 65 channels, offset 4 of
    72: the scalar path), f16, C = 3 and 2,056 (scalar), 40 (groups that
    do not divide the block)."""
    y, b, _ = _epilogue_case((3, 9, 7, C), dtype, cuda, False)
    buf = torch.full((3, 9, 7, width), -5.0, dtype=dtype, device=cuda)
    _act_store_matches_plain(y, buf, offset, b if bias else None, None,
                             -5.0)


def test_conv_epilogue_act_kernel_every_bf16_pattern(cuda):
    """All 65,536 bf16 values, NaN and infinities included, through the
    activated store without a bias: the bits of F.elu on the card."""
    y = (torch.arange(65536, dtype=torch.int32, device=cuda) - 32768).to(
        torch.int16).view(torch.bfloat16).reshape(-1, 8)
    buf = torch.zeros(y.shape[0], 16, dtype=torch.bfloat16, device=cuda)
    CE.conv_epilogue_act(y, buf[:, 8:])
    ref = torch.nn.functional.elu(y)
    same = (buf[:, 8:].view(torch.int16) == ref.view(torch.int16)) | (
        torch.isnan(buf[:, 8:]) & torch.isnan(ref))
    assert bool(same.all())


def test_conv_epilogue_act_kernel_refuses_what_it_does_not_take(cuda):
    """An out that overlaps y (in place), a strided slice, another dtype."""
    y, b, _ = _epilogue_case((2, 8, 8, 32), torch.bfloat16, cuda, False)
    buf = torch.zeros(2, 8, 8, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="overlaps"):
        CE.conv_epilogue_act(y, y, b)
    with pytest.raises(ValueError, match="channel slice"):
        CE.conv_epilogue_act(y, buf[..., ::2], b)
    with pytest.raises(ValueError, match="type, shape"):
        CE.conv_epilogue_act(y, buf.half()[..., :32], b)


def _serving_vunet(variant, rnb_impl, device, seed=0):
    rng = np.random.RandomState(seed)
    arch = dict(spatial_size=64, nf_start=16, nf_max=32, variant=variant,
                rnb_impl=rnb_impl, dtype=torch.bfloat16)
    if variant == "org":
        arch.update(n_channels_x=30, box_factor=1)
    net = init_random_(VUNet(**arch), rng).to(device).eval()
    with torch.no_grad():       # affines away from their init's (1, 0)
        for m in net.modules():
            if isinstance(m, pnn.NormConv2d):
                m.gamma.copy_(1 + 0.3 * torch.randn_like(m.gamma))
                m.beta.copy_(0.3 * torch.randn_like(m.beta))
    x_channels = 30 if variant == "org" else 3
    x_size = 32 if variant == "org" else 64
    x = torch.from_numpy(rng.rand(3, x_size, x_size, x_channels)).float()
    c = torch.from_numpy(rng.rand(6, 64, 64, 3) * 2 - 1).bfloat16()
    eps = [torch.from_numpy(rng.randn(3, s, s, 32)).float() for s in (4, 8)]
    return net, x.to(device), c.to(device), [e.to(device) for e in eps]


def _full_precision_calls(net):
    """Counts the NormConv2d calls that neither run int8 nor d2s: a list
    whose length grows by one a call, and the hooks' handles."""
    calls = []

    def hook(m, args, out):
        if m.route(args[0]) not in ("d2s_transpose", "int8"):
            calls.append(m)
    return calls, [m.register_forward_hook(hook) for m in net.modules()
                   if isinstance(m, pnn.NormConv2d)]


@pytest.mark.parametrize("variant,rnb_impl", [("alter", "cudnn"),
                                              ("org", "fused")])
def test_vunet_folded_route_on_the_card(cuda, variant, rnb_impl):
    """A bf16 VUNet's ``transfer_cached`` (its means from
    ``encode_means``) against the unfolded route (the same calls with
    autograd on and no parameter requiring a gradient): within bf16 noise;
    one epilogue launch a full-precision NormConv2d call; the folded
    weights built on the first call only; a second call bit-equal."""
    net, x, c, eps = _serving_vunet(variant, rnb_impl, cuda)
    with torch.no_grad():
        means, _ = net.encode_means(x, eps)
    means = [torch.repeat_interleave(m, 2, dim=0) for m in means]
    calls, hooks = _full_precision_calls(net)
    try:
        with torch.inference_mode():
            n0, b0 = CE.conv_epilogue_launches, pnn.prepared_builds["fold"]
            first = net.transfer_cached(means, c)
            torch.cuda.synchronize()
            n_calls = len(calls)
            assert n_calls > 0
            assert CE.conv_epilogue_launches - n0 == n_calls
            built = pnn.prepared_builds["fold"] - b0
            assert 0 < built <= n_calls
            second = net.transfer_cached(means, c)
            torch.cuda.synchronize()
            assert CE.conv_epilogue_launches - n0 == 2 * n_calls
            assert pnn.prepared_builds["fold"] - b0 == built
        assert torch.equal(first, second)
        net.requires_grad_(False)
        n1 = CE.conv_epilogue_launches
        with torch.enable_grad():
            ref = net.transfer_cached(means, c)
        torch.cuda.synchronize()
        assert CE.conv_epilogue_launches == n1
    finally:
        for h in hooks:
            h.remove()
    assert first.dtype == ref.dtype == torch.bfloat16
    assert bool(torch.isfinite(first).all())
    rel = float((first.float() - ref.float()).norm() / ref.float().norm())
    assert rel < 2e-2, rel


@pytest.fixture
def concat_route(monkeypatch):
    """``off()`` sends every residual block with auxiliary input back to
    the concatenating route for the rest of the test; the fixture restores
    the route afterwards."""
    def off():
        monkeypatch.setattr(pnn.VunetRNB, "_concat_free",
                            lambda self, x, a, train: False)
    return off


def _aux_block_calls(net):
    """Counts the VunetRNB calls with auxiliary input: a list that grows by
    one a call, and the hooks' handles."""
    calls = []

    def hook(m, args):
        if len(args) > 1 and args[1] is not None:
            calls.append(m)
    return calls, [m.register_forward_pre_hook(hook) for m in net.modules()
                   if isinstance(m, pnn.VunetRNB)]


@pytest.mark.parametrize("variant,rnb_impl", [("alter", "cudnn"),
                                              ("org", "fused")])
def test_vunet_concat_free_route_is_bit_equal(cuda, concat_route, variant,
                                              rnb_impl):
    """A bf16 VUNet's ``encode_means`` and ``transfer_cached`` on the
    concatenation-free route are torch.equal to the same calls with the
    route off; two activated stores a residual block call with auxiliary
    input, none with the route off or under autograd."""
    net, x, c, eps = _serving_vunet(variant, rnb_impl, cuda)
    calls, hooks = _aux_block_calls(net)

    def serve():
        del calls[:]
        n0 = CE.conv_epilogue_act_launches
        means, _ = net.encode_means(x, eps)
        means = [torch.repeat_interleave(m, 2, dim=0) for m in means]
        out = net.transfer_cached(means, c)
        torch.cuda.synchronize()
        return means, out, CE.conv_epilogue_act_launches - n0
    try:
        with torch.inference_mode():
            means, first, stores = serve()
        assert len(calls) > 0 and stores == 2 * len(calls)
        net.requires_grad_(False)
        n1 = CE.conv_epilogue_act_launches
        with torch.enable_grad():
            net.transfer_cached([m.clone() for m in means], c.clone())
        torch.cuda.synchronize()
        assert CE.conv_epilogue_act_launches == n1
        concat_route()
        with torch.inference_mode():
            ref_means, ref, none = serve()
        assert none == 0
    finally:
        for h in hooks:
            h.remove()
    assert all(torch.equal(m, r) for m, r in zip(means, ref_means))
    assert torch.equal(first, ref)


def test_pipeline_servings_stay_bit_equal_through_the_epilogue(cuda):
    """C18: two servings of one request through the pipeline are
    bit-equal, with the VUNet on the folded route."""
    rng = np.random.RandomState(0)
    net = init_random_(ResidualBehaviorNet(48, 32), rng).to(cuda)
    vunet = init_random_(VUNet(spatial_size=32, nf_start=8, nf_max=16,
                               dtype=torch.bfloat16), rng).to(cuda)
    pipe = BehaviorTransferPipeline(
        net, vunet, detailed_joint_model(True), np.zeros(51, np.float32),
        np.ones(51, np.float32), np.arange(51)[np.arange(51) % 17 != 0][:48],
        spatial_size=32)
    B, T = 3, 5
    args = (rng.randn(B, 32), rng.randn(B, 48) * 0.1,
            rng.rand(B, 32, 32, 3),
            np.tile(np.hstack([np.eye(3), [[0], [0], [4.0]]]), (B, 1, 1)),
            np.tile([40.0, 16, 40.0, 16], (B, 1)), np.full((B, 2), 32.0))
    def serve():
        return pipe.generate(*args, length=T, generator=torch.Generator(
            device=cuda).manual_seed(1))["frames"]
    before = CE.conv_epilogue_launches
    first = serve()
    torch.cuda.synchronize()
    assert CE.conv_epilogue_launches > before
    second = serve()
    torch.cuda.synchronize()
    assert torch.equal(first, second)


STICK_MODELS = {"h36m_world": (lambda: detailed_joint_model(True), 17),
                "h36m_image": (lambda: detailed_joint_model(False), 32),
                "market": (market_joint_model, 18),
                "deepfashion": (deepfashion_joint_model, 18),
                "chain": (lambda: chain_joint_model(9), 9)}


def _stick_joints(N, K, S, device, seed=0):
    """N frames of K joints, a tenth of them outside the image on each
    side, with invalid joints (negative, NaN), degenerate segments, joints
    past the kernel's cull limit (7e4, 1e20, inf) and frames with fewer
    than 3 valid body vertices."""
    rng = np.random.RandomState(seed)
    j = rng.rand(N, K, 2) * S * 1.3 - S * 0.15
    j[rng.rand(N, K) < 0.08] = -1.0
    j[1::7, 1] = j[1::7, 0]
    j[2::11, 0] = np.nan
    j[3::13, 0] = 7e4
    j[4::17, 2] = [1e20, 5.0]
    j[5::19, 3] = np.inf
    j[6::23, :K // 2] = -1.0
    return torch.tensor(j, dtype=torch.float32, device=device)


def _stickman_bit_equal(jm, joints, S, thickness):
    for normalized in (False, True):
        ref = render_stickman_plain(joints, jm, S, thickness,
                                    normalized=normalized)
        before = SK.stickman_launches
        out = render_stickman(joints, jm, S, thickness,
                              normalized=normalized)
        assert SK.stickman_launches == before + 1
        assert out.dtype == ref.dtype and out.shape == ref.shape
        assert torch.equal(out, ref), (
            f"normalized {normalized}: {int((out != ref).any(-1).sum())} "
            f"pixels differ")
    assert bool((ref != ref[..., :1, :1, :]).any())  # something was drawn


@pytest.mark.parametrize("model", sorted(STICK_MODELS))
@pytest.mark.parametrize("thickness", [1.0, 4.0, 5.0])
def test_stickman_kernel_matches_eager_joint_models(cuda, model, thickness):
    make, K = STICK_MODELS[model]
    _stickman_bit_equal(make(), _stick_joints(127, K, 128, cuda), 128,
                        thickness)


@pytest.mark.parametrize("S", [64, 128, 256])
@pytest.mark.parametrize("frames", [1, 127, 1000])
def test_stickman_kernel_matches_eager_sizes(cuda, S, frames):
    joints = _stick_joints(frames, 17, S, cuda, seed=frames + S)
    _stickman_bit_equal(detailed_joint_model(True),
                        joints.reshape(1, frames, 17, 2), S, 4.0)


STICK_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "golden", "torch_port_stickman_small.npz")
with np.load(STICK_GOLDEN) as _golden:
    STICK_GOLDEN_CASES = json.loads(bytes(_golden["cases"]).decode())


@pytest.mark.parametrize("case", STICK_GOLDEN_CASES,
                         ids=[c["name"] for c in STICK_GOLDEN_CASES])
def test_stickman_kernel_matches_jax_golden(cuda, case):
    """The kernel on the card against the JAX package's raster of the same
    joints and the JAX pipeline's bf16 ``stick / 127.5 - 1`` of it: at most
    0.1 % of the pixels differ, and where the raster agrees, the bf16 VUNet
    input is the JAX one bit for bit."""
    with np.load(STICK_GOLDEN) as data:
        joints, stick, normalized = (data[f"{case['name']}/{k}"] for k in
                                     ("joints", "stick", "normalized"))
    jm = STICK_MODELS[case["model"]][0]()
    j = torch.from_numpy(joints).to(cuda)
    before = SK.stickman_launches
    out = render_stickman(j, jm, case["S"], case["thickness"]).cpu().numpy()
    bits = render_stickman(j, jm, case["S"], case["thickness"],
                           normalized=True).view(torch.int16).cpu().numpy()
    assert SK.stickman_launches == before + 2
    assert out.shape == stick.shape
    differ = np.any(out != stick, axis=-1)
    assert differ.mean() <= 1e-3, f"{int(differ.sum())} pixels differ"
    bits = bits.view(np.uint16)
    np.testing.assert_array_equal(bits[~differ], normalized[~differ])
    assert stick.any()  # something was drawn


def test_stickman_kernel_one_launch_and_no_host_sync(cuda):
    jm = detailed_joint_model(True)
    joints = _stick_joints(1000, 17, 256, cuda)
    render_stickman(joints, jm, 256, 4.0, normalized=True)  # the table
    torch.cuda.synchronize()
    before = SK.stickman_launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = render_stickman(joints, jm, 256, 4.0, normalized=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert SK.stickman_launches == before + 1
    # the call returns while a queued sleep still holds the device
    torch.cuda._sleep(2 ** 31)
    render_stickman(joints, jm, 256, 4.0, normalized=True)
    done = torch.cuda.Event()
    done.record()
    assert not done.query()
    torch.cuda.synchronize()
    assert out.shape == (1000, 256, 256, 3) and out.dtype == torch.bfloat16


def test_stickman_kernel_refuses_what_it_does_not_take(cuda):
    jm = detailed_joint_model(False)        # indexes joints up to 27
    with pytest.raises(ValueError):
        render_stickman(torch.zeros(4, 17, 2, device=cuda), jm, 64)
    with pytest.raises(ValueError):
        SK.stickman_raster(torch.zeros(4, 32, 2), jm, 64)
    with pytest.raises(ValueError):
        render_stickman(torch.zeros(4, 32, 3, device=cuda), jm, 64)


def test_pipeline_stickman_one_launch_a_request_and_bit_equal(cuda):
    """One raster launch a generate request, its stickman the eager
    version's of the request's keypoints, and two servings bit-equal
    (C18)."""
    rng = np.random.RandomState(0)
    net = init_random_(ResidualBehaviorNet(48, 32), rng).to(cuda)
    vunet = init_random_(VUNet(spatial_size=32, nf_start=8, nf_max=16,
                               dtype=torch.bfloat16), rng).to(cuda)
    pipe = BehaviorTransferPipeline(
        net, vunet, detailed_joint_model(True), np.zeros(51, np.float32),
        np.ones(51, np.float32), np.arange(51)[np.arange(51) % 17 != 0][:48],
        spatial_size=32)
    B, T = 3, 5
    args = (rng.randn(B, 32), rng.randn(B, 48) * 0.1,
            rng.rand(B, 32, 32, 3),
            np.tile(np.hstack([np.eye(3), [[0], [0], [4.0]]]), (B, 1, 1)),
            np.tile([40.0, 16, 40.0, 16], (B, 1)), np.full((B, 2), 32.0))

    def serve():
        return pipe.generate(*args, length=T, generator=torch.Generator(
            device=cuda).manual_seed(1))
    before = SK.stickman_launches
    first = serve()
    second = serve()
    torch.cuda.synchronize()
    assert SK.stickman_launches == before + 2
    ref = render_stickman_plain(first["keypoints_2d"], pipe.joint_model, 32,
                                pipe.thickness, normalized=True)
    assert first["stickman"].dtype == torch.bfloat16
    assert torch.equal(first["stickman"], ref)
    assert torch.equal(first["stickman"], second["stickman"])
    assert torch.equal(first["frames"], second["frames"])
