"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; without a CUDA device every test skips.  The card's machine
has no JAX, which ``tests/conftest.py`` imports, so run them there with

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest -q

Tolerances.  Rollout: the kernel and the bf16-operand plain version round
the same operands to bf16 and accumulate in f32; they differ only in
summation order (atomics included) and in the rare bf16 rounding flip of h
that this causes, so atol 1e-2, rtol 1e-2.  ELU+dropout: the plain version
computes the kernel's Philox stream, so the keep decisions agree exactly;
values within one bf16 ulp (bf16) or 1e-6 (f32), for expm1f/expf may
differ from torch's in the last f32 bit.  Fused RNB: the kernel and its
plain version round elu(x) and W to bf16 and accumulate in f32; they
differ in summation order and, rarely, in a bf16 rounding of elu(x) or of
the output, so atol 1e-2, rtol 1e-2.
"""
import numpy as np
import pytest
import torch

from behavior_driven_video_synthesis_tpu_torch.data.human36m import (
    detailed_joint_model)
from behavior_driven_video_synthesis_tpu_torch.models import (
    ResidualBehaviorNet, decoder_rollout_kernel)
from behavior_driven_video_synthesis_tpu_torch.models.init import init_random_
from behavior_driven_video_synthesis_tpu_torch.models.vunet import VUNet
from behavior_driven_video_synthesis_tpu_torch.ops import nn as pnn
from behavior_driven_video_synthesis_tpu_torch.ops.cuda import (
    elu_dropout as E)
from behavior_driven_video_synthesis_tpu_torch.ops.cuda import (
    fused_rnb as FR)
from behavior_driven_video_synthesis_tpu_torch.ops.cuda import rollout as R
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
    builds, launches = R.operand_builds, R.rollout_launches
    with torch.no_grad():
        first = decoder_rollout_kernel(d, b, x0, 6)
        again = decoder_rollout_kernel(d, b, x0, 6)
        assert R.operand_builds == builds + 1
        d.rnn.weight_hh.mul_(0.5)
        moved = decoder_rollout_kernel(d, b, x0, 6)
        assert R.operand_builds == builds + 2
        ref = R.residual_lstm_rollout_prepared_plain(
            b, x0, R.prepared_operands(d), 6)
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
        builds, launches = R.operand_builds, R.rollout_launches
        with torch.inference_mode():
            xs = decoder_rollout_kernel(d, b, x0, T)
            r = d.rnn
            ref = R.residual_lstm_rollout_plain(
                b, x0, r.weight_ih, r.weight_hh, r.bias_ih, r.bias_hh,
                d.n_out.weight, d.n_out.bias, T,
                operand_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert R.rollout_launches == launches + 1
        assert R.operand_builds == builds + 1
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
    return init_random_(pnn.VunetRNB(C, dtype=torch.bfloat16, **kw),
                        np.random.RandomState(C)).to(device).eval()


def _fused_matches_plain(x, block):
    before = FR.fused_rnb_launches
    with torch.no_grad():
        out = FR.fused_rnb(x, block)
        torch.cuda.synchronize()
        ref = FR.fused_rnb_plain(x.contiguous(), block)
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
            FR.fused_rnb(x.float(), block)
        with pytest.raises(ValueError, match="3x3"):
            FR.fused_rnb(x[..., :8], block)
        with pytest.raises(ValueError, match="C % 8"):
            FR.fused_rnb(torch.zeros(1, 4, 4, 12, device=cuda,
                                     dtype=torch.bfloat16), _rnb_block(12, cuda))
        with pytest.raises(ValueError, match="C <= 128"):
            FR.fused_rnb(torch.zeros(1, 4, 4, 136, device=cuda,
                                     dtype=torch.bfloat16),
                         _rnb_block(136, cuda))
        with pytest.raises(ValueError, match="3x3"):
            FR.fused_rnb(x, _rnb_block(16, cuda, residual=True))
        with pytest.raises(ValueError, match="on cpu"):
            FR.fused_rnb(x, _rnb_block(16, "cpu"))
        # a strided view is copied, not refused
        wide = torch.randn(2, 8, 8, 32, device=cuda).bfloat16()
        torch.testing.assert_close(
            FR.fused_rnb(wide[..., ::2], block).float(),
            FR.fused_rnb_plain(wide[..., ::2].contiguous(), block).float(),
            atol=1e-2, rtol=1e-2)
    with pytest.raises(RuntimeError, match="no backward"):
        FR.fused_rnb(x, block.requires_grad_(True))


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
