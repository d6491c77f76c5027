"""The CUDA rollout kernel against its plain PyTorch version, on the card.

Marked ``gpu``; without a CUDA device every test skips.  The card's machine
has no JAX, which ``tests/conftest.py`` imports, so run them there with

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest -q

Tolerance: the kernel and the bf16-operand plain version round the same
operands to bf16 and accumulate in f32; they differ only in summation
order (atomics included) and in the rare bf16 rounding flip of h that this
causes, so atol 1e-2, rtol 1e-2.
"""
import numpy as np
import pytest
import torch

from behavior_driven_video_synthesis_tpu_torch.data.human36m import (
    detailed_joint_model)
from behavior_driven_video_synthesis_tpu_torch.models import (
    ResidualBehaviorNet)
from behavior_driven_video_synthesis_tpu_torch.models.init import init_random_
from behavior_driven_video_synthesis_tpu_torch.models.vunet import VUNet
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
    (37, 48, 256, 9), (64, 17, 64, 3), (33, 1, 8, 2), (5, 48, 2048, 4)])
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
