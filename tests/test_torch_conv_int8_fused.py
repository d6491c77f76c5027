"""The int8 conv as one NormConv2d call, on the CPU.

``ops/cuda/conv_int8.py:conv_int8_plain`` with aux, gamma and beta is the
function the CUDA kernel computes in one launch: x's conv plus bias and
aux's conv, each rounded to the output dtype, added in that dtype, then
``gamma * y + beta`` with each op rounded.  These tests hold it bit for
bit against that composition spelled out with the single-input plain
version, on ragged shapes (H and W no multiple of the kernel's tiles,
channel counts no multiple of its 32-channel chunks), check that
``pack_weights``'s layout unpacks back to W_q and aw, that a quantized
NormConv2d makes one int8 conv call a forward (aux included), and that the
kernel's wrapper refuses the new arguments' mismatches before it launches
anything.  The JAX package's agreement is held in ``test_torch_quant.py``.
"""
import numpy as np
import pytest
import torch

from behavior_driven_video_synthesis_tpu_torch.models.init import init_random_
from behavior_driven_video_synthesis_tpu_torch.ops import nn as pnn
from behavior_driven_video_synthesis_tpu_torch.ops.cuda import conv_int8 as ci8

from torch_port_threads import one_torch_thread  # noqa: F401


def _case(seed, hw, cin, n, aux_cin, dtype):
    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale)
                                .astype(np.float32))
    x = t(2, hw[0], hw[1], cin, scale=3.0).to(dtype)
    w_q, aw = ci8.quantize_weight(t(n, cin, 3, 3))
    case = dict(x=x, w_q=w_q, aw=aw, ax=ci8.act_scale(x), bias=t(n),
                gamma=t(n).to(dtype), beta=t(n).to(dtype))
    if aux_cin:
        a = t(2, hw[0], hw[1], aux_cin, scale=2.0).to(dtype)
        a_q, a_aw = ci8.quantize_weight(t(n, aux_cin, 3, 3))
        case.update(aux=a, aux_w_q=a_q, aux_aw=a_aw, ax_aux=ci8.act_scale(a))
    return case


def _composed(c, stride, dtype):
    """Today's NormConv2d int8 call, op by op."""
    y = ci8.conv_int8_plain(c["x"], c["w_q"], c["aw"], c["ax"], c["bias"],
                            stride, dtype)
    if "aux" in c:
        y = y + ci8.conv_int8_plain(c["aux"], c["aux_w_q"], c["aux_aw"],
                                    c["ax_aux"], None, stride, dtype)
    return c["gamma"].to(dtype) * y + c["beta"].to(dtype)


def _fused(c, stride, dtype, **kw):
    extra = {k: c[k] for k in ("aux", "aux_w_q", "aux_aw", "ax_aux")
             if k in c}
    return ci8.conv_int8_plain(c["x"], c["w_q"], c["aw"], c["ax"],
                               c["bias"], stride, dtype, gamma=c["gamma"],
                               beta=c["beta"], **extra, **kw)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("cin,n,aux_cin", [(12, 8, 0), (48, 20, 0),
                                           (12, 512, 0), (48, 8, 12),
                                           (12, 20, 48)])
def test_fused_plain_is_the_composition(dtype, stride, cin, n, aux_cin):
    c = _case(cin + n + aux_cin + stride, (9, 11), cin, n, aux_cin, dtype)
    out = _fused(c, stride, dtype)
    ref = _composed(c, stride, dtype)
    assert out.dtype == dtype and out.shape == ref.shape
    assert torch.equal(out, ref)


@pytest.mark.parametrize("stride", [1, 2])
def test_fused_plain_accumulators_with_aux(stride):
    """The int32 sums of x's and aux's convs, beside each other, as the
    single-input plain version gives them."""
    c = _case(3, (7, 10), 12, 20, 8, torch.bfloat16)
    acc_x, acc_a = _fused(c, stride, None, accumulators=True)
    ref_x = ci8.conv_int8_plain(c["x"], c["w_q"], c["aw"], c["ax"],
                                stride=stride, accumulators=True)
    ref_a = ci8.conv_int8_plain(c["aux"], c["aux_w_q"], c["aux_aw"],
                                c["ax_aux"], stride=stride,
                                accumulators=True)
    assert acc_x.dtype == acc_a.dtype == torch.int32
    assert torch.equal(acc_x, ref_x) and torch.equal(acc_a, ref_a)


def test_fused_plain_bf16_in_f32_out():
    c = _case(5, (6, 6), 12, 20, 12, torch.bfloat16)
    out = _fused(c, 1, torch.float32)
    assert out.dtype == torch.float32
    assert torch.equal(out, _composed(c, 1, torch.float32))


@pytest.mark.parametrize("n,cin", [(8, 3), (20, 12), (64, 64), (100, 48),
                                   (128, 128), (512, 128)])
def test_pack_weights_unpacks(n, cin):
    rng = np.random.RandomState(n + cin)
    w_q, aw = ci8.quantize_weight(torch.from_numpy(
        rng.randn(n, cin, 3, 3).astype(np.float32)))
    packed = ci8.pack_weights(w_q, aw)
    chunks, taps, npad, row = packed.w.shape
    assert (chunks, taps, row) == (-(-cin // 32), 9, 32) and npad >= n
    assert npad % (32 if n <= 32 else 64 if n <= 64 else 128) == 0
    w2, aw2 = ci8.unpack_weights(packed)
    assert torch.equal(w2, w_q) and torch.equal(aw2, aw)
    # K chunk c, tap (kh, kw), the row of output channel j, byte k:
    # W_q[j, 32 c + k]; rows ordered in blocks of 32 by ROW_ORDER
    channel = [32 * (r // 32) + ci8.ROW_ORDER[r % 32] for r in range(npad)]
    assert sorted(channel) == list(range(npad))
    c, tap, j, k = min(1, chunks - 1), 5, n - 1, (cin - 1) % 32
    row = channel.index(j)
    assert packed.w[c, tap, row, k] == w_q[j, 32 * c + k, tap // 3, tap % 3]
    past = torch.tensor([ch >= n for ch in channel])
    assert not packed.w[:, :, past].any() and not packed.aw[n:].any()


@pytest.mark.parametrize("aux", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_norm_conv_makes_one_int8_call(monkeypatch, aux, dtype):
    """A quantized NormConv2d forward is one int8 conv call, aux and the
    affine included, and returns the composition's output."""
    cx, ca, n = 8, 12, 16
    conv = pnn.NormConv2d(cx + (ca if aux else 0), n, 3, padding=1,
                          quant="int8", dtype=dtype)
    init_random_(conv, np.random.RandomState(2))
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 7, 9, cx).astype(np.float32)).to(dtype)
    a = (torch.from_numpy(rng.randn(2, 7, 9, ca).astype(np.float32))
         .to(dtype) if aux else None)
    calls = []
    real = pnn.conv_int8
    monkeypatch.setattr(pnn, "conv_int8",
                        lambda *args, **kw: calls.append(1) or real(*args,
                                                                    **kw))
    with torch.no_grad():
        out = conv(x, a)
    assert len(calls) == 1
    weights = conv._int8_weights(cx if aux else None)
    c = dict(x=x, w_q=weights[0][0], aw=weights[0][1],
             ax=ci8.act_scale(x), bias=conv.conv.bias.detach(),
             gamma=conv.gamma.detach().reshape(-1),
             beta=conv.beta.detach().reshape(-1))
    if aux:
        c.update(aux=a, aux_w_q=weights[1][0], aux_aw=weights[1][1],
                 ax_aux=ci8.act_scale(a))
    assert out.dtype == dtype
    assert torch.equal(out, _composed(c, 1, dtype))


def test_kernel_wrapper_refuses_mismatched_aux_and_affine():
    """The wrapper's checks run before any launch, so they hold on the CPU
    too: aux channels that do not match its weights, aux without its
    weights or scale, aux of another size or dtype, and gamma or beta of
    the wrong size."""
    c = _case(7, (6, 6), 16, 16, 8, torch.bfloat16)
    packed = ci8.pack_weights(c["w_q"], c["aw"])
    aux_packed = ci8.pack_weights(c["aux_w_q"], c["aux_aw"])
    kw = dict(aux=c["aux"], aux_packed=aux_packed, ax_aux=c["ax_aux"])
    with pytest.raises(ValueError, match="channels"):
        ci8.conv_int8_packed(c["x"], packed, c["ax"],
                             **dict(kw, aux=c["aux"][..., :4]))
    with pytest.raises(ValueError, match="packed weights"):
        ci8.conv_int8_packed(c["x"], packed, c["ax"], aux=c["aux"],
                             ax_aux=c["ax_aux"])
    with pytest.raises(TypeError, match="NHWC like x"):
        ci8.conv_int8_packed(c["x"], packed, c["ax"],
                             **dict(kw, aux=c["aux"].float()))
    with pytest.raises(TypeError, match="NHWC like x"):
        ci8.conv_int8_packed(c["x"], packed, c["ax"],
                             **dict(kw, aux=c["aux"][:, :5]))
    with pytest.raises(ValueError, match="output channels"):
        ci8.conv_int8_packed(c["x"], packed, c["ax"], **dict(
            kw, aux_packed=ci8.pack_weights(c["aux_w_q"][:8],
                                            c["aux_aw"][:8])))
    with pytest.raises(ValueError, match="16 values"):
        ci8.conv_int8_packed(c["x"], packed, c["ax"], gamma=c["gamma"][:8],
                             beta=c["beta"])
    with pytest.raises(ValueError, match="16 values"):
        ci8.conv_int8_packed(c["x"], packed, c["ax"], gamma=c["gamma"],
                             beta=torch.cat([c["beta"], c["beta"]]))
    with pytest.raises(ValueError, match="together"):
        ci8.conv_int8_packed(c["x"], packed, c["ax"], gamma=c["gamma"])
    with pytest.raises(TypeError, match="layout"):
        ci8.conv_int8_packed(c["x"], packed._replace(
            w=packed.w.reshape(-1)), c["ax"])
