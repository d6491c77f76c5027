"""The port's fused ELU+dropout (ops/cuda/elu_dropout.py) on the CPU.

CPU tensors take the plain version, which computes the CUDA kernel's
Philox4x32-10 stream in torch integer arithmetic; the kernel is held
against it bit for bit on the card (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py``).  Here: the plain Philox against a pure-Python one and
Random123's known answers, and the statistical contract that
``tests/test_elu_dropout.py`` holds the JAX op to: drop fraction, survivors
scaled by the exact inverse keep probability, E[out] = E[elu(x)], the
backward's mask equal to the forward's, the rate 0 and 1 edges, and a
gradcheck of the autograd Function in f64.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from behavior_driven_video_synthesis_tpu.ops.pallas.elu_dropout import (
    _keep_params, elu_dropout as jax_elu_dropout)

from behavior_driven_video_synthesis_tpu_torch.ops.cuda import (
    elu_dropout as E)

MASK = 0xFFFFFFFF


def philox_reference(counter, key):
    """Philox4x32-10 on Python integers (Salmon et al., SC'11)."""
    c, (k0, k1) = list(counter), key
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k0) & MASK, p1 & MASK,
             ((p0 >> 32) ^ c[3] ^ k1) & MASK, p0 & MASK]
        k0, k1 = (k0 + 0x9E3779B9) & MASK, (k1 + 0xBB67AE85) & MASK
    return c


@pytest.mark.parametrize("counter,key,expected", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((MASK,) * 4, (MASK, MASK),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, expected):
    """Random123's known-answer vectors, in both implementations."""
    assert tuple(philox_reference(counter, key)) == expected
    t = [torch.tensor(v, dtype=torch.int64) for v in counter + key]
    assert tuple(int(w) for w in E.philox4x32_10(*t)) == expected


@pytest.mark.parametrize("seed_words,n", [((7, -3), 37),
                                          ((-2 ** 31, 2 ** 31 - 1), 9),
                                          ((123456789, 0), 4)])
def test_dropout_bits_match_python_philox(seed_words, n):
    """Element 4g + j takes word j of counter (g, 0, 0, 0), keyed by the
    seed words read as u32."""
    seed = torch.tensor(seed_words, dtype=torch.int32)
    bits = E.dropout_bits(seed, n).tolist()
    key = tuple(w & MASK for w in seed_words)
    ref = [w for g in range((n + 3) // 4)
           for w in philox_reference((g, 0, 0, 0), key)][:n]
    assert bits == ref


def test_high_counter_words_reach_the_stream():
    """Groups past 2**32 put g >> 32 in counter word 1."""
    g = torch.tensor([2 ** 32 + 5], dtype=torch.int64)
    k0, k1 = torch.tensor(11), torch.tensor(22)
    words = E.philox4x32_10(g & MASK, g >> 32, torch.zeros_like(g),
                            torch.zeros_like(g), k0, k1)
    assert [int(w) for w in words] == philox_reference((5, 1, 0, 0),
                                                       (11, 22))


def test_keep_params_are_the_jax_kernels():
    for rate in (0.05, 0.2, 0.5, 1e-9):
        assert E.keep_params(rate) == _keep_params(rate)


def _x(shape, seed=0, dtype=torch.float32):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(*shape).astype(np.float32)
    ).to(dtype)


@pytest.mark.parametrize("rate", [0.05, 0.2, 0.5])
def test_forward_contract(rate):
    x = _x((64, 1000))
    y = E.elu_dropout(x, rate, torch.Generator().manual_seed(1))
    thresh, scale = E.keep_params(rate)
    e = F.elu(x)
    dropped = (y == 0).numpy()
    n = dropped.size
    assert abs(dropped.mean() - rate) < 5 * np.sqrt(rate * (1 - rate) / n)
    kept = ~dropped
    np.testing.assert_allclose(y.numpy()[kept], e.numpy()[kept] * scale,
                               rtol=1e-6, atol=1e-7)
    assert y.dtype == x.dtype and y.shape == x.shape


def test_unbiased_over_seeds():
    """E[out] = E[elu(x)]: the mean over 400 seeds, as the JAX test."""
    x = _x((64, 128))
    g = torch.Generator().manual_seed(0)
    ys = torch.stack([E.elu_dropout(x, 0.2, g) for _ in range(400)])
    e = F.elu(x)
    rel = float((ys.mean(0) - e).abs().mean() / e.abs().mean())
    assert rel < 0.05, rel


def test_seeds_differ_and_repeat():
    x = _x((8, 256))
    s1, s2 = torch.tensor([1, 2], dtype=torch.int32), torch.tensor(
        [1, 3], dtype=torch.int32)
    a, b = E.elu_dropout_plain(x, s1, 0.5), E.elu_dropout_plain(x, s2, 0.5)
    assert torch.equal(a, E.elu_dropout_plain(x, s1, 0.5))
    assert not torch.equal(a == 0, b == 0)


def test_backward_regenerates_the_forward_mask():
    """Same seed, same bits: zero outputs get zero gradient, kept ones
    scale * elu'(x) (the JAX test's expectation)."""
    rate = 0.1
    x = _x((32, 128), seed=3).requires_grad_(True)
    seed = torch.tensor([5, -9], dtype=torch.int32)
    y = E.EluDropout.apply(x, seed, rate)
    (g,) = torch.autograd.grad(y.sum(), x)
    _, scale = E.keep_params(rate)
    xf = x.detach().numpy()
    dropped = (y == 0).detach().numpy()
    amb = np.abs(F.elu(x).detach().numpy()) <= 1e-3
    exp_g = np.where(dropped, 0.0, scale * np.where(xf > 0, 1.0, np.exp(xf)))
    np.testing.assert_allclose(g.numpy()[~amb], exp_g[~amb], atol=1e-5)
    ct = _x((32, 128), seed=4)
    dx = E.elu_dropout_backward(x.detach(), ct, seed, rate)
    assert torch.equal(dx == 0, (y == 0) | (ct == 0))


def test_rate_edges():
    x = _x((16, 33))
    torch.testing.assert_close(E.elu_dropout(x, 0.0), F.elu(x),
                               rtol=0, atol=0)
    assert float(E.elu_dropout(x, 1.0).abs().sum()) == 0.0


def test_bf16_rounds_once():
    """bf16 in, bf16 out: ELU and the scale in f32, one rounding."""
    x = _x((4, 1000), seed=5, dtype=torch.bfloat16)
    seed = torch.tensor([3, 4], dtype=torch.int32)
    y = E.elu_dropout_plain(x, seed, 0.3)
    _, scale = E.keep_params(0.3)
    ref = torch.where(y == 0, torch.zeros(()), F.elu(x.float()) * scale)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y, ref.to(torch.bfloat16), rtol=0, atol=0)


def test_gradcheck_f64():
    x = _x((3, 7, 5), seed=6).double().requires_grad_(True)
    seed = torch.tensor([17, 29], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda v: E.EluDropout.apply(v, seed, 0.3), (x,), eps=1e-6,
        atol=1e-6)


def test_same_statistics_as_the_jax_op():
    """The JAX op (its XLA composition off the TPU) and the port drop the
    same fraction and keep the same survivor values; the bit streams
    differ by design."""
    x = _x((128, 256), seed=7)
    rate = 0.2
    yj = np.asarray(jax_elu_dropout(jnp.asarray(x.numpy()),
                                    jax.random.PRNGKey(0), rate))
    yp = E.elu_dropout(x, rate, torch.Generator().manual_seed(0)).numpy()
    assert abs((yj == 0).mean() - (yp == 0).mean()) < 0.01
    both = (yj != 0) & (yp != 0)
    np.testing.assert_allclose(yp[both], yj[both], rtol=1e-5, atol=1e-6)


def test_cpu_tensors_never_count_a_launch():
    before = (E.elu_dropout_fwd_launches, E.elu_dropout_bwd_launches)
    x = _x((4, 9)).requires_grad_(True)
    E.elu_dropout(x, 0.5, torch.Generator().manual_seed(0)).sum().backward()
    assert (E.elu_dropout_fwd_launches, E.elu_dropout_bwd_launches) == before


def test_other_devices_raise():
    x = torch.zeros(8, device="meta")
    seed = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no ELU\\+dropout for device"):
        E.elu_dropout_forward(x, seed, 0.5)
