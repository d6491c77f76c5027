"""The PyTorch port's NN primitives (ops/nn.py) against the JAX package.

Each case draws its weights into the port's module with numpy, exports
them as the flax subtree the JAX module reads, and compares both on the
same NHWC input in f32: max abs diff <= 1e-5 * (1 + max|ref|).  The
NormConv2d fold cases hold the folded route against the unfolded one in
the port itself, and the prepared-weights cases hold ``prepared``'s rule
for every owner of kernel weights.
"""
import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from behavior_driven_video_synthesis_tpu.ops import nn as jnn

from behavior_driven_video_synthesis_tpu_torch.models import convert as pconv
from behavior_driven_video_synthesis_tpu_torch.models.behavior import (
    ResidualBehaviorNet)
from behavior_driven_video_synthesis_tpu_torch.models.init import init_random_
from behavior_driven_video_synthesis_tpu_torch.ops import nn as pnn


def _close(out, ref):
    ref = np.asarray(ref, np.float32)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-5 * (1 + np.abs(ref).max()))


def _tree(module, plan):
    """Random weights for ``module`` as the flax subtree that ``plan``
    (whose state-dict keys start with "x.") maps them to."""
    init_random_(module, np.random.RandomState(3))
    return pconv.to_flax(torch.nn.ModuleDict({"x": module}).state_dict(),
                         plan)


def test_space_depth_round_trip_and_order(rng):
    x = rng.randn(2, 4, 6, 8).astype(np.float32)
    s2d = pnn.space_to_depth(torch.from_numpy(x))
    np.testing.assert_array_equal(s2d.numpy(),
                                  np.asarray(jnn.space_to_depth(x)))
    np.testing.assert_array_equal(pnn.depth_to_space(s2d).numpy(), x)
    np.testing.assert_array_equal(
        pnn.depth_to_space(torch.from_numpy(x)).numpy(),
        np.asarray(jnn.depth_to_space(x)))
    # channels factor as (i, j, C'), not PixelShuffle's (C', i, j)
    shuffled = torch.nn.functional.pixel_shuffle(
        torch.from_numpy(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    assert not np.allclose(shuffled.numpy(),
                           pnn.depth_to_space(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("k,stride,pad,aux", [(3, 1, 1, False),
                                              (1, 1, 0, False),
                                              (3, 2, 1, False),
                                              (3, 1, 1, True)])
def test_norm_conv_matches_jax(rng, k, stride, pad, aux):
    cx, ca, cout = 5, 3, 7
    conv = pnn.NormConv2d(cx + (ca if aux else 0), cout, k, stride, pad)
    tree = _tree(conv, pconv._norm_conv("x", ()))
    x = rng.randn(2, 9, 9, cx).astype(np.float32)
    a = rng.randn(2, 9, 9, ca).astype(np.float32) if aux else None
    ref = jnn.NormConv2d(cout, kernel_size=k, stride=stride,
                         padding=pad).apply(
        {"params": tree}, jnp.asarray(x),
        None if a is None else jnp.asarray(a))
    out = conv(torch.from_numpy(x), None if a is None else torch.from_numpy(a))
    assert out.shape == ref.shape
    _close(out, ref)


def test_norm_conv_unported_options_raise():
    """quant, d2s_transpose and Upsample(transpose=True), once refused, are
    ported (``test_torch_quant.py``, ``test_torch_conv_types.py``); what
    the JAX package asserts stays refused: an unknown quant, and
    d2s_transpose off the subpixel conv's shape."""
    pnn.NormConv2d(3, 8, 3, padding=1, quant="int8_static")
    pnn.NormConv2d(3, 16, 3, padding=1, d2s_transpose=True)
    assert pnn.Upsample(3, 4, transpose=True).up.d2s_transpose
    with pytest.raises(ValueError, match="unknown quant"):
        pnn.NormConv2d(3, 4, quant="int4")
    with pytest.raises(ValueError, match="subpixel-upsample conv shape"):
        pnn.NormConv2d(3, 4, d2s_transpose=True)


def test_norm_dense_matches_jax(rng):
    dense = pnn.NormDense(6, 4)
    tree = _tree(dense, pconv._norm_conv("x", (), "dense_v"))
    x = rng.randn(3, 6).astype(np.float32)
    ref = jnn.NormDense(4).apply({"params": tree}, jnp.asarray(x))
    _close(dense(torch.from_numpy(x)), ref)


@pytest.mark.parametrize("residual", [False, True])
def test_vunet_rnb_matches_jax(rng, residual):
    c, ca = 6, 10
    rnb = pnn.VunetRNB(c, residual=residual, aux_channels=ca)
    tree = _tree(rnb, pconv._rnb("x", (), residual))
    x = rng.randn(2, 8, 8, c).astype(np.float32)
    a = rng.randn(2, 8, 8, ca).astype(np.float32) if residual else None
    ref = jnn.VunetRNB(c, residual=residual).apply(
        {"params": tree}, jnp.asarray(x),
        None if a is None else jnp.asarray(a))
    _close(rnb(torch.from_numpy(x), None if a is None
               else torch.from_numpy(a)), ref)


def test_down_and_upsample_match_jax(rng):
    x = rng.randn(2, 8, 8, 6).astype(np.float32)
    down = pnn.Downsample(6, 5)
    tree = _tree(down, pconv._norm_conv("x.down", ("NormConv2d_0",)))
    ref = jnn.Downsample(5).apply({"params": tree}, jnp.asarray(x))
    out = down(torch.from_numpy(x))
    assert out.shape == (2, 4, 4, 5)
    _close(out, ref)
    up = pnn.Upsample(6, 5)
    tree = _tree(up, pconv._norm_conv("x.up", ("NormConv2d_0",)))
    ref = jnn.Upsample(5).apply({"params": tree}, jnp.asarray(x))
    out = up(torch.from_numpy(x))
    assert out.shape == (2, 16, 16, 5)
    _close(out, ref)


@pytest.mark.parametrize("use_tanh,depth", [(True, 2), (False, 1)])
def test_fully_connected_net_matches_jax(rng, use_tanh, depth):
    net = pnn.FullyConnectedNet(5, depth, hidden_dim=12, use_tanh=use_tanh,
                                out_dim=4)
    init_random_(net, rng)
    tree = {f"Dense_{k}": {
        "kernel": net.main[2 * k].weight.detach().numpy().T,
        "bias": net.main[2 * k].bias.detach().numpy()}
        for k in range(depth + 2)}
    x = rng.randn(3, 5).astype(np.float32)
    ref = jnn.FullyConnectedNet(5, depth, hidden_dim=12, use_tanh=use_tanh,
                                out_dim=4).apply({"params": tree},
                                                 jnp.asarray(x))
    _close(net(torch.from_numpy(x)), ref)


def _norm_conv(cin, cout, k, stride=1, pad=0, dtype=torch.float32, seed=3):
    conv = pnn.NormConv2d(cin, cout, k, stride, pad, dtype=dtype)
    init_random_(conv, np.random.RandomState(seed))
    with torch.no_grad():       # an affine away from its init's (1, 0)
        g = torch.Generator().manual_seed(seed)
        conv.gamma.copy_(1 + 0.5 * torch.randn(conv.gamma.shape, generator=g))
        conv.beta.copy_(0.5 * torch.randn(conv.beta.shape, generator=g))
        conv.conv.bias.copy_(0.5 * torch.randn(cout, generator=g))
    return conv


@pytest.mark.parametrize("k,stride,pad,cout", [(3, 1, 1, 7), (1, 1, 0, 16),
                                               (3, 2, 1, 8), (3, 1, 1, 3)])
def test_norm_conv_fold_matches_the_affine(rng, k, stride, pad, cout):
    """conv(x, W') + b' with the folded f32 weights is
    gamma * (conv(x, W) + bias) + beta to 1e-5 of its largest value."""
    conv = _norm_conv(5, cout, k, stride, pad)
    x = torch.from_numpy(rng.randn(2, 9, 9, 5).astype(np.float32))
    w, b = conv.folded()
    assert w.dtype == b.dtype == torch.float32
    with torch.no_grad():
        ref = conv(x)
        out = pnn.conv2d_nhwc(x, w, None, stride, pad) + b
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0,
                               atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_conv_folded_weights_in_the_compute_dtype(dtype):
    """W' = gamma * W in the compute dtype and b' = gamma * bias + beta in
    f32, both from the f32 parameters."""
    conv = _norm_conv(5, 6, 3, pad=1, dtype=dtype)
    w, b = conv.folded()
    assert w.dtype == dtype and b.dtype == torch.float32
    with torch.no_grad():
        gamma = conv.gamma.reshape(-1)
        torch.testing.assert_close(
            w, (conv.kernel() * gamma[:, None, None, None]).to(dtype))
        torch.testing.assert_close(
            b, gamma * conv.conv.bias + conv.beta.reshape(-1))


# -- prepared kernel weights: one cache, four owners --------------------------
#
# An owner, by its slot in prepared_builds: (its module from a seed, its
# prepared weights, the parameter that an in-place update changes).


def _fold_owner(seed):
    return _norm_conv(5, 6, 3, pad=1, seed=seed)


def _int8_owner(seed):
    conv = pnn.NormConv2d(8, 16, 3, padding=1, quant="int8")
    return init_random_(conv, np.random.RandomState(seed))


def _rnb_owner(seed):
    return init_random_(pnn.VunetRNB(8, dtype=torch.bfloat16,
                                     rnb_impl="fused"),
                        np.random.RandomState(seed))


def _decoder_owner(seed):
    return init_random_(ResidualBehaviorNet(5, 16),
                        np.random.RandomState(seed)).decoder


OWNERS = {
    "fold": (_fold_owner, lambda m: m.folded(), lambda m: m.gamma),
    "int8": (_int8_owner, lambda m: m._int8_weights(None),
             lambda m: m.conv.weight_v),
    "fused_rnb": (_rnb_owner, lambda m: m.fused_operands(),
                  lambda m: m.conv.conv.weight_g),
    "rollout": (_decoder_owner, lambda m: m.rollout_operands(),
                lambda m: m.rnn.weight_hh)}


def _load(m, make, param):
    m.load_state_dict(make(9).state_dict())


def _step(m, make, param):
    opt = torch.optim.SGD(m.parameters(), lr=0.1)
    for p in m.parameters():
        p.grad = torch.ones_like(p)
    opt.step()


def _in_place(m, make, param):
    with torch.no_grad():
        param(m).mul_(2)


def _to(m, make, param):
    m.to(torch.float64)


def _compute_dtype(m, make, param):
    m.dtype = torch.bfloat16


CHANGES = {"load_state_dict": _load, "optimizer step": _step,
           "in-place update": _in_place, ".to()": _to,
           "compute dtype": _compute_dtype}


def _tensors(v):
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, (tuple, list)):
        return [t for u in v for t in _tensors(u)]
    return []


@pytest.mark.parametrize("owner,change", [
    (o, c) for o in OWNERS
    for c in ("load_state_dict", "optimizer step", "in-place update", ".to()")]
    + [("fold", "compute dtype"), ("int8", "fan-in split")])
def test_prepared_weights_are_kept_until_their_key_changes(owner, change):
    """Every owner of kernel weights (a NormConv2d's folded and int8
    weights, a fused VunetRNB's packed operands, a ResidualDecoder's
    rollout operands) builds them once through ``prepared`` and keeps
    them; a load_state_dict, an optimizer step, an in-place update of one
    parameter, ``.to()``, and a new extra key (the compute dtype; the
    fan-in split, at which a call with aux input splits W) each rebuild
    them once, into what a fresh module with the new parameters builds;
    prepared_builds counts each build under the owner's slot, and each
    module keeps its own."""
    make, get, param = OWNERS[owner]
    m = make(3)
    n0 = pnn.prepared_builds[owner]
    first = get(m)
    assert get(m) is first
    assert pnn.prepared_builds[owner] == n0 + 1
    if change == "fan-in split":
        get = lambda m: m._int8_weights(3)  # noqa: E731
    else:
        CHANGES[change](m, make, param)
    second = get(m)
    assert second is not first
    assert get(m) is second and pnn.prepared_builds[owner] == n0 + 2
    fresh = copy.deepcopy(m)
    del vars(fresh)["_prepared"]
    want, got = _tensors(get(fresh)), _tensors(second)
    assert len(got) == len(want) > 0
    for u, v in zip(got, want):
        assert u.dtype == v.dtype and torch.equal(u, v)
    other = make(3)
    assert get(other) is not second and get(m) is second


@pytest.mark.parametrize("grad,dtype,cuda,folds", [
    (False, torch.bfloat16, True, True), (False, torch.float16, True, True),
    (True, torch.bfloat16, True, False), (False, torch.float32, True, False),
    (False, torch.bfloat16, False, False)])
def test_norm_conv_folds_only_at_inference_on_the_card(grad, dtype, cuda,
                                                       folds):
    """The folded route's rule: autograd off, a CUDA input, a bf16 or f16
    compute dtype; the int8 and d2s_transpose calls never reach it."""
    class _X:
        is_cuda = cuda
    conv = pnn.NormConv2d(5, 8, 3, padding=1, dtype=dtype)
    with torch.set_grad_enabled(grad):
        assert conv.route(_X()) == ("folded" if folds else "unfolded")


def test_norm_conv_with_grad_is_unfolded_and_trains_its_affine(rng):
    """With autograd on, a call (and a residual block's, which passes its
    input as the residual) computes the unfolded affine, builds no folded
    weights, and gamma and beta receive gradients."""
    conv = _norm_conv(5, 5, 3, pad=1)
    x = torch.from_numpy(rng.randn(2, 6, 6, 5).astype(np.float32))
    n0 = pnn.prepared_builds["fold"]
    out = conv(x, residual=x)
    y = pnn.conv2d_nhwc(x, conv.kernel(), conv.conv.bias, 1, 1)
    ref = x + (conv.gamma.reshape(-1) * y + conv.beta.reshape(-1))
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    out.square().sum().backward()
    assert pnn.prepared_builds["fold"] == n0
    for p in (conv.gamma, conv.beta, conv.conv.weight_v, conv.conv.bias):
        assert p.grad is not None and float(p.grad.abs().sum()) > 0
    rnb = pnn.VunetRNB(5, residual=True, aux_channels=3)
    init_random_(rnb, rng)
    a = torch.from_numpy(rng.randn(2, 6, 6, 3).astype(np.float32))
    out = rnb(x, a)
    out.sum().backward()
    assert rnb.conv.gamma.grad is not None and rnb.conv.beta.grad is not None
    assert pnn.prepared_builds["fold"] == n0


@pytest.mark.parametrize("k,pad,aux,residual", [
    (3, 1, False, False), (3, 1, False, True), (3, 1, True, True),
    (1, 0, False, False), (1, 0, True, True)])
def test_norm_conv_folded_route_matches_the_unfolded(rng, k, pad, aux,
                                                     residual):
    """The folded route (the conv epilogue's plain version on the CPU) in
    bf16 against the unfolded bf16 call, within bf16 rounding; the result
    has the unfolded call's dtype."""
    conv = _norm_conv(8 + (4 if aux else 0), 8, k, 1, pad,
                      dtype=torch.bfloat16)
    x = torch.from_numpy(rng.randn(2, 7, 7, 8).astype(np.float32))
    a = (torch.from_numpy(rng.randn(2, 7, 7, 4).astype(np.float32)).bfloat16()
         if aux else None)
    r = x.bfloat16() if residual else None
    with torch.no_grad():
        ref = conv(x.bfloat16(), a, residual=r)
        out = conv._forward_folded(x.bfloat16(), a, r)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=2e-2 * float(ref.float().abs().max()))


def test_conv_epilogue_plain_in_place_and_refusals(rng):
    """On the CPU the epilogue writes (y + b) + r, summed in f32 and
    rounded once, into y; it refuses f32, a strided y, a bias of another
    width and a residual of another dtype."""
    from behavior_driven_video_synthesis_tpu_torch.ops.cuda import (
        conv_epilogue as CE)
    y = torch.from_numpy(rng.randn(2, 3, 5, 16).astype(np.float32))
    r = torch.from_numpy(rng.randn(2, 3, 5, 16).astype(np.float32))
    b = torch.from_numpy(rng.randn(16).astype(np.float32))
    yb, rb = y.bfloat16(), r.bfloat16()
    ref = ((yb.float() + b) + rb.float()).bfloat16()
    out = CE.conv_epilogue(yb, b, rb)
    assert out is yb
    assert torch.equal(out, ref)
    with pytest.raises(TypeError, match="bfloat16 or float16"):
        CE.conv_epilogue(y, b)
    with pytest.raises(ValueError, match="contiguous"):
        CE.conv_epilogue(yb.transpose(1, 2), b)
    with pytest.raises(ValueError, match="bias"):
        CE.conv_epilogue(yb, b[:8])
    with pytest.raises(ValueError, match="residual"):
        CE.conv_epilogue(yb, b, r)


@pytest.mark.parametrize("bias,residual,half", [
    (False, False, 0), (True, False, 1), (True, True, 1), (True, True, 0)])
def test_conv_epilogue_act_plain_into_a_channel_slice(rng, bias, residual,
                                                      half):
    """On the CPU the activated store writes F.elu(round(y [+ b] [+ r]))
    exactly (y alone, unrounded, without a bias or residual) into one
    channel half of a 2C buffer and leaves the other half untouched; it
    refuses what is not a channel slice of a contiguous NHWC buffer, out
    of y's type, a bias of another width and an out that overlaps y."""
    from behavior_driven_video_synthesis_tpu_torch.ops.cuda import (
        conv_epilogue as CE)
    C = 16
    y = torch.from_numpy(rng.randn(2, 3, 5, C).astype(np.float32)).bfloat16()
    y[0, 0, 0, :2] = torch.tensor([-0.0, 0.0])
    b = (torch.from_numpy(rng.randn(C).astype(np.float32)) if bias
         else None)
    r = (torch.from_numpy(rng.randn(2, 3, 5, C).astype(np.float32))
         .bfloat16() if residual else None)
    s = y.float()
    if b is not None:
        s = (s + b) + (0 if r is None else r.float())
    ref = torch.nn.functional.elu(s.bfloat16() if bias else y)
    buf = torch.full((2, 3, 5, 2 * C), 7.0, dtype=torch.bfloat16)
    n0 = (CE.conv_epilogue_launches, CE.conv_epilogue_act_launches)
    out = CE.conv_epilogue_act(y, buf[..., half * C:(half + 1) * C], b, r)
    assert out.data_ptr() == buf.data_ptr() + half * C * 2
    assert torch.equal(buf[..., half * C:(half + 1) * C], ref)
    assert torch.equal(buf[..., (1 - half) * C:(2 - half) * C],
                       torch.full_like(y, 7.0))
    if not bias:
        assert torch.equal(torch.signbit(out), torch.signbit(ref))
    assert (CE.conv_epilogue_launches, CE.conv_epilogue_act_launches) == n0
    with pytest.raises(ValueError, match="channel slice"):
        CE.conv_epilogue_act(y, buf[..., ::2], b, r)
    with pytest.raises(ValueError, match="channel slice"):
        CE.conv_epilogue_act(
            y, torch.empty(2, 5, 3, 2 * C, dtype=y.dtype)
            .transpose(1, 2)[..., :C], b, r)
    with pytest.raises(ValueError, match="type, shape"):
        CE.conv_epilogue_act(y, buf.float()[..., :C], b, r)
    with pytest.raises(ValueError, match="type, shape"):
        CE.conv_epilogue_act(y, buf[:1, ..., :C], b, r)
    with pytest.raises(TypeError, match="bfloat16 or float16"):
        CE.conv_epilogue_act(y.float(), buf.float()[..., :C])
    with pytest.raises(ValueError, match="bias"):
        CE.conv_epilogue_act(y, buf[..., :C],
                             torch.zeros(C // 2))
    with pytest.raises(ValueError, match="overlaps"):
        CE.conv_epilogue_act(y, y, b, r)
    with pytest.raises(ValueError, match="needs a bias"):
        CE.conv_epilogue(y, None)


def _aux_block(c, ca, seed):
    """A bf16 residual block with auxiliary input whose NormConv2d calls
    take the folded route on the CPU (the conv epilogue's plain
    versions), its affines away from their init's (1, 0)."""
    rnb = pnn.VunetRNB(c, residual=True, aux_channels=ca,
                       dtype=torch.bfloat16)
    init_random_(rnb, np.random.RandomState(seed))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in (rnb.nin, rnb.conv):
            m.gamma.copy_(1 + 0.3 * torch.randn(m.gamma.shape, generator=g))
            m.beta.copy_(0.3 * torch.randn(m.beta.shape, generator=g))
            m.route = lambda x: "folded"
    return rnb


@pytest.mark.parametrize("shape,ca", [((2, 4, 4, 64), 128),
                                      ((3, 16, 16, 32), 32)])
def test_vunet_rnb_concat_free_route_is_bit_equal(rng, shape, ca):
    """A residual block with auxiliary input on the concatenation-free
    route (its 2C conv input written by the activated stores) is
    torch.equal to the concatenating folded route in bf16, at an ed-like
    shape (4x4, aux of skip and latent) and a dd-like one; the route is
    taken only where the call folds, never while training, and on the CPU
    it launches nothing."""
    from behavior_driven_video_synthesis_tpu_torch.ops.cuda import (
        conv_epilogue as CE)
    rnb = _aux_block(shape[-1], ca, seed=shape[1])
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).bfloat16()
    a = torch.from_numpy(rng.randn(*shape[:-1], ca).astype(np.float32))
    n0 = CE.conv_epilogue_act_launches
    with torch.no_grad():
        assert rnb._concat_free(x, a, False)
        assert not rnb._concat_free(x, a, True)
        assert not rnb._concat_free(x.float(), a, False)
        F = torch.nn.functional
        ref = rnb.conv._forward_folded(
            F.elu(x), F.elu(rnb.nin._forward_folded(F.elu(a), None, None)),
            x)
        out = rnb._forward_concat_free(x, a)
        assert torch.equal(rnb(x, a), out)
        rnb._concat_free = lambda *args: False
        assert torch.equal(rnb(x, a), ref)
    assert out.dtype == torch.bfloat16 and torch.equal(out, ref)
    assert CE.conv_epilogue_act_launches == n0
    plain = pnn.VunetRNB(shape[-1], residual=True, aux_channels=ca,
                         dtype=torch.bfloat16)
    with torch.no_grad():
        assert not plain._concat_free(x, a, False)


def _bf16(x):
    return torch.from_numpy(x).bfloat16()


def _jbf16(x):
    return jnp.asarray(x, jnp.bfloat16)


@pytest.mark.parametrize("module,aux,residual", [
    ("conv", False, False), ("conv", True, False), ("conv", False, True),
    ("conv", True, True), ("rnb", False, True), ("rnb", True, True)])
def test_folded_route_matches_jax_in_bf16(rng, module, aux, residual):
    """The folded route on the CPU (the conv epilogue's plain version)
    against the JAX package in bf16: a NormConv2d's ``_forward_folded``,
    with and without aux input and residual, against the flax NormConv2d
    (plus the residual), and a residual block whose NormConv2d calls take
    the folded route against the flax VunetRNB; max abs diff <= 2e-2 *
    (1 + max|ref|)."""
    c, ca = 8, 4
    x = rng.randn(2, 9, 9, c).astype(np.float32)
    a = rng.randn(2, 9, 9, ca).astype(np.float32) if aux else None
    ja = None if a is None else _jbf16(a)
    if module == "conv":
        cout = 6
        conv = pnn.NormConv2d(c + (ca if aux else 0), cout, 3, padding=1,
                              dtype=torch.bfloat16)
        tree = _tree(conv, pconv._norm_conv("x", ()))
        r = rng.randn(2, 9, 9, cout).astype(np.float32) if residual else None
        ref = jnn.NormConv2d(cout, kernel_size=3, padding=1,
                             dtype=jnp.bfloat16).apply(
            {"params": tree}, _jbf16(x), ja)
        if r is not None:
            ref = _jbf16(r) + ref
        with torch.no_grad():
            out = conv._forward_folded(_bf16(x), None if a is None
                                       else _bf16(a),
                                       None if r is None else _bf16(r))
    else:
        rnb = pnn.VunetRNB(c, residual=aux, aux_channels=ca if aux else 0,
                           dtype=torch.bfloat16)
        tree = _tree(rnb, pconv._rnb("x", (), aux))
        for m in rnb.modules():
            if isinstance(m, pnn.NormConv2d):
                m.route = lambda x: "folded"
        n0 = pnn.prepared_builds["fold"]
        ref = jnn.VunetRNB(c, residual=aux, dtype=jnp.bfloat16).apply(
            {"params": tree}, _jbf16(x), ja)
        with torch.no_grad():
            out = rnb(_bf16(x), None if a is None else _bf16(a))
        assert pnn.prepared_builds["fold"] == n0 + (2 if aux else 1)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                               atol=2e-2 * (1 + np.abs(ref).max()))
