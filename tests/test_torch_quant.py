"""The port's int8 serving against the JAX package's, on the CPU.

The int8 conv's plain version (``ops/cuda/conv_int8.py:conv_int8_plain``)
against JAX ``ops/nn.py:_conv_int8``: equal in f32, within 1 bf16 ulp in
bf16 (the epilogue's one rounding).  ``NormConv2d(quant=...)`` with and
without aux, the full-precision rule for 1x1 convs and small heads, and
``quant_max_hw`` mirror JAX ``tests/test_quant.py``.  The VUNet's
``transfer_cached`` under both quant modes, ``calibrate_quant`` (the port's
scales against JAX's ``quant`` collection: rtol 1e-5, f32 rounding of the
maxima), ``BehaviorTransferPipeline.calibrate`` followed by ``generate``,
and the serving CLI's ``--preset`` expansion.  Weights are drawn into the
port's modules with numpy and exported as flax trees; inputs come from
numpy seeds.  Whole networks are held conv by conv on the inputs each
conv got, and end to end to the size of the quantization error (see
"the VUNet" below for why).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from behavior_driven_video_synthesis_tpu import generate as jgenerate
from behavior_driven_video_synthesis_tpu.models import vunet as jvunet
from behavior_driven_video_synthesis_tpu.ops import nn as jnn

from behavior_driven_video_synthesis_tpu_torch import generate as pgenerate
from behavior_driven_video_synthesis_tpu_torch import pipeline as ppipeline
from behavior_driven_video_synthesis_tpu_torch.flax_npz import flatten_tree
from behavior_driven_video_synthesis_tpu_torch.models import convert as pconv
from behavior_driven_video_synthesis_tpu_torch.models.init import init_random_
from behavior_driven_video_synthesis_tpu_torch.models.vunet import (
    VUNet, calibrate_quant)
from behavior_driven_video_synthesis_tpu_torch.ops import nn as pnn
from behavior_driven_video_synthesis_tpu_torch.ops.cuda import conv_int8 as ci8

from torch_port_slice import (B, T, camera_args, jax_noise, jax_pipeline,
                              make_slice, port_pipeline)
from torch_port_threads import one_torch_thread  # noqa: F401

S, NF0, NF1 = 32, 8, 16
# a conv's scale against the JAX conv's on the same input
SCALE_RTOL = 1e-5


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    return np.asarray(jnp.asarray(v, jnp.float32))


def _rel_l2(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def _bf16_ulp_ok(out, ref):
    """|out - ref| <= 1 bf16 ulp of ref, elementwise."""
    ref = _np(ref)
    ulp = np.spacing(np.abs(ref).astype(np.float32)) * 2.0 ** 16
    return bool(np.all(np.abs(_np(out) - ref) <= np.maximum(ulp, 1e-30)))


# -- the int8 conv's plain version --------------------------------------------

def _conv_inputs(seed, cin=12, cout=20, hw=11, scale=3.0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, hw, hw, cin) * scale).astype(np.float32)
    w = rng.randn(3, 3, cin, cout).astype(np.float32)          # HWIO
    b = rng.randn(cout).astype(np.float32)
    return x, w, b


def _port_conv(x, w, b, stride, dtype):
    jdt = getattr(jnp, str(dtype).split(".")[-1])
    xt = torch.from_numpy(_np(jnp.asarray(x, jdt))).to(dtype)
    w_q, aw = ci8.quantize_weight(torch.from_numpy(w).permute(3, 2, 0, 1))
    bt = None if b is None else torch.from_numpy(b)
    return ci8.conv_int8(xt, w_q, aw, ci8.act_scale(xt), bt, stride)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("bias", [True, False])
def test_conv_int8_plain_matches_jax(dtype, stride, bias):
    x, w, b = _conv_inputs(stride + 2 * bias)
    b = b if bias else None
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jnn._conv_int8(jnp.asarray(x, jdt), jnp.asarray(w),
                         None if b is None else jnp.asarray(b), stride, 1,
                         jdt)
    out = _port_conv(x, w, b, stride, tdt)
    assert out.dtype == tdt and out.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_array_equal(_np(out), _np(ref))
    else:
        assert _bf16_ulp_ok(out, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_int8_rounds_half_to_even(dtype):
    """max|x| = 127 makes 127 / ax exactly 1, so x * inv lands on .5
    where x does: round half to even (0.5 -> 0, 1.5 -> 2, 2.5 -> 2), as
    jnp.round does, both in the quantized values and in the conv."""
    halves = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.0],
                      np.float32)
    rng = np.random.RandomState(7)
    x = rng.choice(halves, size=(1, 6, 6, 8)).astype(np.float32)
    x[0, 0, 0, 0] = 127.0
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    xt = torch.from_numpy(x).to(tdt)
    q = ci8.quantize_act(xt, ci8.act_scale(xt))
    np.testing.assert_array_equal(_np(q), np.round(x))      # numpy: even
    assert set(np.unique(_np(q)[np.isin(x, halves[:6])])) <= {
        0.0, 2.0, -2.0}
    w = rng.randn(3, 3, 8, 8).astype(np.float32)
    ref = jnn._conv_int8(jnp.asarray(x, jdt), jnp.asarray(w), None, 1, 1,
                         jdt)
    out = _port_conv(x, w, None, 1, tdt)
    if dtype == "float32":
        np.testing.assert_array_equal(_np(out), _np(ref))
    else:
        assert _bf16_ulp_ok(out, ref)


def test_conv_int8_accumulators_are_exact():
    """The float64 conv of the int8 values gives the int32 sums exactly:
    equal to an integer conv computed with numpy."""
    x, w, _ = _conv_inputs(5, cin=8, cout=8, hw=6)
    xt = torch.from_numpy(x)
    ax = ci8.act_scale(xt)
    w_q, aw = ci8.quantize_weight(torch.from_numpy(w).permute(3, 2, 0, 1))
    acc = ci8.conv_int8_plain(xt, w_q, aw, ax, accumulators=True)
    xq = np.pad(ci8.quantize_act(xt, ax).numpy().astype(np.int64),
                ((0, 0), (1, 1), (1, 1), (0, 0)))
    wq = w_q.numpy().astype(np.int64)                   # (O, I, 3, 3)
    ref = sum(np.einsum("bhwi,oi->bhwo", xq[:, i:i + 6, j:j + 6],
                        wq[:, :, i, j]) for i in range(3) for j in range(3))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), ref)


# -- NormConv2d with quant ----------------------------------------------------

def _norm_conv_pair(cin, features, k, pad, seed=3, **kw):
    conv = pnn.NormConv2d(cin, features, k, padding=pad, **kw)
    init_random_(conv, np.random.RandomState(seed))
    tree = pconv.to_flax(torch.nn.ModuleDict({"x": conv}).state_dict(),
                         pconv._norm_conv("x", ()))
    return conv, tree


@pytest.mark.parametrize("quant", ["int8", "int8_static"])
@pytest.mark.parametrize("aux", [False, True])
def test_norm_conv_quant_matches_jax(quant, aux):
    cx, ca, cout = 8, 4, 16
    conv, tree = _norm_conv_pair(cx + (ca if aux else 0), cout, 3, 1,
                                 quant=quant)
    rng = np.random.RandomState(5)
    x = rng.randn(2, 8, 8, cx).astype(np.float32)
    a = (rng.randn(2, 8, 8, ca) * 4).astype(np.float32) if aux else None
    jm = jnn.NormConv2d(cout, kernel_size=3, padding=1, quant=quant)
    args = (jnp.asarray(x), None if a is None else jnp.asarray(a))
    targs = (torch.from_numpy(x), None if a is None else torch.from_numpy(a))
    variables = {"params": tree}
    if quant == "int8_static":
        _, mut = jm.apply(variables, *args, mutable=["quant"])
        variables = {**variables, **mut}
        with pnn.quant_calibration(conv):
            conv(*targs)
        q = flatten_tree(jax.tree_util.tree_map(np.asarray, mut["quant"]))
        assert set(q) == ({"ax", "ax_aux"} if aux else {"ax"})
        for k, v in q.items():
            np.testing.assert_allclose(float(conv.act_amax[k]), v,
                                       rtol=SCALE_RTOL)
    ref = jm.apply(variables, *args)
    with torch.no_grad():
        out = conv(*targs)
    # one conv: equal up to the f32 rounding of the weight norm
    np.testing.assert_allclose(_np(out), _np(ref), rtol=0,
                               atol=1e-5 * (1 + np.abs(_np(ref)).max()))
    plain = pnn.NormConv2d(cx + (ca if aux else 0), cout, 3, padding=1)
    plain.load_state_dict(conv.state_dict())
    with torch.no_grad():
        full = plain(*targs)
    assert 0 < _rel_l2(out, full) < 0.05
    assert conv.state_dict().keys() == plain.state_dict().keys()


# kernel sizes and paddings the int8 kernel does not take: the plain
# version on the CPU, F.unfold + torch._int_mm on the card
ANY_KERNEL = [(5, 2), (7, 3), (3, 0)]


@pytest.mark.parametrize("k,pad", ANY_KERNEL)
@pytest.mark.parametrize("quant", ["int8", "int8_static"])
@pytest.mark.parametrize("aux", [False, True])
def test_norm_conv_quant_any_kernel_matches_jax(k, pad, quant, aux):
    """A quantized NormConv2d of any kernel size and padding (JAX
    ``_conv_int8`` takes them all) equals JAX's within 1e-5 * (1 +
    max|ref|): one conv, the f32 rounding of the weight norm."""
    cx, ca, cout = 8, 4, 16
    conv, tree = _norm_conv_pair(cx + (ca if aux else 0), cout, k, pad,
                                 quant=quant)
    rng = np.random.RandomState(7)
    x = rng.randn(2, 9, 9, cx).astype(np.float32)
    a = (rng.randn(2, 9, 9, ca) * 4).astype(np.float32) if aux else None
    jm = jnn.NormConv2d(cout, kernel_size=k, padding=pad, quant=quant)
    args = (jnp.asarray(x), None if a is None else jnp.asarray(a))
    targs = (torch.from_numpy(x), None if a is None else torch.from_numpy(a))
    variables = {"params": tree}
    if quant == "int8_static":
        _, mut = jm.apply(variables, *args, mutable=["quant"])
        variables = {**variables, **mut}
        with pnn.quant_calibration(conv):
            conv(*targs)
    assert conv.route(targs[0]) == "int8"
    ref = jm.apply(variables, *args)
    with torch.no_grad():
        out = conv(*targs)
    assert out.shape == tuple(ref.shape) == (2, 9 + 2 * pad - k + 1,
                                             9 + 2 * pad - k + 1, cout)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=0,
                               atol=1e-5 * (1 + np.abs(_np(ref)).max()))
    plain = pnn.NormConv2d(cx + (ca if aux else 0), cout, k, padding=pad)
    plain.load_state_dict(conv.state_dict())
    with torch.no_grad():
        assert 0 < _rel_l2(out, plain(*targs)) < 0.05


@pytest.mark.parametrize("k,pad,stride", [
    (k, pad, 1) for k, pad in ANY_KERNEL] + [(3, 1, 3), (5, 2, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unfold_route_equals_the_plain_version(k, pad, stride, dtype):
    """The library route (``conv_int8_unfold``: F.unfold and one int8 GEMM,
    its operands padded to what cuBLASLt takes) gives the plain version's
    int32 sums and outputs, with aux and the affine; on the CPU it counts
    no call of the card's route."""
    g = torch.Generator().manual_seed(k * 10 + pad)
    cin, ca, n = 5, 3, 11
    x = (torch.randn(2, 10, 9, cin, generator=g) * 3).to(dtype)
    aux = (torch.randn(2, 10, 9, ca, generator=g) * 2).to(dtype)
    w_q, aw = ci8.quantize_weight(torch.randn(n, cin, k, k, generator=g))
    aux_w_q, aux_aw = ci8.quantize_weight(torch.randn(n, ca, k, k,
                                                      generator=g))
    kw = dict(padding=pad, aux=aux, aux_w_q=aux_w_q, aux_aw=aux_aw,
              ax_aux=ci8.act_scale(aux),
              gamma=torch.randn(n, generator=g),
              beta=torch.randn(n, generator=g))
    args = (x, w_q, aw, ci8.act_scale(x), torch.randn(n, generator=g),
            stride)
    calls = ci8.conv_int8_unfold_calls
    sums = ci8.conv_int8_unfold(*args, accumulators=True, **kw)
    ref_sums = ci8.conv_int8_plain(*args, accumulators=True, **kw)
    for u, v in zip(sums, ref_sums):
        assert u.dtype == torch.int32 and torch.equal(u, v)
    out = ci8.conv_int8_unfold(*args, **kw)
    assert torch.equal(out, ci8.conv_int8_plain(*args, **kw))
    assert out.dtype == dtype
    assert ci8.conv_int8_unfold_calls == calls
    assert ci8.kernel_takes(3, 1, 2) and not ci8.kernel_takes(k, pad, 3)


@pytest.mark.parametrize("features,k,pad", [(8, 1, 0), (3, 3, 1)])
def test_small_heads_stay_full_precision(features, k, pad):
    """1x1 convs and heads of fewer than 8 features do not quantize: bit
    for bit the full-precision conv (JAX tests/test_quant.py:74-87)."""
    conv, _ = _norm_conv_pair(4, features, k, pad, quant="int8_static")
    plain = pnn.NormConv2d(4, features, k, padding=pad)
    plain.load_state_dict(conv.state_dict())
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 8, 8, 4)
                         .astype(np.float32))
    assert conv.route(x) != "int8"
    with torch.no_grad(), pnn.quant_calibration(conv):
        torch.testing.assert_close(conv(x), plain(x), rtol=0, atol=0)
    assert conv.act_amax == {}


@pytest.mark.parametrize("hw,max_hw,quantizes", [(16, 8, False),
                                                 (8, 8, True),
                                                 (16, 0, True)])
def test_quant_max_hw_gates_by_input_height(hw, max_hw, quantizes):
    """JAX tests/test_quant.py:265-290: above quant_max_hw a conv is bit
    for bit the full-precision one; at or below it (or with no limit) it
    quantizes, as the JAX conv does."""
    conv, tree = _norm_conv_pair(8, 16, 3, 1, seed=7, quant="int8",
                                 quant_max_hw=max_hw)
    plain = pnn.NormConv2d(8, 16, 3, padding=1)
    plain.load_state_dict(conv.state_dict())
    x = np.random.RandomState(7).randn(2, hw, hw, 8).astype(np.float32)
    with torch.no_grad():
        yq, yf = conv(torch.from_numpy(x)), plain(torch.from_numpy(x))
    ref = jnn.NormConv2d(16, kernel_size=3, padding=1, quant="int8",
                         quant_max_hw=max_hw).apply({"params": tree},
                                                    jnp.asarray(x))
    assert (conv.route(torch.from_numpy(x)) == "int8") == quantizes
    assert (not torch.equal(yq, yf)) == quantizes
    np.testing.assert_allclose(_np(yq), _np(ref), rtol=0,
                               atol=1e-5 * (1 + np.abs(_np(ref)).max()))


def test_int8_weights_are_built_once_per_parameter_version():
    conv, _ = _norm_conv_pair(8, 16, 3, 1, quant="int8")
    x = torch.randn(1, 6, 6, 8)
    before = pnn.prepared_builds["int8"]
    with torch.no_grad():
        conv(x)
        conv(x)
        assert pnn.prepared_builds["int8"] == before + 1
        conv.conv.weight_v.mul_(2.0)
        conv(x)
    assert pnn.prepared_builds["int8"] == before + 2


# -- the VUNet ----------------------------------------------------------------
#
# Upstream of a quantizer the packages differ by f32 rounding.  A value
# within that rounding of a boundary of the int8 grid quantizes one step
# apart in the two, and downstream such a step moves further values across
# boundaries, so a whole quantized network may differ from JAX's by noise
# of the quantization's own size.  The networks are therefore held two
# ways: every int8 conv on the very inputs it got in the port's run
# against the JAX conv (exact up to the weight norm's f32 rounding, which
# may move one weight by one int8 step: CONV_ATOL), and the outputs to
# less than JAX's own int8-versus-full-precision error, with the scales
# within SCALE_NET_RTOL of JAX's calibration.
SCALE_NET_RTOL = 1e-2


def _conv_atol(ref, ax, aw):
    """1e-5 (1 + max|ref|), plus one int8 step of one weight times the
    largest int8 activation: ax * max(aw) / 127."""
    return 1e-5 * (1 + float(np.abs(_np(ref)).max())) + \
        float(ax) * float(aw.max()) / 127.0


def _subtree(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def check_int8_convs_in_place(net, tree, run):
    """Run ``run()`` with every quantized NormConv2d of ``net`` recorded;
    hold each conv that ran int8 against the JAX NormConv2d on the same
    inputs, parameters and (int8_static) stored scales, plus the residual
    a residual block passed it.  Returns how many were held."""
    calls = []
    hooks = [m.register_forward_hook(
        lambda mod, args, kwargs, out, name=name: calls.append(
            (name, mod, args[0], args[1] if len(args) > 1
             else kwargs.get("aux"), kwargs.get("residual"), out)),
        with_kwargs=True)
        for name, m in net.named_modules()
        if isinstance(m, pnn.NormConv2d) and m.quant != "none"]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    paths = pconv._quant_paths(net)
    held = 0
    for name, mod, x, aux, residual, out in calls:
        if mod.route(x) != "int8":
            continue
        variables = {"params": _subtree(tree, paths[name])}
        if mod.quant == "int8_static":
            variables["quant"] = {k: jnp.asarray(_np(v))
                                  for k, v in mod.act_amax.items()}
        jm = jnn.NormConv2d(mod.features, kernel_size=3, stride=mod.stride,
                            padding=1, quant=mod.quant)
        ref = jm.apply(variables, jnp.asarray(_np(x)),
                       None if aux is None else jnp.asarray(_np(aux)))
        ax = ci8.act_scale(x) if mod.quant == "int8" else mod.act_amax["ax"]
        _, aw = ci8.quantize_weight(mod.kernel()[:, :x.shape[-1]])
        atol = _conv_atol(ref, ax, aw)
        if residual is not None:
            ref = _np(residual) + _np(ref)
        np.testing.assert_allclose(_np(out), _np(ref), rtol=0, atol=atol,
                                   err_msg=name)
        held += 1
    return held


@pytest.fixture(scope="module", params=["alter", "org"])
def vunets(request):
    """One set of weights and inputs for the small VUNet of a variant,
    with the JAX models built once for the module."""
    variant = request.param
    rng = np.random.RandomState(11)
    kw = dict(spatial_size=S, nf_start=NF0, nf_max=NF1, variant=variant)
    net = VUNet(**kw)
    init_random_(net, rng)
    net.eval()
    to_flax = (pconv.vunet_org_to_flax if variant == "org"
               else pconv.vunet_alter_to_flax)
    tree = to_flax(net.state_dict())
    x = (rng.rand(B, S, S, 3) * 2 - 1).astype(np.float32)
    c = (rng.rand(B * 2, S, S, 3) * 2 - 1).astype(np.float32)
    with torch.no_grad():
        means, _ = net.encode_means(torch.from_numpy(x),
                                    generator=torch.Generator())
    means = [np.repeat(m.numpy(), 2, axis=0) for m in means]
    jax_models = {q: jvunet.VUNet(**kw, quant=q)
                  for q in ("none", "int8", "int8_static")}
    full = _jax_apply(dict(jax=jax_models), "none", {"params": tree}, means,
                      c)
    return dict(kw=kw, net=net, tree=tree, means=means, c=c,
                jax=jax_models, variant=variant, full=full)


def _port_net(v, **kw):
    net = VUNet(**v["kw"], **kw)
    net.load_state_dict(v["net"].state_dict())
    return net.eval()


def _jax_apply(v, quant, variables, means, c, **kw):
    # the JAX org transfer_cached asks for a "sample" rng (ROADMAP C3)
    m = v["jax"][quant]
    return m.apply(variables, [jnp.asarray(a) for a in means],
                   jnp.asarray(c), rngs={"sample": jax.random.PRNGKey(0)},
                   method=m.transfer_cached, **kw)


def _jax_calibrate(v, variables, means, c):
    _, mut = _jax_apply(v, "int8_static", variables, means, c,
                        mutable=["quant"])
    return {**variables, **mut}


def _inputs(v):
    return [torch.from_numpy(m) for m in v["means"]], torch.from_numpy(v["c"])


def _check_net_output(out, ref, full, port_full):
    """The port's int8 frames differ from JAX's by less than JAX's int8
    frames differ from its full-precision ones, and the port's own
    quantization error is of the same size as JAX's."""
    q_err = _rel_l2(ref, full)
    assert _rel_l2(out, ref) < q_err
    assert 0.5 < _rel_l2(out, port_full) / q_err < 2.0


def test_vunet_transfer_cached_int8_matches_jax(vunets):
    v = vunets
    net = _port_net(v, quant="int8")
    means, c = _inputs(v)
    outs = []

    def run():
        with torch.no_grad():
            outs.append(net.transfer_cached(means, c))
    assert check_int8_convs_in_place(net, v["tree"], run) > 10
    ref = _jax_apply(v, "int8", {"params": v["tree"]}, v["means"], v["c"])
    with torch.no_grad():
        port_full = v["net"].transfer_cached(means, c)
    _check_net_output(outs[0], ref, v["full"], port_full)


def _check_scales(mine, ref, rtol):
    mine = flatten_tree(mine)
    ref = flatten_tree(jax.tree_util.tree_map(np.asarray, ref))
    assert set(mine) == set(ref) and len(ref) > 10
    for k in ref:
        np.testing.assert_allclose(mine[k], ref[k], rtol=rtol, err_msg=k)


def test_calibrate_quant_matches_jax_and_serves(vunets):
    """Each conv's calibrated scale is the JAX conv's on the same input
    (f32 rounding), the set of calibrated convs is JAX's (org: the prior's
    convs too), serving with them holds as transfer_cached does, and
    JAX's own scales, handed to the port, serve as well."""
    v = vunets
    net = _port_net(v, quant="int8_static")
    means, c = _inputs(v)
    calls = []
    hooks = [m.register_forward_hook(
        lambda mod, args, kwargs, out, name=name: calls.append(
            (name, mod, [args[0], args[1] if len(args) > 1
                         else kwargs.get("aux")])), with_kwargs=True)
        for name, m in net.named_modules()
        if isinstance(m, pnn.NormConv2d) and m.quant != "none"]
    scales = calibrate_quant(net, means, c)
    for h in hooks:
        h.remove()
    paths = pconv._quant_paths(net)
    for name, mod, args in calls:
        if mod.route(args[0]) != "int8":
            continue
        jm = jnn.NormConv2d(mod.features, kernel_size=3, stride=mod.stride,
                            padding=1, quant="int8_static")
        _, mut = jm.apply({"params": _subtree(v["tree"], paths[name])},
                          *(None if a is None else jnp.asarray(_np(a))
                            for a in args), mutable=["quant"])
        for k, ref in mut["quant"].items():
            np.testing.assert_allclose(float(scales[f"{name}.{k}"]),
                                       float(ref), rtol=SCALE_RTOL,
                                       err_msg=name)
    cal = _jax_calibrate(v, {"params": v["tree"]}, v["means"], v["c"])
    _check_scales(pconv.quant_to_flax(net, scales), cal["quant"],
                  SCALE_NET_RTOL)
    ref = _jax_apply(v, "int8_static", cal, v["means"], v["c"])
    with torch.no_grad():
        port_full = v["net"].transfer_cached(means, c)
    outs = []

    def run():
        with torch.no_grad():
            outs.append(net.transfer_cached(means, c))
    assert check_int8_convs_in_place(net, v["tree"], run) > 10
    _check_net_output(outs[0], ref, v["full"], port_full)
    pnn.load_quant_scales(net, pconv.quant_from_flax(net, cal["quant"]))
    assert check_int8_convs_in_place(net, v["tree"], run) > 10
    _check_net_output(outs[1], ref, v["full"], port_full)


def test_calibration_is_a_running_max(vunets):
    """A second pass over a smaller batch keeps every scale (JAX
    tests/test_quant.py:197-209), as JAX's second pass does."""
    v = vunets
    net = _port_net(v, quant="int8_static")
    means, c = _inputs(v)
    first = calibrate_quant(net, means, c)
    second = calibrate_quant(net, [m * 0.5 for m in means], c * 0.5)
    assert first.keys() == second.keys()
    for k in first:
        assert float(second[k]) >= float(first[k])
    cal = _jax_calibrate(v, {"params": v["tree"]}, v["means"], v["c"])
    cal2 = _jax_calibrate(v, cal, [m * 0.5 for m in v["means"]],
                          v["c"] * 0.5)
    _check_scales(pconv.quant_to_flax(net, second), cal2["quant"],
                  SCALE_NET_RTOL)
    # a serve without calibrated scales refuses instead of dividing by 0
    pnn.load_quant_scales(net, {})
    with pytest.raises(RuntimeError, match="calibrate"):
        with torch.no_grad():
            net.transfer_cached(means, c)


def test_encode_path_stays_full_precision(vunets):
    """eu and ed run once a video and are not quantized: encode_means is
    bit for bit the full-precision VUNet's."""
    v = vunets
    net = _port_net(v, quant="int8")
    x = torch.from_numpy(np.random.RandomState(2).rand(B, S, S, 3)
                         .astype(np.float32))
    with torch.no_grad():
        a, _ = net.encode_means(x, generator=torch.Generator())
        b, _ = v["net"].encode_means(x, generator=torch.Generator())
    for m, n in zip(a, b):
        torch.testing.assert_close(m, n, rtol=0, atol=0)


# -- the pipeline and the CLI -------------------------------------------------

def test_pipeline_calibrate_then_generate_matches_jax():
    """pipe.calibrate then generate, in both packages, on the small slice
    with an int8_static VUNet: the same convs calibrated, each scale within
    SCALE_NET_RTOL, and frames that differ from JAX's by less than JAX's
    int8 frames differ from its full-precision ones."""
    trees, inputs, noise = make_slice(0)
    kw = {"quant": "int8_static"}
    pipe = port_pipeline(trees, inputs, vunet_kw=kw)
    pipe.vunet.eval()
    eps = [torch.from_numpy(n) for n in noise]
    args = (inputs["z"], inputs["x_start"], *camera_args(inputs))
    scales = pipe.calibrate(*args, length=T, eps=eps)
    out = pipe.generate(*args, length=T, eps=eps, quant_scales=scales)
    full_pipe = port_pipeline(trees, inputs)
    port_full = full_pipe.generate(*args, length=T, eps=eps)
    jpipe = jax_pipeline(inputs=inputs, vunet_kw=kw)
    key = jax.random.PRNGKey(0)
    jargs = (jnp.asarray(inputs["z"]), jnp.asarray(inputs["x_start"]),
             *(jnp.asarray(a) for a in camera_args(inputs)), key)
    with jax_noise(noise):
        jq = jpipe.calibrate(trees, *jargs, length=T)
        ref = jpipe.generate({**trees, "vunet_quant": jq}, *jargs,
                             length=T)
        full = jax_pipeline(inputs=inputs).generate(trees, *jargs, length=T)
    _check_scales(pconv.quant_to_flax(pipe.vunet, scales), jq,
                  SCALE_NET_RTOL)
    _check_net_output(out["frames"], ref["frames"], full["frames"],
                      port_full["frames"])


def test_pipeline_calibrates_in_chunks_without_padding(monkeypatch):
    """Where one call would not fit the device, the pass runs in chunks
    (here 2 of 6 frames, no padded frame); a chunk quantizes with its own
    maxima, so the scales may differ from the one-call pass downstream,
    but never exceed the batch's own first-layer maxima."""
    trees, inputs, noise = make_slice(0)
    eps = [torch.from_numpy(n) for n in noise]
    args = (inputs["z"], inputs["x_start"], *camera_args(inputs))
    one = port_pipeline(trees, inputs, vunet_kw={"quant": "int8_static"})
    chunked = port_pipeline(trees, inputs, vunet_chunk=T,
                            vunet_kw={"quant": "int8_static"})
    a = one.calibrate(*args, length=T, eps=eps)
    monkeypatch.setattr(ppipeline, "calibration_fits", lambda *_: False)
    b = chunked.calibrate(*args, length=T, eps=eps)
    assert a.keys() == b.keys()
    # du's first int8 conv reads the stickman: the same maximum either way
    first = next(k for k in a if k.startswith("du."))
    assert float(a[first]) == float(b[first])
    rel = max(abs(float(a[k]) - float(b[k])) / float(a[k]) for k in a)
    assert rel < 0.5


def test_calibration_memory_rule():
    """One call off CUDA, as the JAX package calibrates; the estimate
    counts du's block outputs: two per scale, each scale half the size."""
    vunet = VUNet(spatial_size=16, nf_start=4, nf_max=8, device="meta")
    stick = torch.zeros(5, 16, 16, 3)
    chans = vunet.du.out_channels
    sizes = [16 // 2 ** (j // 2) for j in range(len(chans))]
    want = 5 * 4 * sum(c * s * s for c, s in zip(chans, sizes))
    assert ppipeline.calibration_skip_bytes(vunet, stick) == want
    assert ppipeline.calibration_fits(vunet, stick)


@pytest.mark.parametrize("flags,expect", [
    ([], ("none", 0)),
    (["--preset", "tpu-serving"], ("int8_static", 128)),
    (["--preset", "tpu-serving", "--quant", "none"], ("none", 128)),
    (["--preset", "tpu-serving", "--quant_max_hw", "0"],
     ("int8_static", 0)),
    (["--preset", "tpu-serving", "--quant_max_hw", "64"],
     ("int8_static", 64)),
    (["--quant", "int8_static"], ("int8_static", 0)),
])
def test_cli_preset_expansion_matches_jax(flags, expect):
    """--preset tpu-serving means --quant int8_static --quant_max_hw 128;
    explicit flags win; the same as the JAX CLI's."""
    mine = pgenerate.parse_args(["--behavior_params", "b.npz",
                                 "--synth_params", "s.npz", "--device",
                                 "cpu", *flags])
    ref = jgenerate.parse_args(["--behavior_model", "b", "--synth_model",
                                "s", *flags])
    assert (mine.quant, mine.quant_max_hw) == expect
    assert (ref.quant, ref.quant_max_hw) == expect
    assert mine.upsample == ref.upsample == "subpixel"
