"""The port's dormant flows against the JAX package, on the CPU in f32.

The GIN, NICE and spline (RQS) couplings in an ``UnconditionalFlow``, the
spline itself on knots and in its tails, MADE (bit-equal masks),
``ConditionalFlow`` under each conditioning option, and the concat flow
(``ConditionalTransformer`` over a ``DenseEmbedder`` or an image
``Embedder``), with the ``FeatureLayer`` and ``DenseEncoderLayer`` it is
built from.  Parameters are drawn from a numpy seed for the port and
exported through its converters (``tests/torch_port_dormant.py``); outputs
and logdets agree within a relative L2 of 1e-5, gradients (``jax.grad``
against autograd) within 1e-4, and every converter round-trips its flax
tree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behavior_driven_video_synthesis_tpu.models import flows as jflows
from behavior_driven_video_synthesis_tpu.models.flows import made as jmade
from behavior_driven_video_synthesis_tpu.models.flows import (
    spline as jspline)
from behavior_driven_video_synthesis_tpu.ops import nn as jnn

from behavior_driven_video_synthesis_tpu_torch.models import convert as pconv
from behavior_driven_video_synthesis_tpu_torch.models import flows as pflows
from behavior_driven_video_synthesis_tpu_torch.models.flows import (
    made as pmade)
from behavior_driven_video_synthesis_tpu_torch.models.flows import (
    spline as pspline)
from behavior_driven_video_synthesis_tpu_torch.ops import nn as pnn

from torch_port_dormant import (KEY, assert_plan_round_trip, assert_rel,
                                jitter, load, port_variables, t)
from torch_port_threads import one_torch_thread  # noqa: F401


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape)
            ).astype(np.float32)


def _grads_against_jax(module, variables, loss_jax, loss_torch, inputs,
                       from_flax, tol=1e-4):
    """jax.grad of loss_jax(params, *inputs) against autograd of
    loss_torch(module, *inputs): every parameter and every input."""
    params = variables["params"]
    rest = {k: v for k, v in variables.items() if k != "params"}
    jgrads = jax.jit(jax.grad(
        lambda p, *xs: loss_jax({"params": p, **rest}, *xs),
        argnums=tuple(range(len(inputs) + 1))))(
            params, *[jnp.asarray(x) for x in inputs])
    xs = [t(x).requires_grad_(True) for x in inputs]
    module.zero_grad()
    loss_torch(module, *xs).backward()
    want = from_flax({"params": jgrads[0], **rest})
    for name, p in module.named_parameters():
        assert_rel(p.grad, want[name].numpy(), tol, name)
    for x, g in zip(xs, jgrads[1:]):
        assert_rel(x.grad, g, tol, "input")


# -- UnconditionalFlow with the GIN, NICE and spline couplings ---------------

COUPLINGS = [("gin", 8), ("nice", 7), ("rqs", 7)]


def _tame_splines(flow, factor=0.1):
    """The spline MLPs' last layers scaled by ``factor``.  With weights of
    N(0, 1/fan_in) some bins get slopes near the 1e-3 floor, and a
    multi-flow reverse of f32 codes is then ill-conditioned in both
    packages (at such weights JAX's f32 reverse lay 1.9e-3 from the
    float64 reverse of the same codes); scaled, every slope stays near 1.
    The spline test below holds strong spline parameters elementwise."""
    for block in flow.sub_layers:
        for net in getattr(block.coupling, "nets", ()):
            net.main[-1].weight.mul_(factor)
            net.main[-1].bias.mul_(factor)


@pytest.fixture(scope="module", params=COUPLINGS,
                ids=[f"{c}-{n}" for c, n in COUPLINGS])
def uflow(request):
    kind, c = request.param
    jm = jflows.UnconditionalFlow(c, 24, hidden_depth=1, n_flows=3,
                                  coupling_type=kind)
    x = _x((6, c))
    pm = pflows.UnconditionalFlow(c, 24, hidden_depth=1, n_flows=3,
                                  coupling_type=kind)
    variables = port_variables(pm, pconv.unconditional_flow_to_flax, 1, jm,
                               jnp.asarray(x), prepare=_tame_splines)
    return kind, jm, pm, variables, x


def test_coupling_flow_matches_jax(uflow):
    kind, jm, pm, variables, x = uflow
    apply = jax.jit(jm.apply, static_argnames="reverse")
    jz, jld = apply(variables, jnp.asarray(x))
    jback = apply(variables, jz, reverse=True)
    with torch.no_grad():
        z, ld = pm(t(x))
        back = pm.reverse(t(np.asarray(jz)))
        round_trip = pm.reverse(z)
    assert_rel(z, jz, what="z")
    assert_rel(ld, jld, what="logdet")
    assert_rel(back, jback, what="reverse")
    assert_rel(round_trip, x, 1e-5, "reverse(forward(x))")
    if kind in ("gin", "nice"):     # volume preserving: ActNorm's alone
        scales = [m.norm_layer.scale for m in pm.sub_layers]
        want = sum(float(torch.log(torch.abs(s.detach())).sum())
                   for s in scales)
        np.testing.assert_allclose(ld.numpy(), want, rtol=1e-5)


def test_coupling_flow_plan_round_trips(uflow):
    _, _, _, variables, _ = uflow
    assert_plan_round_trip(variables, pconv.unconditional_flow_from_flax,
                           pconv.unconditional_flow_to_flax)


def test_every_coupling_type_builds():
    assert set(pflows.COUPLING_TYPES) == {"affine", "gin", "nice", "rqs"}
    assert set(pflows.COUPLING_TYPES) == set(jflows.COUPLING_TYPES)
    for kind in pflows.COUPLING_TYPES:
        flow = pflows.UnconditionalFlow(8, 16, 1, 2, coupling_type=kind)
        assert isinstance(flow.sub_layers[0].coupling,
                          pflows.COUPLING_TYPES[kind])
    with pytest.raises(ValueError):
        pflows.GINCoupling(7, 16)


def test_spline_coupling_gradients_match_jax():
    jm = jflows.UnconditionalFlow(6, 16, hidden_depth=1, n_flows=1,
                                  coupling_type="rqs")
    x = _x((5, 6), seed=3, scale=1.5)
    pm = pflows.UnconditionalFlow(6, 16, 1, 1, coupling_type="rqs")
    variables = port_variables(pm, pconv.unconditional_flow_to_flax, 4, jm,
                               jnp.asarray(x), prepare=_tame_splines)
    w = _x((5, 6), seed=5)

    def loss_jax(v, x):
        z, ld = jm.apply(v, x)
        return jnp.sum(z * w) + jnp.sum(ld)

    def loss_torch(m, x):
        z, ld = m(x)
        return torch.sum(z * t(w)) + torch.sum(ld)
    _grads_against_jax(pm, variables, loss_jax, loss_torch, [x],
                       pconv.unconditional_flow_from_flax)


def test_spline_on_knots_and_in_tails():
    """Inputs on every knot (where the bin count flips), at and beyond
    +-tail_bound: the bins, outputs and logdets are JAX's, the tails are
    the identity with logdet 0, and the inverse undoes the forward."""
    rng = np.random.RandomState(7)
    K, D, B = 5, 4, 3
    uw, uh = (rng.standard_normal((B, D, K)).astype(np.float32)
              for _ in range(2))
    ud = rng.standard_normal((B, D, K - 1)).astype(np.float32)
    widths = np.asarray(jax.nn.softmax(jnp.asarray(uw), axis=-1))
    widths = 1e-3 + (1 - 1e-3 * K) * widths
    knots = np.concatenate([np.zeros((B, D, 1), np.float32),
                            np.cumsum(widths, -1)], -1) * 6.0 - 3.0
    x = np.concatenate([knots, np.full((B, D, 4), np.float32(3.0)),
                        np.array([-3.0, -4.5, 4.5, 1e3], np.float32)
                        * np.ones((B, D, 4), np.float32)], -1)
    spline = jax.jit(jspline.rational_quadratic_spline,
                     static_argnames="inverse")
    # one input column at a time: the spline's parameters are per (b, d)
    lds, jlds = [], []
    for j in range(x.shape[-1]):
        xi = x[..., j]
        jy, jld = spline(jnp.asarray(xi), jnp.asarray(uw), jnp.asarray(uh),
                         jnp.asarray(ud))
        y, ld = pspline.rational_quadratic_spline(t(xi), t(uw), t(uh), t(ud))
        assert_rel(y, jy, what=f"knot column {j}")
        lds.append(ld.numpy())
        jlds.append(np.asarray(jld))
        back, _ = pspline.rational_quadratic_spline(y, t(uw), t(uh), t(ud),
                                                    inverse=True)
        jback, _ = spline(jy, jnp.asarray(uw), jnp.asarray(uh),
                          jnp.asarray(ud), inverse=True)
        assert_rel(back, jback, what=f"inverse column {j}")
        np.testing.assert_allclose(back.numpy(), xi, rtol=0, atol=1e-5)
        outside = np.abs(xi) > 3.0
        np.testing.assert_array_equal(y.numpy()[outside], xi[outside])
        assert np.all(ld.numpy()[outside] == 0)
    # On a knot (xi = 0 or 1) the f32 logdet carries its inputs' rounding:
    # there the float64 logdet of the same parameters lies up to 4.8e-5
    # from JAX's f32 logdet and 9.5e-5 from the port's (which may also
    # pick the adjacent bin where the knots differ in the last bit), so
    # the logdets (the rest are at or beyond the tail bound, 0) are held
    # to 1e-4.
    assert_rel(np.stack(lds), np.stack(jlds), 1e-4, "logdet")
    # the bin index counts the knots at or below the input, as JAX does
    cum = t(knots)
    for j in range(K + 1):
        got = pspline._bin_index(cum, cum[..., j]).numpy()
        want = np.asarray(jspline._searchsorted(jnp.asarray(knots),
                                                jnp.asarray(knots[..., j])))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, min(j, K - 1))


# -- MADE ---------------------------------------------------------------------

@pytest.mark.parametrize("nin,hidden,nout,seed,natural", [
    (5, (16, 12), 10, 0, False), (4, (8,), 4, 3, True),
    (6, (12, 12, 9), 18, 11, False)])
def test_made_masks_are_bit_equal(nin, hidden, nout, seed, natural):
    want = jmade._build_masks(nin, list(hidden), nout, seed, natural)
    net = pmade.ARFullyConnectedNet(nin, hidden, nout, seed=seed,
                                    natural_ordering=natural)
    assert len(net.masks) == len(want)
    for got, ref in zip(net.masks, want):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    for layer, ref in zip(net.net, want):
        np.testing.assert_array_equal(layer._mask(torch.device("cpu")).numpy(),
                                      ref.T)


@pytest.mark.parametrize("ncond", [0, 3])
def test_made_matches_jax(ncond):
    jm = jflows.ARFullyConnectedNet(5, (16, 16), 10, ncond=ncond, seed=2)
    x, y = _x((4, 5), 1), _x((4, 3), 2)
    args = (jnp.asarray(x),) + ((jnp.asarray(y),) if ncond else ())
    pm = pflows.ARFullyConnectedNet(5, (16, 16), 10, ncond=ncond, seed=2)
    variables = port_variables(pm, pconv.made_to_flax, 3, jm, *args)
    with torch.no_grad():
        out = pm(t(x), t(y) if ncond else None)
    assert_rel(out, jm.apply(variables, *args))
    assert_plan_round_trip(variables, pconv.made_from_flax,
                           pconv.made_to_flax, params_only=True)
    if not ncond:
        # output unit j (of each nin-wide chunk) sees only the inputs of a
        # lower degree than its own (the degrees: _build_masks' first draw)
        jac = torch.autograd.functional.jacobian(
            lambda v: pm(v[None])[0], t(x[0])).numpy()
        degrees = np.random.RandomState(2).permutation(5)
        for j in range(10):
            assert not jac[j][degrees >= degrees[j % 5]].any()
            assert jac[j][degrees < degrees[j % 5]].all()


# -- ConditionalFlow ----------------------------------------------------------

@pytest.fixture(scope="module", params=["none", "parallel", "sequential"])
def cflow(request):
    opt = request.param
    jm = jflows.ConditionalFlow(7, 5, 16, hidden_depth=1, n_flows=3,
                                conditioning_option=opt)
    x, e = _x((6, 7), 1), _x((6, 5), 2)
    pm = pflows.ConditionalFlow(7, 5, 16, 1, 3, conditioning_option=opt)
    variables = port_variables(pm, pconv.conditional_flow_to_flax, 3, jm,
                               jnp.asarray(x), jnp.asarray(e))
    return opt, jm, pm, variables, x, e


def test_conditional_flow_matches_jax(cflow):
    _, jm, pm, variables, x, e = cflow
    apply = jax.jit(jm.apply, static_argnames="reverse")
    jz, jld = apply(variables, jnp.asarray(x), jnp.asarray(e))
    jback = apply(variables, jz, jnp.asarray(e), reverse=True)
    with torch.no_grad():
        z, ld = pm(t(x), t(e))
        back = pm.reverse(t(np.asarray(jz)), t(e))
        round_trip = pm.reverse(z, t(e))
    assert_rel(z, jz, what="z")
    assert_rel(ld, jld, what="logdet")
    assert_rel(back, jback, what="reverse")
    assert_rel(round_trip, x, 1e-5, "reverse(forward(x))")
    assert_plan_round_trip(variables, pconv.conditional_flow_from_flax,
                           pconv.conditional_flow_to_flax)


def test_conditional_flow_gradients_match_jax():
    jm = jflows.ConditionalFlow(7, 5, 16, hidden_depth=1, n_flows=2,
                                conditioning_option="sequential")
    pm = pflows.ConditionalFlow(7, 5, 16, 1, 2,
                                conditioning_option="sequential")
    x, e = _x((6, 7), 1), _x((6, 5), 2)
    variables = port_variables(pm, pconv.conditional_flow_to_flax, 3, jm,
                               jnp.asarray(x), jnp.asarray(e))
    w = _x((6, 7), 9)

    def loss_jax(v, x, e):
        z, ld = jm.apply(v, x, e)
        return jnp.sum(z * w) + jnp.sum(ld)

    def loss_torch(m, x, e):
        z, ld = m(x, e)
        return torch.sum(z * t(w)) + torch.sum(ld)
    _grads_against_jax(pm, variables, loss_jax, loss_torch, [x, e],
                       pconv.conditional_flow_from_flax)


def test_inv_leaky_relu_reports_zero_logdet():
    x = _x((4, 6), 3)
    y, ld = pflows.InvLeakyRelu()(t(x))
    jy, jld = jflows.InvLeakyRelu().apply({}, jnp.asarray(x))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    assert np.all(ld.numpy() == 0) and np.all(np.asarray(jld) == 0)
    np.testing.assert_allclose(
        pflows.InvLeakyRelu()(y, reverse=True).numpy(), x, rtol=1e-6)


# -- the concat flow (ConditionalTransformer) ---------------------------------

TRANSFORMER_KW = {
    "dense": dict(conditioning_in_channels=5,
                  conditioning_option="parallel"),
    "image": dict(conditioning_spatial_size=16, conditioning_in_channels=3,
                  embedder_down=2, conditioning_option="sequential")}


def _transformer_inputs(kind):
    return _x((4, 6), 1), _x((4, 16, 16, 3) if kind == "image" else (4, 5),
                             2)


@pytest.fixture(scope="module", params=sorted(TRANSFORMER_KW))
def transformer(request):
    kw = TRANSFORMER_KW[request.param]
    jm = jflows.ConditionalTransformer(6, 16, 1, 2, **kw)
    pm = pflows.ConditionalTransformer(6, 16, 1, 2, **kw)
    x, cond = _transformer_inputs(request.param)
    variables = port_variables(pm, pconv.conditional_transformer_to_flax, 4,
                               jm, jnp.asarray(x), jnp.asarray(cond))
    return jm, pm, variables, x, cond


def test_conditional_transformer_matches_jax(transformer):
    jm, pm, variables, x, cond = transformer
    apply = jax.jit(jm.apply, static_argnames="reverse")
    jz, jld = apply(variables, jnp.asarray(x), jnp.asarray(cond))
    jback = apply(variables, jz, jnp.asarray(cond), reverse=True)
    jemb = jm.apply(variables, jnp.asarray(cond), method=jm.embed)
    with torch.no_grad():
        z, ld = pm(t(x), t(cond))
        back = pm.reverse(t(np.asarray(jz)), t(cond))
        emb = pm.embed(t(cond))
        round_trip = pm.reverse(z, t(cond))
    assert_rel(emb, jemb, what="embedding")
    assert_rel(z, jz, what="z")
    assert_rel(ld, jld, what="logdet")
    assert_rel(back, jback, what="reverse")
    assert_rel(round_trip, x, 1e-5, "reverse(forward(x))")
    assert_plan_round_trip(variables, pconv.conditional_transformer_from_flax,
                           pconv.conditional_transformer_to_flax)
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    with torch.no_grad():
        s = pm.sample(g1, (4, 6), t(cond))
        want = pm.reverse(torch.randn(4, 6, generator=g2), t(cond))
    np.testing.assert_array_equal(s.numpy(), want.numpy())


def _assert_same_stats(pm, variables, from_flax, init):
    """Load JAX's init with every loc and scale set to 7, run the port's
    ``init()``: each loc and scale must be JAX's init value again."""
    sd = from_flax(variables)
    stats = [k for k in sd if k.endswith(("loc", "scale"))]
    assert stats
    pm.load_state_dict({k: torch.full_like(v, 7.0) if k in stats else v
                        for k, v in sd.items()}, strict=True)
    init()
    got = pm.state_dict()
    for k in stats:
        np.testing.assert_allclose(got[k].numpy(), sd[k].numpy(),
                                   rtol=2e-5, atol=1e-6, err_msg=k)


def test_data_dependent_init_matches_jax():
    """initialize_ on JAX's init batch gives JAX's data-dependent
    statistics, the other weights carried over from JAX's init: a
    DenseEmbedder's ActNorms, and an image ConditionalTransformer's
    FeatureLayers and flow ActNorms (its embedding on the batch first)."""
    cond = _x((6, 5), 3)
    jd = jflows.DenseEmbedder(5, 12, depth=4)
    pd = pflows.DenseEmbedder(5, 12, depth=4)
    _assert_same_stats(pd, jax.jit(jd.init)(KEY, jnp.asarray(cond)),
                       pconv.dense_embedder_from_flax,
                       lambda: pd.initialize_(t(cond)))
    kw = TRANSFORMER_KW["image"]
    jm = jflows.ConditionalTransformer(6, 16, 1, 1, **kw)
    pm = pflows.ConditionalTransformer(6, 16, 1, 1, **kw)
    x, cond = _transformer_inputs("image")
    _assert_same_stats(pm, jax.jit(jm.init)(KEY, jnp.asarray(x),
                                            jnp.asarray(cond)),
                       pconv.conditional_transformer_from_flax,
                       lambda: pm.initialize_(t(x), t(cond)))


def test_feature_and_dense_encoder_layers_match_jax():
    x = _x((3, 8, 12, 5), 1)
    jf = jnn.FeatureLayer(0, in_channels=5, width_multiplier=0.25)
    fv = jf.init(KEY, jnp.asarray(x))
    pf = pnn.FeatureLayer(0, in_channels=5, width_multiplier=0.25)
    load(pf, pconv.feature_layer_from_flax, jitter(fv, 1, 0.0))
    # the data-dependent init from the first batch
    with torch.no_grad():
        pf.loc.zero_()
        pf.scale.fill_(2.0)
    pf.initialize_(t(x))
    np.testing.assert_allclose(pf.loc.detach().numpy(),
                               np.asarray(fv["params"]["loc"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(pf.scale.detach().numpy(),
                               np.asarray(fv["params"]["scale"]), rtol=2e-5)
    fv = jitter(fv, 2)
    load(pf, pconv.feature_layer_from_flax, fv)
    h = jf.apply(fv, jnp.asarray(x))
    with torch.no_grad():
        assert_rel(pf(t(x)), h, what="FeatureLayer")
    assert_plan_round_trip(fv, pconv.feature_layer_from_flax,
                           pconv.feature_layer_to_flax, params_only=True)
    # a second scale takes the first's width by default
    assert pnn.FeatureLayer(1, width_multiplier=0.25).conv.in_channels == 16

    hn = np.asarray(h)                       # (3, 4, 6, 16) NHWC
    jd = jnn.DenseEncoderLayer(7)
    dv = jitter(jd.init(KEY, h), 3)
    pd = load(pnn.DenseEncoderLayer(4 * 6 * 16, 7),
              pconv.dense_encoder_layer_from_flax, dv)
    with torch.no_grad():
        out = pd(t(hn))
        nchw = pd(t(hn).permute(0, 3, 1, 2).contiguous())
    want = np.asarray(jd.apply(dv, h))
    assert_rel(out, want, what="DenseEncoderLayer")
    # the kernel is laid out over the (H, W, C) flatten: flattening C-major
    # (an NCHW tensor) would give another answer
    assert float(np.abs(nchw.numpy() - want).max()) > 1e-2
    assert_plan_round_trip(dv, pconv.dense_encoder_layer_from_flax,
                           pconv.dense_encoder_layer_to_flax,
                           params_only=True)
