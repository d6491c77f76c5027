"""The port's RIM against the JAX package, on the CPU in f32.

``RIMCell`` (LSTM and GRU) and ``RIM`` (several layers, bidirectional)
with numpy-seeded parameters exported through the port's converters:
outputs and states within a relative L2 of 1e-5, gradients (``jax.grad``
against autograd) within 1e-4.  Also: ties in the top-k choice go to the
lower unit, as ``jax.lax.top_k`` picks; inactive units keep their state
and get no gradient through their new state; the layout (the null input,
head-averaged values, the comm value size forced to the hidden size, the
reverse direction flipped back); initial states drawn from a generator.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from behavior_driven_video_synthesis_tpu.models import rim as jrim

from behavior_driven_video_synthesis_tpu_torch.models import convert as pconv
from behavior_driven_video_synthesis_tpu_torch.models import rim as prim

from torch_port_dormant import (assert_plan_round_trip, assert_rel,
                                port_variables, t)
from torch_port_threads import one_torch_thread  # noqa: F401

IN, H, N, K = 6, 8, 4, 2
CELL_KW = dict(input_key_size=8, input_value_size=10, input_query_size=8,
               num_input_heads=2, comm_key_size=4, comm_query_size=4,
               num_comm_heads=2)


def _x(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _fan_in(module):
    """GroupDense weights at N(0, 1/din), as ``init_random_`` gives a
    Linear (it scales a 3-d weight by all its trailing dims)."""
    for m in module.modules():
        if isinstance(m, prim.GroupDense):
            m.w.mul_(float(np.sqrt(m.w.shape[-1])))


def _assert_grads(pm, want, xs, jgrads):
    """Every parameter's and input's gradient within 1e-4 of JAX's.  A
    key bias shifts both keys (x and null) alike, so the input softmax
    does not see it, and the top-k mask takes no gradient: its true
    gradient is 0, and both packages give rounding noise, held to 1e-6."""
    for name, p in pm.named_parameters():
        if name.endswith("key_net.bias"):
            assert float(p.grad.abs().max()) <= 1e-6, name
            assert float(np.abs(want[name].numpy()).max()) <= 1e-6, name
        else:
            assert_rel(p.grad, want[name].numpy(), 1e-4, name)
    for a, g in zip(xs, jgrads):
        assert_rel(a.grad, g, 1e-4, "input")


def _cell_args(rnn, seed=0, b=3):
    x, h = _x((b, IN), seed), _x((b, N, H), seed + 1)
    c = _x((b, N, H), seed + 2) if rnn == "LSTM" else None
    return x, h, c


@pytest.fixture(scope="module", params=["LSTM", "GRU"])
def cell(request):
    rnn = request.param
    jm = jrim.RIMCell(IN, H, N, K, rnn_cell=rnn, **CELL_KW)
    pm = prim.RIMCell(IN, H, N, K, rnn_cell=rnn, **CELL_KW)
    x, h, c = _cell_args(rnn)
    jargs = [jnp.asarray(a) for a in (x, h, c) if a is not None]
    variables = port_variables(pm, pconv.rim_cell_to_flax, 1, jm, *jargs,
                               prepare=_fan_in)
    return rnn, jm, pm, variables


def _jax_cell(jm, variables, x, h, c):
    args = [jnp.asarray(a) for a in (x, h, c) if a is not None]
    return jax.jit(jm.apply)(variables, *args)


def test_rim_cell_matches_jax(cell):
    rnn, jm, pm, variables = cell
    x, h, c = _cell_args(rnn, seed=5)
    jh, jc = _jax_cell(jm, variables, x, h, c)
    with torch.no_grad():
        ph, pc = pm(t(x), t(h), None if c is None else t(c))
    assert_rel(ph, jh, what="h")
    if rnn == "LSTM":
        assert_rel(pc, jc, what="c")
        # inactive units keep their state: at most k units change a step
        changed = (pc != t(c)).any(-1).sum(-1)
        assert int(changed.max()) <= K
    changed = (ph != t(h)).any(-1).sum(-1)
    assert int(changed.max()) <= K
    assert_plan_round_trip(variables, pconv.rim_cell_from_flax,
                           pconv.rim_cell_to_flax, params_only=True)


def test_rim_cell_layout(cell):
    _, _, pm, variables = cell
    p = variables["params"]
    # the comm value size is the hidden size, whatever is asked for
    assert p["comm_value"]["w"].shape == (N, H, 2 * H)
    assert p["comm_out"]["w"].shape == (N, 2 * H, H)
    assert prim.RIMCell(IN, H, N, K, comm_value_size=100).comm_value_size \
        == H
    # the null input is a second row of zeros: its keys and values are the
    # Linear layers' biases, and the values are averaged over the heads
    x = _x((2, IN), 9)
    x2 = torch.stack([t(x), torch.zeros(2, IN)], dim=1)
    with torch.no_grad():
        inputs, mask = pm._input_attention(x2, t(_x((2, N, H), 8)), False,
                                           None)
        v = pm._linear(pm.value_net, x2).reshape(2, 2, 2, 10).mean(2)
    assert inputs.shape == (2, N, 10)
    np.testing.assert_allclose(v[:, 1].numpy(), np.broadcast_to(
        pm.value_net.bias.detach().reshape(2, 10).mean(0).numpy(), (2, 10)),
        rtol=1e-6)
    assert mask.sum(-1).tolist() == [K, K]


def test_rim_cell_gradients_match_jax(cell):
    rnn, jm, pm, variables = cell
    x, h, c = _cell_args(rnn, seed=11)
    inputs = [a for a in (x, h, c) if a is not None]
    w = _x((3, N, H), 12)

    def loss_jax(v, *args):
        nh, nc = jm.apply(v, *args)
        return jnp.sum(nh * w) + (0 if nc is None else jnp.sum(nc * w))

    def loss_torch(m, *args):
        nh, nc = m(*args)
        return torch.sum(nh * t(w)) + (0 if nc is None
                                       else torch.sum(nc * t(w)))
    params = variables["params"]
    jgrads = jax.jit(jax.grad(lambda p, *a: loss_jax({"params": p}, *a),
                              argnums=tuple(range(len(inputs) + 1))))(
        params, *[jnp.asarray(a) for a in inputs])
    xs = [t(a).requires_grad_(True) for a in inputs]
    pm.zero_grad()
    loss_torch(pm, *xs).backward()
    _assert_grads(pm, pconv.rim_cell_from_flax(jgrads[0]), xs, jgrads[1:])


def test_inactive_units_get_no_gradient_through_their_new_state():
    """A loss on the active units' new h: the inactive units' own cell
    weights (their slices of the grouped weights) get zero gradient, the
    active units' do not."""
    pm = prim.RIMCell(IN, H, N, K, **CELL_KW)
    port_variables(pm, pconv.rim_cell_to_flax, 3,
                   jrim.RIMCell(IN, H, N, K, **CELL_KW),
                   *[jnp.asarray(a) for a in _cell_args("LSTM")],
                   prepare=_fan_in)
    x, h, c = (t(a) for a in _cell_args("LSTM", seed=21, b=1))
    with torch.no_grad():
        _, mask = pm._input_attention(
            torch.stack([x, torch.zeros_like(x)], 1), h, False, None)
    active = mask[0].bool()
    pm.zero_grad()
    nh, _ = pm(x, h, c)
    nh[0, active].sum().backward()
    g = pm.rnn.x2h.w.grad.abs().sum(dim=(1, 2))
    assert torch.all(g[~active] == 0), g
    assert torch.all(g[active] > 0), g


def test_top_k_ties_go_to_the_lower_unit():
    scores = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0],
                           [0.0, 0.0, 0.0, 0.0, 0.0]])
    got = prim.top_k_mask(scores, 2)
    _, idx = jax.lax.top_k(jnp.asarray(scores.numpy()), 2)
    want = np.zeros((2, 5), np.float32)
    np.put_along_axis(want, np.asarray(idx), 1.0, axis=1)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [[0, 1, 1, 0, 0], [1, 1, 0, 0, 0]])


def test_rim_cell_with_zero_state_ties_like_jax(cell):
    """h = 0: every unit's query is 0, so all scores tie and both packages
    activate units 0..k-1."""
    rnn, jm, pm, variables = cell
    x, _, c = _cell_args(rnn, seed=31)
    h = np.zeros((3, N, H), np.float32)
    jh, jc = _jax_cell(jm, variables, x, h, c)
    with torch.no_grad():
        ph, pc = pm(t(x), t(h), None if c is None else t(c))
    assert_rel(ph, jh, what="h")
    if rnn == "LSTM":
        assert_rel(pc, jc, what="c")
    moved = (ph != 0).any(-1)
    assert moved[:, :K].all() and not moved[:, K:].any()


# -- the sequence wrapper -----------------------------------------------------

RIMS = [("LSTM", 2, True), ("GRU", 1, False), ("GRU", 2, True)]


@pytest.fixture(scope="module", params=RIMS,
                ids=[f"{r}-{n}-{'bi' if b else 'uni'}" for r, n, b in RIMS])
def rim(request):
    rnn, layers, bi = request.param
    kw = dict(rnn_cell=rnn, n_layers=layers, bidirectional=bi)
    jm = jrim.RIM(IN, H, N, K, **kw)
    pm = prim.RIM(IN, H, N, K, **kw)
    states = layers * (2 if bi else 1)
    x = _x((5, 3, IN), 40)
    h = _x((states, 3, N * H), 41)
    c = _x((states, 3, N * H), 42) if rnn == "LSTM" else None
    args = [jnp.asarray(a) for a in (x, h, c) if a is not None]
    variables = port_variables(pm, pconv.rim_to_flax, 43, jm, *args,
                               prepare=_fan_in)
    return rnn, bi, jm, pm, variables, (x, h, c)


def test_rim_matches_jax(rim):
    rnn, bi, jm, pm, variables, (x, h, c) = rim
    args = [jnp.asarray(a) for a in (x, h, c) if a is not None]
    jout = jax.jit(jm.apply)(variables, *args)
    with torch.no_grad():
        out = pm(t(x), t(h), None if c is None else t(c))
    assert len(out) == len(jout) == (3 if rnn == "LSTM" else 2)
    assert out[0].shape == (5, 3, (2 if bi else 1) * N * H)
    for name, a, b in zip(("out", "h", "c"), out, jout):
        assert_rel(a, b, what=name)
    assert_plan_round_trip(variables, pconv.rim_from_flax, pconv.rim_to_flax,
                           params_only=True)


def test_rim_reverse_direction_is_flipped_back():
    """The backward direction's output at step t is its state after
    reading the sequence from T-1 down to t: its cell run forward over the
    flipped sequence gives that output flipped."""
    kw = dict(rnn_cell="GRU", n_layers=1, bidirectional=True)
    pm = prim.RIM(IN, H, N, K, **kw)
    x, h = _x((5, 3, IN), 70), _x((2, 3, N * H), 71)
    port_variables(pm, pconv.rim_to_flax, 72, jrim.RIM(IN, H, N, K, **kw),
                   jnp.asarray(x), jnp.asarray(h), prepare=_fan_in)
    with torch.no_grad():
        out, hf = pm(t(x), t(h))
        _, _, ys = pm._scan(pm.cells[1], t(h[1]).reshape(3, N, H), None,
                            torch.flip(t(x), [0]), False)
    np.testing.assert_array_equal(out[..., N * H:].numpy(),
                                  torch.flip(ys, [0]).numpy())
    np.testing.assert_array_equal(hf[1].numpy(), ys[-1].numpy())


def test_rim_gradients_match_jax():
    kw = dict(rnn_cell="LSTM", n_layers=1, bidirectional=True)
    jm, pm = jrim.RIM(IN, H, N, K, **kw), prim.RIM(IN, H, N, K, **kw)
    x, h, c = _x((3, 2, IN), 50), _x((2, 2, N * H), 51), _x((2, 2, N * H),
                                                            52)
    args = [jnp.asarray(a) for a in (x, h, c)]
    variables = port_variables(pm, pconv.rim_to_flax, 53, jm, *args,
                               prepare=_fan_in)
    w = _x((3, 2, 2 * N * H), 54)

    def loss_jax(p, *a):
        out, hf, cf = jm.apply({"params": p}, *a)
        return jnp.sum(out * w) + jnp.sum(hf) + 0.5 * jnp.sum(cf)
    jgrads = jax.jit(jax.grad(loss_jax, argnums=(0, 1, 2, 3)))(
        variables["params"], *args)
    xs = [t(a).requires_grad_(True) for a in (x, h, c)]
    out, hf, cf = pm(*xs)
    (torch.sum(out * t(w)) + torch.sum(hf) + 0.5 * torch.sum(cf)).backward()
    _assert_grads(pm, pconv.rim_from_flax(jgrads[0]), xs, jgrads[1:])


def test_rim_draws_initial_states_from_a_generator():
    pm = prim.RIM(IN, H, N, K, rnn_cell="LSTM", n_layers=2)
    port_variables(pm, pconv.rim_to_flax, 60,
                   jrim.RIM(IN, H, N, K, rnn_cell="LSTM", n_layers=2),
                   jnp.zeros((2, 3, IN)), jnp.zeros((2, 3, N * H)),
                   jnp.zeros((2, 3, N * H)))
    x = t(_x((4, 3, IN), 61))
    g1, g2 = (torch.Generator().manual_seed(7) for _ in range(2))
    with torch.no_grad():
        drawn = pm(x, generator=g1)
        h = torch.randn(2, 3, N * H, generator=g2)
        c = torch.randn(2, 3, N * H, generator=g2)
        given = pm(x, h, c)
    for a, b in zip(drawn, given):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
