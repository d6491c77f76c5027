"""Shared helpers of the dormant-module parity tests (the port's RIM, the
conditional, concat, MADE and spline flows, the GIN/NICE/RQS couplings,
the dormant discriminators and layers).

Parameters are drawn for the port's module from a numpy seed
(:func:`port_variables`) and exported to a flax tree through the port's
converter (``models/convert.py``); the tree must hold exactly the leaves,
of the same shapes, that the flax module's own init makes.  Where a test
needs JAX's init values (the data-dependent inits), it runs the init and
converts the other way.
"""
import jax
import numpy as np
import torch

from behavior_driven_video_synthesis_tpu_torch.models import convert as pconv
from behavior_driven_video_synthesis_tpu_torch.models.init import init_random_

KEY = jax.random.PRNGKey(0)


def rel_l2(out, ref) -> float:
    """||out - ref|| / ||ref|| (ref == 0: the norm of out)."""
    out = (out.detach().cpu().numpy() if isinstance(out, torch.Tensor)
           else np.asarray(out)).astype(np.float64)
    ref = np.asarray(ref, np.float64)
    den = np.linalg.norm(ref)
    num = np.linalg.norm(out - ref)
    return float(num / den) if den > 0 else float(num)


def assert_rel(out, ref, tol=1e-5, what=""):
    err = rel_l2(out, ref)
    assert err <= tol, f"{what}: rel-L2 {err:.3e} > {tol:.0e}"


def jitter(variables, seed, scale=0.1):
    """A copy of a flax variable tree with N(0, scale^2) noise from a numpy
    seed added to every float leaf (the integer Shuffle permutations stay)."""
    rng = np.random.RandomState(seed)

    def add(leaf):
        a = np.asarray(leaf)
        if not np.issubdtype(a.dtype, np.floating):
            return a
        return (a + scale * rng.standard_normal(a.shape)).astype(a.dtype)
    return jax.tree_util.tree_map(add, jax.tree_util.tree_map(np.asarray,
                                                              variables))


def load(module, from_flax, tree):
    """Load a flax tree into a port module through its converter, strict,
    and return the module in eval mode."""
    module.load_state_dict(from_flax(tree), strict=True)
    return module.eval()


def assert_plan_round_trip(tree, from_flax, to_flax, params_only=False):
    """to_flax(from_flax(tree)) == tree, leaf by leaf, with no leftover
    key on either side."""
    ref = jax.tree_util.tree_map(np.asarray, tree)
    if params_only and "params" in ref:
        ref = ref["params"]
    back = to_flax(from_flax(tree))
    a, b = pconv.flatten_tree(ref), pconv.flatten_tree(back)
    assert a.keys() == b.keys(), sorted(set(a) ^ set(b))
    for k in a:
        assert a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def t(a):
    """numpy -> a float32 (or integer) torch tensor."""
    return torch.from_numpy(np.array(a))


def port_variables(module, to_flax, seed, jmodule, *args, prepare=None):
    """Seeded parameters for ``module`` (``init_random_`` from a numpy
    seed, then ``prepare(module)`` if given), as flax variables through
    ``to_flax``; asserts that they hold the leaves and shapes of
    ``jmodule.init(KEY, *args)`` (traced by ``jax.eval_shape``, not run).
    Returns the variables ({"params", ...})."""
    init_random_(module, np.random.RandomState(seed))
    if prepare is not None:
        with torch.no_grad():
            prepare(module)
    module.eval()
    variables = to_flax(module.state_dict())
    if "params" not in variables:
        variables = {"params": variables}
    leaves = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(jmodule.init, KEY, *args))[0]
    want = {"/".join(str(p.key) for p in path): v for path, v in leaves}
    got = pconv.flatten_tree(variables)
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))
    for k, v in want.items():
        assert got[k].shape == v.shape, (k, got[k].shape, v.shape)
        assert got[k].dtype == v.dtype, (k, got[k].dtype, v.dtype)
    return variables
