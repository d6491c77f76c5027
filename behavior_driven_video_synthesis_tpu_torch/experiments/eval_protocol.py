"""The quantitative evaluation protocol of the behavior experiment.

Counterpart of ``behavior_driven_video_synthesis_tpu/experiments/
eval_protocol.py`` (``ks_test_flow_gaussianity`` and :40-245):

  * the per-dimension KS test of flow codes against N(0, 1);
  * ADE_c/FDE_c, the drift of a cross-transferred rollout from its source
    sequence, and the mu-consistency scores;
  * the post-hoc real-vs-fake classifiers per sample source (prior, cross,
    self, flow) and the start-pose regressor from mu, trained for each
    start frame;
  * the CF scores: a trained action classifier's accuracy on
    cross-transferred rollouts and the L2/cosine distances of its logits.

The post-hoc protocol trains the S start frames' restarts of a source
together: one stacked parameter set, run through ``torch.func.vmap`` of
``functional_call``, with one SGD (or Adam) over the stacked tensors,
which is S independent optimizers since both update elementwise.  Every
draw of it goes through a :class:`PosthocDraws`.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from scipy.stats import kstest
from torch.func import functional_call, vmap

from ..models.init import init_like_jax_
from ..models.probes import Classifier, Regressor

DEFAULT_PROBE_STARTS = (0, 10, 20, 30, 40, 49)


def ks_test_flow_gaussianity(z: np.ndarray) -> float:
    """Mean over dims of KS-test p-values of flow codes vs N(0,1)."""
    z = np.asarray(z)
    ps = [kstest(z[:, d], "norm")[1] for d in range(z.shape[1])]
    return float(np.mean(ps))


def _tensor(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def cross_transfer_metrics(seq_cross, x_source) -> Dict[str, float]:
    """ADE_c/FDE_c: the drift of the cross-transferred rollout from the
    source sequence (the '3 characters' metric)."""
    seq_cross = _tensor(seq_cross)
    x_source = _tensor(x_source, seq_cross.device)
    ade = torch.mean(torch.sqrt(torch.sum(
        (seq_cross - x_source) ** 2, dim=-1) + 1e-12))
    fde = torch.mean(torch.sqrt(torch.sum(
        (seq_cross[:, -1] - x_source[:, -1]) ** 2, dim=-1) + 1e-12))
    return {"ADE_c": float(ade), "FDE_c": float(fde)}


def mu_consistency_metrics(mu, mu_re, mu_related) -> Dict[str, float]:
    """||mu - mu(re-encoded rollout)|| vs ||mu - mu(related seq)||."""
    d_re = np.linalg.norm(np.asarray(mu) - np.asarray(mu_re), axis=1)
    d_rel = np.linalg.norm(np.asarray(mu) - np.asarray(mu_related), axis=1)
    return {
        "recon_mu": float(d_re.mean()), "recon_mu_std": float(d_re.std()),
        "distance_mu": float(d_rel.mean()),
        "distance_mu_std": float(d_rel.std()),
    }


def bce_logits(pred, target):
    return torch.mean(torch.clamp(pred, min=0) - pred * target
                      + torch.log1p(torch.exp(-torch.abs(pred))))


class PosthocDraws:
    """The draws of :func:`train_posthoc_classifiers`, from one generator
    on the device, in the order the protocol asks for them: for each fake
    source, then for the regressor (``source`` "regressor"), the S initial
    parameter sets, then the batch indices of every iteration.  A test
    hands in the JAX run's values by overriding both methods."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        self.generator = generator

    def initial_params(self, source: str, make: Callable[[], torch.nn.Module],
                       n_restarts: int):
        """A list of ``n_restarts`` state dicts of fresh ``make()``
        modules, in the JAX package's initializers."""
        return [init_like_jax_(make(), self.generator).state_dict()
                for _ in range(n_restarts)]

    def batch_indices(self, source: str, it: int, n_restarts: int,
                      batch_size: int, n: int, device) -> torch.Tensor:
        """(n_restarts, batch_size) indices in [0, n) for iteration
        ``it``: each restart draws its own."""
        return torch.randint(0, n, (n_restarts, batch_size),
                             generator=self.generator, device=device)


def _stack(state_dicts, device):
    """Leaf tensors (S, ...) of S state dicts, which the optimizer
    updates."""
    return {k: torch.stack([sd[k] for sd in state_dicts]).to(
        device).requires_grad_() for k in state_dicts[0]}


def _train_restarts(template, params, loss_fn, batch_fn, optimizer,
                    n_iters: int):
    """n_iters steps of the restarts stacked in ``params``: each step
    takes ``loss_fn(module_call, *batch)`` of every restart on its own
    batch (``batch_fn(it)``, stacked on dim 0) and one optimizer step on
    the sum, whose gradient for each restart is that of its own loss."""
    def one(p, *batch):
        return loss_fn(lambda *x: functional_call(template, p, x), *batch)
    for it in range(n_iters):
        optimizer.zero_grad(set_to_none=True)
        vmap(one)(params, *batch_fn(it)).sum().backward()
        optimizer.step()


SCORE_CHUNK = 2048   # cached sequences one vmapped scoring pass holds


def _sigmoid_means(template, params, x):
    """(mean sigmoid, share of sigmoids > 0.5) of each stacked classifier
    over the sequences x, in chunks of SCORE_CHUNK: at the reference's
    25,000 cached sequences one pass would hold S GRU input projections
    of the whole cache."""
    def sums(p, chunk):
        sig = torch.sigmoid(functional_call(template, p, (chunk,)))
        return torch.stack([sig.sum(), (sig > 0.5).float().sum()])
    total = sum(vmap(sums, in_dims=(0, None))(params, x[i:i + SCORE_CHUNK])
                for i in range(0, x.shape[0], SCORE_CHUNK))
    return total.T / x.shape[0]


def train_posthoc_classifiers(real_seqs, fake_sets: Dict[str, object],
                              mu=None, starts=DEFAULT_PROBE_STARTS,
                              n_iters: int = 2000, batch_size: int = 256,
                              lr: float = 1e-3,
                              draws: Optional[PosthocDraws] = None,
                              device=None) -> Dict[str, float]:
    """The per-start-frame post-hoc probe protocol.

    For every start frame t (clipped to the cached sequence length) train,
    per fake source, a fresh real/fake GRU classifier (SGD, momentum 0.9)
    and a mu -> pose(t) regressor (Adam), n_iters iterations at
    batch_size, and report:

      ``score_{src}_t{t}``: the mean sigmoid on fakes (the reference's
        "Acc"; 0.5 = indistinguishable, lower = classifier fooled);
      ``acc_{src}_t{t}``: the balanced accuracy at threshold 0.5;
      ``loss_regressor_t{t}``: mean ||reg(mu) - x_t|| over the cache;
      ``DE_t{t}``: mean ||x_cross[:, t] - x_orig[:, t]||, the start-pose
        drift.

    The classifier's inputs do not depend on t: the S classifiers of a
    source are S restarts of one problem (fresh parameters and their own
    batch order).  Un-suffixed keys hold the means over starts.  Arrays
    are numpy or tensors; the training runs on ``device`` (default: the
    real sequences' device)."""
    draws = draws or PosthocDraws()
    real = _tensor(real_seqs, device)
    device = real.device
    n, T = real.shape[0], real.shape[1]
    starts = tuple(dict.fromkeys(min(int(t), T - 1) for t in starts))
    S = len(starts)
    results: Dict[str, float] = {}

    def cls_make():
        return Classifier(real.shape[-1], 1, device=device)
    template = cls_make()

    def cls_loss(cls, xr, xf):
        pr, pf = cls(xr), cls(xf)
        return (bce_logits(pr, torch.ones_like(pr))
                + bce_logits(pf, torch.zeros_like(pf)))

    for name, fakes in fake_sets.items():
        fakes = _tensor(fakes, device)
        nf = fakes.shape[0]
        params = _stack(draws.initial_params(name, cls_make, S), device)
        opt = torch.optim.SGD(params.values(), lr=lr, momentum=0.9)

        def batch(it, name=name, fakes=fakes, nf=nf):
            idx = draws.batch_indices(name, it, S, batch_size, n, device)
            return real[idx], fakes[idx % nf]
        _train_restarts(template, params, cls_loss, batch, opt, n_iters)

        with torch.no_grad():
            sig_f, pos_f = _sigmoid_means(template, params, fakes)
            _, pos_r = _sigmoid_means(template, params, real)
        scores = sig_f.cpu().numpy()
        accs = (0.5 * (pos_r + 1.0 - pos_f)).cpu().numpy()
        for t, sc, ac in zip(starts, scores, accs):
            results[f"score_{name}_t{t}"] = float(sc)
            results[f"acc_{name}_t{t}"] = float(ac)
        results[f"score_{name}"] = float(np.mean(scores))
        results[f"acc_{name}"] = float(np.mean(accs))

    if "cross" in fake_sets:
        cross = _tensor(fake_sets["cross"]).cpu().numpy()
        orig = real.cpu().numpy()
        des = []
        for t in starts:
            de = float(np.mean(np.linalg.norm(
                cross[:, t] - orig[:, t], axis=-1)))
            results[f"DE_t{t}"] = de
            des.append(de)
        results["DE"] = float(np.mean(des))

    if mu is not None:
        mu = _tensor(mu, device)
        # (S, n, K): the ground-truth pose at each start frame
        targets = real[:, list(starts)].transpose(0, 1)

        def reg_make():
            return Regressor(mu.shape[-1], real.shape[-1], device=device)
        reg = reg_make()

        def reg_loss(fn, xm, xt):
            return torch.mean(torch.sqrt(
                torch.sum((fn(xm) - xt) ** 2, dim=1) + 1e-12))

        rparams = _stack(draws.initial_params("regressor", reg_make, S),
                         device)
        ropt = torch.optim.Adam(rparams.values(), lr=lr)
        rows = torch.arange(S, device=device)[:, None]

        def reg_batch(it):
            idx = draws.batch_indices("regressor", it, S, batch_size,
                                      mu.shape[0], device)
            return mu[idx], targets[rows, idx]
        _train_restarts(reg, rparams, reg_loss, reg_batch, ropt, n_iters)
        with torch.no_grad():
            rlosses = vmap(lambda p, xt: reg_loss(
                lambda x: functional_call(reg, p, (x,)), mu, xt))(
                    rparams, targets).cpu().numpy()
        for t, rl in zip(starts, rlosses):
            results[f"loss_regressor_t{t}"] = float(rl)
        results["loss_regressor_posthoc"] = float(np.mean(rlosses))
    return results


def action_transfer_scores(cls_apply: Callable, seq_cross, seq_source,
                           labels) -> Dict[str, float]:
    """CF scores: does a trained action classifier still recognize the
    source action in the cross-transferred rollout?  Plus the L2 and
    cosine distances of its logits between source and transfer."""
    with torch.no_grad():
        logits_c, _ = cls_apply(_tensor(seq_cross))
        logits_s, _ = cls_apply(_tensor(seq_source, logits_c.device))
    logits_c, logits_s = logits_c.float(), logits_s.float()
    labels = torch.as_tensor(labels, device=logits_c.device)
    acc_cross = torch.mean(
        (torch.argmax(logits_c, -1) == labels).float())
    l2 = torch.mean(torch.sqrt(torch.sum((logits_c - logits_s) ** 2, -1)
                               + 1e-12))
    cos = torch.mean(torch.sum(logits_c * logits_s, -1) / (
        torch.linalg.norm(logits_c, dim=-1)
        * torch.linalg.norm(logits_s, dim=-1) + 1e-8))
    return {"CF_cross": float(acc_cross), "CF_logits_l2": float(l2),
            "CF_logits_cos": float(cos)}
