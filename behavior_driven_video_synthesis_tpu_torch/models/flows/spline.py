"""Rational-quadratic spline (neural spline flow) coupling.

Counterpart of ``behavior_driven_video_synthesis_tpu/models/flows/
spline.py`` (the reference's vendored NSF code, nsf_flow.py:23-168):
monotone rational-quadratic splines of K bins on [-tail_bound,
tail_bound] with identity tails outside, exact forward and inverse, and
an analytic log-determinant.  Elementwise and branch-free: the bin of an
input is the count of knots at or below it, as JAX counts it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .blocks import DoubleCoupling

_MIN_WIDTH = 1e-3
_MIN_HEIGHT = 1e-3
_MIN_DERIV = 1e-3


def _bin_index(bin_locations, inputs):
    """The bin holding each input: the number of the K+1 knots at or below
    it, less one, clamped to [0, K-1] (JAX ``_searchsorted``).  An input on
    a knot falls in the bin that starts there; the last knot belongs to
    the last bin."""
    count = torch.sum(inputs[..., None] >= bin_locations, dim=-1)
    return torch.clamp(count - 1, 0, bin_locations.shape[-1] - 2)


def _knots(unnorm, min_size, tail_bound):
    """Bin sizes (..., K) and knot positions (..., K+1) on [-B, B] from
    unnormalized sizes."""
    K = unnorm.shape[-1]
    sizes = min_size + (1 - min_size * K) * torch.softmax(unnorm, dim=-1)
    cum = F.pad(torch.cumsum(sizes, dim=-1), (1, 0))
    cum = 2 * tail_bound * cum - tail_bound
    return cum[..., 1:] - cum[..., :-1], cum


def rational_quadratic_spline(inputs, unnorm_widths, unnorm_heights,
                              unnorm_derivs, inverse: bool = False,
                              tail_bound: float = 3.0):
    """Elementwise monotone RQS with identity tails.

    inputs: (..., D); unnorm_widths and unnorm_heights: (..., D, K);
    unnorm_derivs: (..., D, K - 1), the inner knots' derivatives (the two
    end knots' are 1, so the spline meets the tails smoothly).  Returns
    (outputs, elementwise logdet), each of the input's shape; outside
    [-tail_bound, tail_bound] the output is the input and the logdet 0.
    """
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    # the spline sees clamped values; the tails overwrite them after
    x = torch.clamp(inputs, -tail_bound, tail_bound)
    widths, cumwidths = _knots(unnorm_widths, _MIN_WIDTH, tail_bound)
    heights, cumheights = _knots(unnorm_heights, _MIN_HEIGHT, tail_bound)
    derivs = F.pad(_MIN_DERIV + F.softplus(unnorm_derivs), (1, 1),
                   value=1.0)

    bins = _bin_index(cumheights if inverse else cumwidths, x)[..., None]

    def take(t):
        return torch.gather(t, -1, bins)[..., 0]

    in_w, in_cw = take(widths), take(cumwidths[..., :-1])
    in_h, in_ch = take(heights), take(cumheights[..., :-1])
    d_k, d_k1 = take(derivs[..., :-1]), take(derivs[..., 1:])
    s = in_h / in_w

    if inverse:
        dy = x - in_ch
        a = in_h * (s - d_k) + dy * (d_k1 + d_k - 2 * s)
        b = in_h * d_k - dy * (d_k1 + d_k - 2 * s)
        c = -s * dy
        disc = b ** 2 - 4 * a * c
        xi = (2 * c) / (-b - torch.sqrt(torch.clamp(disc, min=0.0)))
        out = xi * in_w + in_cw
    else:
        xi = (x - in_cw) / in_w
    denom = s + (d_k1 + d_k - 2 * s) * xi * (1 - xi)
    dnum = s ** 2 * (d_k1 * xi ** 2 + 2 * s * xi * (1 - xi)
                     + d_k * (1 - xi) ** 2)
    logdet = torch.log(dnum) - 2 * torch.log(denom)
    if inverse:
        logdet = -logdet
    else:
        out = in_ch + in_h * (s * xi ** 2 + d_k * xi * (1 - xi)) / denom

    out = torch.where(inside, out, inputs)
    logdet = torch.where(inside, logdet, torch.zeros_like(logdet))
    return out, logdet


class RQSCoupling(DoubleCoupling):
    """Double coupling whose elementwise map is a monotone RQS instead of
    scale-and-shift (``coupling_type="rqs"``, JAX ``RQSCoupling``).  Each
    of the two MLPs ``nets.{j}`` maps xa to dim2 x (3K - 1) spline
    parameters: K widths, K heights, K - 1 inner derivatives."""

    def __init__(self, in_channels: int, hidden_dim: int,
                 hidden_depth: int = 2, dtype=torch.float32, device=None,
                 n_bins: int = 8, tail_bound: float = 3.0):
        self.n_bins, self.tail_bound = n_bins, tail_bound
        super().__init__(in_channels, hidden_dim, hidden_depth, dtype,
                         device)

    def _nets(self, in_dim, hidden_dim, hidden_depth, dtype, device):
        self.nets = self._mlps(in_dim, self.dim2 * (3 * self.n_bins - 1),
                               False, hidden_dim, hidden_depth, dtype,
                               device)

    def _couple(self, i, h, xb, reverse):
        K = self.n_bins
        p = self.nets[i](h).reshape(xb.shape[0], self.dim2, 3 * K - 1)
        out, logdet = rational_quadratic_spline(
            xb, p[..., :K], p[..., K:2 * K], p[..., 2 * K:],
            inverse=reverse, tail_bound=self.tail_bound)
        return out, torch.sum(logdet, dim=-1)
