"""Full-sequence LSTM and GRU forwards.

Counterpart of ``behavior_driven_video_synthesis_tpu/ops/recurrent.py``
``LSTM`` (``lengths``, ``return_sequences`` and ``static_steps``) and
``GRUCell`` (scanned
over a sequence, as the JAX package's ``Classifier`` does).  Gate orders
are torch's ((i, f, g, o); the GRU's (r, z, n) with
``n = tanh(W_in x + b_in + r * (W_hn h + b_hn))``) and the parameters keep
``nn.LSTM``'s and ``nn.GRU``'s layer-0 names, so the reference's state
dicts load as they are.  The input projection for all T steps runs as one
matmul before the loop; the loop body does only the recurrent product.
Products run in ``dtype``; the parameters stay float32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn


class LSTM(nn.Module):
    """LSTM over (B, T, D).  With ``lengths`` the carries freeze once
    t >= length, so the final state is each row's last valid step.  With
    ``static_steps=T`` the input is one (B, D) fed the same at each of T
    steps (the MT-VAE decoder): it is projected once, and autograd sums
    that projection's gradient over the T steps."""

    def __init__(self, input_size: int, hidden: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.hidden, self.dtype = hidden, dtype
        self.weight_ih_l0 = nn.Parameter(
            torch.empty(4 * hidden, input_size, device=device))
        self.weight_hh_l0 = nn.Parameter(
            torch.empty(4 * hidden, hidden, device=device))
        self.bias_ih_l0 = nn.Parameter(torch.zeros(4 * hidden, device=device))
        self.bias_hh_l0 = nn.Parameter(torch.zeros(4 * hidden, device=device))

    def forward(self, xs: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                initial_carry: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None,
                return_sequences: bool = True,
                static_steps: Optional[int] = None):
        """Returns (hs (B, T, H) or None, (h_fin, c_fin))."""
        dt = self.dtype
        bias = (self.bias_ih_l0 + self.bias_hh_l0).to(dt)
        if static_steps is None:
            B, T, _ = xs.shape
            x_proj = (xs.transpose(0, 1).to(dt)
                      @ self.weight_ih_l0.to(dt).t() + bias)  # (T, B, 4H)
        else:
            (B, _), T = xs.shape, static_steps
            x_proj = xs.to(dt) @ self.weight_ih_l0.to(dt).t() + bias  # (B, 4H)
        if initial_carry is None:
            h = torch.zeros(B, self.hidden, dtype=dt, device=xs.device)
            c = torch.zeros_like(h)
        else:
            h, c = (v.to(dt) for v in initial_carry)
        w_hh = self.weight_hh_l0.to(dt).t()
        hs = []
        for t in range(T):
            xp = x_proj if static_steps is not None else x_proj[t]
            i, f, g, o = torch.chunk(xp + h @ w_hh, 4, dim=-1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            if lengths is not None:
                valid = (t < lengths)[:, None]
                h_new = torch.where(valid, h_new, h)
                c_new = torch.where(valid, c_new, c)
            h, c = h_new, c_new
            if return_sequences:
                hs.append(h)
        if not return_sequences:
            return None, (h, c)
        return torch.stack(hs, dim=1), (h, c)


class GRU(nn.Module):
    """GRU over (B, T, D) from a zero state; returns the final hidden
    state (B, H)."""

    def __init__(self, input_size: int, hidden: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.hidden, self.dtype = hidden, dtype
        self.weight_ih_l0 = nn.Parameter(
            torch.empty(3 * hidden, input_size, device=device))
        self.weight_hh_l0 = nn.Parameter(
            torch.empty(3 * hidden, hidden, device=device))
        self.bias_ih_l0 = nn.Parameter(torch.zeros(3 * hidden, device=device))
        self.bias_hh_l0 = nn.Parameter(torch.zeros(3 * hidden, device=device))

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        gi = (xs.to(dt) @ self.weight_ih_l0.to(dt).t()
              + self.bias_ih_l0.to(dt))                      # (B, T, 3H)
        w_hh = self.weight_hh_l0.to(dt).t()
        b_hh = self.bias_hh_l0.to(dt)
        h = torch.zeros(xs.shape[0], self.hidden, dtype=dt, device=xs.device)
        for t in range(xs.shape[1]):
            i_r, i_z, i_n = torch.chunk(gi[:, t], 3, dim=-1)
            h_r, h_z, h_n = torch.chunk(h @ w_hh + b_hh, 3, dim=-1)
            r = torch.sigmoid(i_r + h_r)
            z = torch.sigmoid(i_z + h_z)
            n = torch.tanh(i_n + r * h_n)
            h = (1.0 - z) * n + z * h
        return h
