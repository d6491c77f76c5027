"""Full-sequence LSTM forward.

Counterpart of ``behavior_driven_video_synthesis_tpu/ops/recurrent.py``
``LSTM`` (inference: ``lengths`` and ``return_sequences``).  Gate order is
torch's (i, f, g, o) and the parameters keep ``nn.LSTM``'s layer-0 names,
so the reference's encoder state dicts load as they are.  The input
projection for all T steps runs as one matmul before the loop; the loop
body does only the recurrent (B, H) x (H, 4H) product.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn


class LSTM(nn.Module):
    """LSTM over (B, T, D).  With ``lengths`` the carries freeze once
    t >= length, so the final state is each row's last valid step."""

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
                return_sequences: bool = True):
        """Returns (hs (B, T, H) or None, (h_fin, c_fin))."""
        dt = self.dtype
        B, T, _ = xs.shape
        x_proj = (xs.transpose(0, 1).to(dt) @ self.weight_ih_l0.to(dt).t()
                  + (self.bias_ih_l0 + self.bias_hh_l0).to(dt))  # (T, B, 4H)
        if initial_carry is None:
            h = torch.zeros(B, self.hidden, dtype=dt, device=xs.device)
            c = torch.zeros_like(h)
        else:
            h, c = (v.to(dt) for v in initial_carry)
        w_hh = self.weight_hh_l0.to(dt).t()
        hs = []
        for t in range(T):
            i, f, g, o = torch.chunk(x_proj[t] + h @ w_hh, 4, dim=-1)
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
