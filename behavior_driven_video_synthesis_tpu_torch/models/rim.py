"""Recurrent Independent Mechanisms (RIM).

Counterpart of ``behavior_driven_video_synthesis_tpu/models/rim.py`` (the
reference's models/rim.py, which no experiment imports).  As in JAX:

* N recurrent units step in lockstep through grouped cells, one einsum
  over a (units, din, dout) weight;
* input attention against [x, null] activates the k units that attend
  most to x.  On a tie the lower unit wins, as ``jax.lax.top_k`` picks it
  (a stable descending sort here: ``torch.topk`` does not promise an
  order among equal values);
* inactive units keep their h and c and get no gradient through the new
  state (``mask * h + (1 - mask) * h.detach()``);
* masked multi-head communication between the active units, with a
  residual; the values are the hidden size wide;
* a multi-layer, optionally bidirectional wrapper; the reverse direction
  runs over the flipped sequence and flips its output back.  Inside it
  the cells never drop out (JAX's scan body calls them with
  ``train=False``).

The GRU cell takes the LSTM cell's fan-in uniform init, where the
reference's is all ones (JAX's departure, kept).  Initial states that
are not given are drawn from an explicit ``torch.Generator`` (h, then c).
State-dict names are the flax module's (``key_net``, ``comm_out.w``,
``rnn.x2h.w`` for its ``GroupDense_0``; ``models/convert.py``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nn import dropout


class GroupDense(nn.Module):
    """num_blocks independent Linear layers without bias, as one einsum
    over ``w`` (num_blocks, din, dout) (reference GroupLinearLayer)."""

    def __init__(self, din: int, dout: int, num_blocks: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.w = nn.Parameter(torch.empty(num_blocks, din, dout,
                                          device=device))

    def forward(self, x):                  # (B, num_blocks, din)
        return torch.einsum("bnd,ndo->bno", x.to(self.dtype),
                            self.w.to(self.dtype))


class GroupLSTMCell(nn.Module):
    """N LSTM cells at once; gates (i, f, o) then the candidate g."""

    def __init__(self, inp_size: int, hidden_size: int, num_units: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.x2h = GroupDense(inp_size, 4 * hidden_size, num_units, dtype,
                              device)
        self.h2h = GroupDense(hidden_size, 4 * hidden_size, num_units, dtype,
                              device)

    def forward(self, x, h, c):
        pre = self.x2h(x) + self.h2h(h)
        hs = self.hidden_size
        gates = torch.sigmoid(pre[..., :3 * hs])
        g = torch.tanh(pre[..., 3 * hs:])
        i, f, o = gates[..., :hs], gates[..., hs:2 * hs], gates[..., 2 * hs:]
        c_t = c * f + i * g
        return o * torch.tanh(c_t), c_t


class GroupGRUCell(nn.Module):
    """N GRU cells at once (reset, update, new)."""

    def __init__(self, inp_size: int, hidden_size: int, num_units: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.x2h = GroupDense(inp_size, 3 * hidden_size, num_units, dtype,
                              device)
        self.h2h = GroupDense(hidden_size, 3 * hidden_size, num_units, dtype,
                              device)

    def forward(self, x, h):
        i_r, i_i, i_n = torch.chunk(self.x2h(x), 3, dim=-1)
        h_r, h_i, h_n = torch.chunk(self.h2h(h), 3, dim=-1)
        reset = torch.sigmoid(i_r + h_r)
        inp = torch.sigmoid(i_i + h_i)
        new = torch.tanh(i_n + reset * h_n)
        return new + inp * (h - new)


def _heads(x, num_heads, head_size):
    """(B, N, heads * size) -> (B, heads, N, size)."""
    b, n = x.shape[:2]
    return x.reshape(b, n, num_heads, head_size).transpose(1, 2)


def top_k_mask(scores, k: int):
    """(B, N) 0/1 mask of each row's k largest scores; among equal scores
    the lower index wins, as in ``jax.lax.top_k``."""
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    return torch.zeros_like(scores).scatter_(1, order[:, :k], 1.0)


class RIMCell(nn.Module):
    """One RIM step over (B, input_size) with states (B, N, H)."""

    def __init__(self, input_size: int, hidden_size: int, num_units: int,
                 k: int, rnn_cell: str = "LSTM", input_key_size: int = 64,
                 input_value_size: int = 400, input_query_size: int = 64,
                 num_input_heads: int = 1, input_dropout: float = 0.1,
                 comm_key_size: int = 32, comm_value_size: int = 100,
                 comm_query_size: int = 32, num_comm_heads: int = 4,
                 comm_dropout: float = 0.1, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.k, self.dtype = k, dtype
        self.input_key_size, self.input_value_size = (input_key_size,
                                                      input_value_size)
        self.input_query_size = input_query_size
        self.num_input_heads, self.num_comm_heads = (num_input_heads,
                                                     num_comm_heads)
        self.comm_key_size, self.comm_query_size = (comm_key_size,
                                                    comm_query_size)
        # comm_value_size is not read: the reference forces the comm
        # value size to the hidden size
        self.comm_value_size = cvs = hidden_size
        self.input_dropout, self.comm_dropout = input_dropout, comm_dropout
        ks, vs, n = input_key_size, input_value_size, num_units
        self.key_net = nn.Linear(input_size, num_input_heads * ks,
                                 device=device)
        self.value_net = nn.Linear(input_size, num_input_heads * vs,
                                   device=device)
        cell = GroupGRUCell if rnn_cell.upper() == "GRU" else GroupLSTMCell
        self.rnn = cell(vs, hidden_size, n, dtype, device)
        self.query_net = GroupDense(hidden_size, ks * num_input_heads, n,
                                    dtype, device)
        self.comm_query = GroupDense(hidden_size,
                                     comm_query_size * num_comm_heads, n,
                                     dtype, device)
        self.comm_key = GroupDense(hidden_size,
                                   comm_key_size * num_comm_heads, n,
                                   dtype, device)
        self.comm_value = GroupDense(hidden_size, cvs * num_comm_heads, n,
                                     dtype, device)
        self.comm_out = GroupDense(num_comm_heads * cvs, cvs, n, dtype,
                                   device)

    def _linear(self, layer, x):
        dt = self.dtype
        return F.linear(x.to(dt), layer.weight.to(dt), layer.bias.to(dt))

    def _input_attention(self, x, h, train, generator):
        """x: (B, 2, input_size), the null input second; h: (B, N, H).
        Returns the units' inputs (B, N, value_size) and the top-k mask
        (B, N)."""
        keys = _heads(self._linear(self.key_net, x), self.num_input_heads,
                      self.input_key_size)
        values = _heads(self._linear(self.value_net, x),
                        self.num_input_heads,
                        self.input_value_size).mean(dim=1)   # (B, 2, vs)
        queries = _heads(self.query_net(h), self.num_input_heads,
                         self.input_query_size)
        scores = torch.einsum("bhnk,bhmk->bhnm", queries, keys) \
            / (self.input_key_size ** 0.5)
        scores = scores.mean(dim=1)                          # (B, N, 2)
        mask = top_k_mask(scores[:, :, 0].detach(), self.k)
        probs = torch.softmax(scores, dim=-1)
        if train:
            probs = dropout(probs, self.input_dropout, generator)
        inputs = torch.einsum("bnm,bmv->bnv", probs, values) * mask[..., None]
        return inputs, mask

    def _communication(self, h, mask, train, generator):
        """Masked multi-head attention between the units, residual."""
        q = _heads(self.comm_query(h), self.num_comm_heads,
                   self.comm_query_size)
        k = _heads(self.comm_key(h), self.num_comm_heads, self.comm_key_size)
        v = _heads(self.comm_value(h), self.num_comm_heads,
                   self.comm_value_size)
        scores = torch.einsum("bhnk,bhmk->bhnm", q, k) \
            / (self.comm_key_size ** 0.5)
        probs = torch.softmax(scores, dim=-1)
        probs = probs * mask[:, None, :, None]    # only active units query
        if train:
            probs = dropout(probs, self.comm_dropout, generator)
        ctx = torch.einsum("bhnm,bhmv->bhnv", probs, v)
        b, _, n, _ = ctx.shape
        ctx = ctx.transpose(1, 2).reshape(b, n, -1)
        return self.comm_out(ctx) + h

    def forward(self, x, hs, cs=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """x: (B, input_size) (or (B, 1, input_size)); hs, cs: (B, N, H),
        cs None for a GRU.  Returns (hs, cs)."""
        if x.dim() == 3:
            x = x.squeeze(1)
        x2 = torch.stack([x, torch.zeros_like(x)], dim=1)
        inputs, mask = self._input_attention(x2, hs, train, generator)
        h_old, c_old = hs, cs
        if cs is not None:
            hs, cs = self.rnn(inputs, hs, cs)
        else:
            hs = self.rnn(inputs, hs)
        m = mask[..., None].to(hs.dtype)
        # blocked gradient through the inactive units
        h_new = m * hs + (1.0 - m) * hs.detach()
        h_new = self._communication(h_new, mask, train, generator)
        hs = m * h_new + (1.0 - m) * h_old
        if cs is not None:
            cs = m * cs + (1.0 - m) * c_old
        return hs, cs


class RIM(nn.Module):
    """Multi-layer, optionally bidirectional RIM over (T, B, F); returns
    (T, B, num_directions * N * H), the final h per layer and direction
    (layers * dirs, B, N * H) and, for an LSTM, the final c."""

    def __init__(self, input_size: int, hidden_size: int, num_units: int,
                 k: int, rnn_cell: str = "LSTM", n_layers: int = 1,
                 bidirectional: bool = False, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.hidden_size, self.num_units = hidden_size, num_units
        self.n_layers, self.dtype = n_layers, dtype
        self.nd = 2 if bidirectional else 1
        self.use_c = rnn_cell.upper() == "LSTM"
        self.cells = nn.ModuleList(
            RIMCell(input_size if i < self.nd
                    else self.nd * hidden_size * num_units,
                    hidden_size, num_units, k, rnn_cell, dtype=dtype,
                    device=device)
            for i in range(n_layers * self.nd))

    def _scan(self, cell, h, c, xs, reverse: bool):
        steps = range(xs.shape[0])
        ys = [None] * xs.shape[0]
        for t in (reversed(steps) if reverse else steps):
            h, c = cell(xs[t], h, c)
            ys[t] = h.reshape(h.shape[0], -1)
        return h, c, torch.stack(ys)

    def forward(self, x, h=None, c=None,
                generator: Optional[torch.Generator] = None):
        """x: (T, B, F); h, c: (layers * dirs, B, N * H), or None to draw
        them from ``generator`` as the reference's randn init."""
        T, B = x.shape[:2]
        shape = (self.n_layers * self.nd, B, self.hidden_size
                 * self.num_units)
        if h is None:
            h = torch.randn(shape, generator=generator, dtype=self.dtype,
                            device=x.device)
            if self.use_c:
                c = torch.randn(shape, generator=generator,
                                dtype=self.dtype, device=x.device)
        units = (B, self.num_units, self.hidden_size)
        hs_out, cs_out = [], []
        for layer in range(self.n_layers):
            outs = []
            for d in range(self.nd):
                i = layer * self.nd + d
                ci = c[i].reshape(units) if self.use_c else None
                hf, cf, ys = self._scan(self.cells[i], h[i].reshape(units),
                                        ci, x, reverse=(d == 1))
                outs.append(ys)
                hs_out.append(hf.reshape(B, -1))
                if self.use_c:
                    cs_out.append(cf.reshape(B, -1))
            x = torch.cat(outs, dim=2)
        if self.use_c:
            return x, torch.stack(hs_out), torch.stack(cs_out)
        return x, torch.stack(hs_out)
