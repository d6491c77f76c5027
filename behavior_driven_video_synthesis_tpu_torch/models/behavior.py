"""The behavior cVAE: recurrent encoder + residual autoregressive decoder.

Counterpart of ``behavior_driven_video_synthesis_tpu/models/behavior.py``.
State-dict names are the reference's (``b_enc.rnn.weight_ih_l0``,
``b_enc.mu_fn.conv.weight_v``, ``decoder.rnn.weight_ih``,
``decoder.n_out.weight``, ``decoder.n_in.weight``).  Randomness comes from
an explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.cuda import rollout
from ..ops.nn import NormDense, prepared
from ..ops.recurrent import LSTM
from ..ops import batch_draws


class BehaviorEncoder(nn.Module):
    """Many-to-one LSTM encoder; its final hidden state ``pre`` feeds the
    weight-norm (mu, logstd) heads of the information bottleneck."""

    def __init__(self, n_kps: int, dim_hidden: int, ib: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.ib = ib
        self.rnn = LSTM(n_kps, dim_hidden, dtype=dtype, device=device)
        if ib:
            self.mu_fn = NormDense(dim_hidden, dim_hidden, dtype=dtype,
                                   device=device)
            self.std_fn = NormDense(dim_hidden, dim_hidden, dtype=dtype,
                                    device=device)

    def forward(self, x, lengths: Optional[torch.Tensor] = None,
                sample: bool = False,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None):
        """x: (B, T, K).  Returns (b, mu, logstd, pre) with ib, else pre;
        b is a prior draw when ``sample`` else mu + exp(logstd) * eps, eps
        as given (cast to the encoder's dtype) or drawn from
        ``generator``."""
        _, (pre, _) = self.rnn(x, lengths, return_sequences=False)
        if not self.ib:
            return pre
        mu = self.mu_fn(pre)
        logstd = self.std_fn(pre)
        if eps is None:
            eps = batch_draws.randn(mu.shape, generator=generator,
                                    dtype=mu.dtype, device=mu.device)
        eps = eps.to(mu.dtype)
        b = eps if sample else mu + torch.exp(logstd) * eps
        return b, mu, logstd, pre


class ResidualDecoder(nn.Module):
    """Autoregressive residual rollout x_{t+1} = x_t + n_out(h_t), with the
    cell's h and c both initialized to b."""

    def __init__(self, n_kps: int, dim_hidden: int, rnn_type: str = "lstm",
                 use_nin: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        if rnn_type not in ("lstm", "gru"):
            raise ValueError(f"rnn_type must be 'lstm' or 'gru', got "
                             f"{rnn_type!r}")
        self.rnn_type, self.use_nin, self.dtype = rnn_type, use_nin, dtype
        cell = nn.LSTMCell if rnn_type == "lstm" else nn.GRUCell
        self.rnn = cell(n_kps, dim_hidden, device=device)  # parameter holder
        self.n_out = nn.Linear(dim_hidden, n_kps, device=device)
        if use_nin:
            self.n_in = nn.Linear(n_kps, n_kps, device=device)

    def rollout_params(self):
        """The LSTM cell's and the output layer's parameters in the rollout
        kernel's order: weight_ih, weight_hh, bias_ih, bias_hh, and the
        output layer's weight and bias."""
        r = self.rnn
        return (r.weight_ih, r.weight_hh, r.bias_ih, r.bias_hh,
                self.n_out.weight, self.n_out.bias)

    def rollout_operands(self):
        """The rollout kernel's operands (``rollout.pack_operands``) of
        :meth:`rollout_params`, kept while those are unchanged
        (:func:`prepared`)."""
        params = self.rollout_params()
        return prepared(self, "rollout", params,
                        lambda: rollout.pack_operands(*params))

    def forward(self, b, x_start, length: int):
        """b: (B, H); x_start: (B, K).  Returns xs (B, length, K) and cs,
        the pose fed into each step (B, length, K)."""
        dt = self.dtype
        w_ih = self.rnn.weight_ih.to(dt).t()
        w_hh = self.rnn.weight_hh.to(dt).t()
        w_out = self.n_out.weight.to(dt).t()
        b_out = self.n_out.bias.to(dt)
        h = b.to(dt)
        c = h
        x = x_start.to(dt)
        xs, cs = [], []
        for _ in range(length):
            inp = x
            if self.use_nin:
                inp = inp @ self.n_in.weight.to(dt).t() + self.n_in.bias.to(dt)
            if self.rnn_type == "lstm":
                gates = (inp @ w_ih + h @ w_hh
                         + (self.rnn.bias_ih + self.rnn.bias_hh).to(dt))
                i, f, g, o = torch.chunk(gates, 4, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
            else:
                gi = inp @ w_ih + self.rnn.bias_ih.to(dt)
                gh = h @ w_hh + self.rnn.bias_hh.to(dt)
                i_r, i_z, i_n = torch.chunk(gi, 3, dim=-1)
                h_r, h_z, h_n = torch.chunk(gh, 3, dim=-1)
                r = torch.sigmoid(i_r + h_r)
                z = torch.sigmoid(i_z + h_z)
                n = torch.tanh(i_n + r * h_n)
                h = (1.0 - z) * n + z * h
            cs.append(x)
            x = x + (h @ w_out + b_out)
            xs.append(x)
        return torch.stack(xs, dim=1), torch.stack(cs, dim=1)


def decoder_rollout_kernel(decoder: ResidualDecoder, b, x_start,
                           length: int):
    """A trained LSTM decoder's rollout through the rollout kernel
    (``ops/cuda/rollout.py``): all steps in one launch on CUDA, on operands
    prepared once per decoder and reused while its parameters are
    unchanged; the plain f32 loop on the CPU.  Returns xs (B, length, K) in
    f32."""
    if decoder.rnn_type != "lstm" or decoder.use_nin:
        raise ValueError("the rollout kernel covers LSTM decoders without "
                         "nin only")
    if b.device.type != "cuda":
        return rollout.residual_lstm_rollout(
            b.float(), x_start.float(), *decoder.rollout_params(), length)
    rollout.check_no_grad(decoder.parameters())
    return rollout.residual_lstm_rollout_prepared(
        b.float(), x_start.float(), decoder.rollout_operands(), length)


class ResidualBehaviorNet(nn.Module):
    """The behavior cVAE: infer b from x1, roll out from x2[:, start]."""

    def __init__(self, n_kps: int, dim_hidden_b: int = 1024,
                 decoder_arch: str = "lstm", use_nin_dec: bool = False,
                 information_bottleneck: bool = True, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.n_kps, self.dim_hidden_b = n_kps, dim_hidden_b
        self.decoder_arch, self.use_nin_dec = decoder_arch, use_nin_dec
        self.information_bottleneck = information_bottleneck
        self.b_enc = BehaviorEncoder(n_kps, dim_hidden_b,
                                     ib=information_bottleneck, dtype=dtype,
                                     device=device)
        self.decoder = ResidualDecoder(n_kps, dim_hidden_b,
                                       rnn_type=decoder_arch,
                                       use_nin=use_nin_dec, dtype=dtype,
                                       device=device)

    def forward(self, x1, x2, length: int, start_frame: int = 0,
                sample: bool = False,
                lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None):
        """Returns (xs, cs, b, mu, logstd, pre) with ib, else (xs, cs, b)."""
        out = self.b_enc(x1, lengths, sample=sample, generator=generator,
                         eps=eps)
        b = out[0] if self.information_bottleneck else out
        xs, cs = self.decoder(b, x2[:, start_frame], length)
        if self.information_bottleneck:
            return (xs, cs) + tuple(out)
        return xs, cs, b

    def infer_b(self, s, sample: bool = False,
                lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None):
        return self.b_enc(s, lengths, sample=sample, generator=generator,
                          eps=eps)

    def generate_seq(self, b, x_pose, length: int, start_frame: int = 0):
        return self.decoder(b, x_pose[:, start_frame], length)
