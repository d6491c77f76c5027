"""The MT-VAE baseline (Yan et al.), the paper's comparison model.

Counterpart of ``behavior_driven_video_synthesis_tpu/models/mtvae.py``
(``MTVAE``, :24-116), with the reference's state-dict names
(``lstm_enc``, ``lstm_dec``, ``latent_enc``, ``latent_dec``,
``make_keypoints``, ``inv_z``, ``make_h_dec``, ``make_c_dec``).  The
reference also declares ``make_mu`` and ``cov``, which its forward never
calls; this module has neither, so a reference state dict loads once those
keys are dropped (as ``convert_mtvae`` drops them).

An LSTM encodes the condition segment (the first ``n_cond`` frames), the
future segment and the target sequence, each from the same random initial
state (h0, c0); an FCResnet maps the difference of the future's and the
condition's encodings to (mu, logstd).  The latent (a posterior sample, or
with ``sample_prior`` a N(0, 1) code) goes through ``inv_z`` and the
``latent_dec`` FCResnet beside the reference encoding (the condition's, or
with ``transfer`` the target's) and, after a residual add and a layer norm
without parameters, is the decoder's input: fed the same at each of the
future's steps, from an initial state projected from it and the reference
encoding.  The cycle output re-encodes the decoder input against the
condition.  Products run in ``dtype`` (bf16 for ``training.bf16``) while
the parameters stay float32.

The draws are the encoders' (h0, c0), the latent's noise "z" and the cycle
noise "cycle" (:meth:`MTVAE.noise_shapes`): drawn from a
``torch.Generator`` in that order, or handed in as ``noise``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..ops.recurrent import LSTM
from ..ops import batch_draws
from .probes import FCResnet, linear

NOISE_SITES = ("h0", "c0", "z", "cycle")


class MTVAE(nn.Module):
    def __init__(self, n_in: int, n_cond: int = 10, dim: int = 1024,
                 z_dim: int = 512, dtype=torch.float32, device=None):
        super().__init__()
        self.n_in, self.n_cond, self.dim = n_in, n_cond, dim
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.lstm_enc = LSTM(n_in, dim, **kw)
        self.lstm_dec = LSTM(dim, dim, **kw)
        self.latent_enc = FCResnet(dim, dim, **kw)
        self.latent_dec = FCResnet(z_dim + dim, dim, **kw)
        self.make_keypoints = nn.Linear(dim, n_in, device=device)
        self.inv_z = nn.Linear(dim // 2, z_dim, device=device)
        self.make_h_dec = nn.Linear(2 * dim, dim, device=device)
        self.make_c_dec = nn.Linear(2 * dim, dim, device=device)

    def noise_shapes(self, batch: int) -> Dict[str, tuple]:
        half = self.dim // 2
        return {"h0": (batch, self.dim), "c0": (batch, self.dim),
                "z": (batch, half), "cycle": (batch, half)}

    def draw_noise(self, batch: int, generator=None, device=None
                   ) -> Dict[str, torch.Tensor]:
        return {k: batch_draws.randn(s, generator=generator, device=device)
                for k, s in self.noise_shapes(batch).items()}

    def _encode(self, seq, h0c0):
        return self.lstm_enc(seq, initial_carry=h0c0,
                             return_sequences=False)[1][0]

    def _latent_params(self, e):
        params = self.latent_enc(e)
        half = params.shape[-1] // 2
        return params[..., :half], params[..., half:]

    def forward(self, input_source, input_tgt, transfer: bool = False,
                sample_prior: bool = False,
                noise: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
        """input_source (B, T, n_in), input_tgt (B, T', n_in) -> (keypoints
        (B, T - n_cond, n_in), mu, logstd, the cycle sample)."""
        dt = self.dtype
        if noise is None:
            noise = self.draw_noise(input_source.shape[0], generator,
                                    input_source.device)
        seq_a = input_source[:, :self.n_cond]
        seq_b = input_source[:, self.n_cond:]
        h0c0 = (noise["h0"], noise["c0"])
        e_a = self._encode(seq_a, h0c0)
        e_b = self._encode(seq_b, h0c0)
        e_c = self._encode(input_tgt, h0c0)

        mu, logstd = self._latent_params(e_b - e_a)
        eps = noise["z"].to(mu.dtype)
        z = eps if sample_prior else mu + torch.exp(logstd) * eps

        e_ref = e_c if transfer else e_a
        dec_in = self.latent_dec(torch.cat(
            [linear(self.inv_z, z, dt), e_ref], dim=-1)) + e_ref
        # no parameters; the biased variance, as jnp.var
        mean = dec_in.mean(dim=-1, keepdim=True)
        var = dec_in.var(dim=-1, keepdim=True, correction=0)
        dec_in = (dec_in - mean) * torch.rsqrt(var + 1e-5)

        mu_c, logstd_c = self._latent_params(dec_in - e_a)
        out_cycle = mu_c + torch.exp(logstd_c) * noise["cycle"].to(
            mu_c.dtype)

        pre_dec = torch.cat([e_ref, dec_in], dim=-1)
        h0_dec = torch.tanh(linear(self.make_h_dec, pre_dec, dt))
        c0_dec = linear(self.make_c_dec, pre_dec, dt)
        out_dec, _ = self.lstm_dec(dec_in, initial_carry=(h0_dec, c0_dec),
                                   static_steps=seq_b.shape[1])
        return (linear(self.make_keypoints, out_dec, dt), mu, logstd,
                out_cycle)
