"""The end-to-end behavior-transfer video program.

Counterpart of ``behavior_driven_video_synthesis_tpu/pipeline.py``: flow
inverse -> decoder rollout (the CUDA rollout kernel for LSTM decoders
without nin) -> unnormalize -> camera projection -> stickman raster ->
VUNet-alter, which encodes the appearance once per video and then runs the
shape encoder and generator per frame in chunks of at most ``vunet_chunk``
frames.  PyTorch runs it eagerly; ``lax.map`` over chunks becomes a loop.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .geometry.camera import apply_affine_transform, camera_projection
from .geometry.stickman import JointModel, render_stickman
from .models.behavior import decoder_rollout_kernel


class BehaviorTransferPipeline:
    """Bundles the behavior net, the optional flow and the VUNet (modules
    holding their weights) into one video program on the VUNet's device."""

    def __init__(self, behavior_model, vunet, joint_model: JointModel,
                 norm_mean: np.ndarray, norm_std: np.ndarray,
                 dim_to_use: np.ndarray, spatial_size: int = 256,
                 stickman_thickness: float = 5.0, flow_model=None,
                 use_rollout_kernel: bool = True, vunet_chunk: int = 128):
        self.behavior_model = behavior_model
        self.vunet = vunet
        self.flow_model = flow_model
        self.joint_model = joint_model
        self.spatial_size = spatial_size
        self.thickness = stickman_thickness
        # the rollout kernel covers LSTM decoders without nin, wherever the
        # tensors lie (its wrapper runs the plain loop for CPU tensors)
        self.use_rollout_kernel = (
            use_rollout_kernel
            and behavior_model.decoder_arch == "lstm"
            and not behavior_model.use_nin_dec)
        self.device = next(vunet.parameters()).device
        self.norm_mean = self._tensor(norm_mean)
        self.norm_std = self._tensor(norm_std)
        self.dim_to_use = torch.as_tensor(np.asarray(dim_to_use),
                                          dtype=torch.long,
                                          device=self.device)
        self.full_dim = int(np.asarray(norm_mean).shape[0])
        self.vunet_chunk = int(vunet_chunk)

    def _tensor(self, v) -> torch.Tensor:
        return torch.as_tensor(v, dtype=torch.float32, device=self.device)

    def _chunk_size(self, n: int) -> tuple:
        """Pick (chunk_size, padded_n) with chunk_size <= vunet_chunk.

        Prefers an exact divisor in (vunet_chunk/2, vunet_chunk] — no padded
        frames; otherwise pads n up to the next multiple of vunet_chunk so
        an awkward n (e.g. prime B*T) never collapses to tiny chunks and a
        silent throughput cliff."""
        if n <= self.vunet_chunk:
            return n, n
        for cs in range(self.vunet_chunk, self.vunet_chunk // 2, -1):
            if n % cs == 0:
                return cs, n
        cs = self.vunet_chunk
        return cs, ((n + cs - 1) // cs) * cs

    def _unnormalize(self, flat):
        full = torch.zeros(flat.shape[:-1] + (self.full_dim,),
                           dtype=flat.dtype, device=flat.device)
        full[..., self.dim_to_use] = flat
        return full * self.norm_std + self.norm_mean

    def _project(self, world_kps, extrinsics, intrinsics, image_size):
        """world (B, T, K, 3) -> stickman-pixel coords (B, T, K, 2)."""
        cam = apply_affine_transform(world_kps,
                                     extrinsics[:, None, None, :, :])
        px = camera_projection(cam, intrinsics[:, None, :])
        scale = self.spatial_size / image_size  # (B, 2)
        return px * scale[:, None, None, :]

    def _front_stages(self, z, x_start, app_img, extrinsics, intrinsics,
                      image_size, length, use_flow, eps, generator):
        """flow inverse -> rollout -> unnormalize -> camera -> raster ->
        appearance encode (once per video)."""
        B = z.shape[0]
        if use_flow and self.flow_model is not None:
            b = self.flow_model.reverse(z)
        else:
            b = z
        if self.use_rollout_kernel:
            xs = decoder_rollout_kernel(self.behavior_model.decoder, b,
                                        x_start, length)      # (B, T, Kn)
        else:
            xs, _ = self.behavior_model.generate_seq(b, x_start[:, None],
                                                     length)
        world = self._unnormalize(xs.float()).reshape(B, length, -1, 3)
        px = self._project(world, extrinsics, intrinsics, image_size)
        stick = render_stickman(px, self.joint_model, self.spatial_size,
                                thickness=self.thickness,
                                frames_per_chunk=self.vunet_chunk)
        # bf16 from here on, as in the JAX pipeline: the VUNet serves in
        # bf16, and at B*T frames this is the largest intermediate.  The
        # JAX package writes stick / 127.5 - 1; for stick = 127 that lies
        # within an f32 rounding error of a bf16 rounding midpoint, and
        # CUDA divides by a scalar as a reciprocal multiply, which lands on
        # the other side.  (stick - 127.5) / 127.5 gives the same bf16
        # values as the JAX package either way.
        stick = ((stick - 127.5) / 127.5).to(torch.bfloat16)
        means, _ = self.vunet.encode_means(app_img, eps, generator)
        means_tiled = [torch.repeat_interleave(m, length, dim=0)
                       for m in means]
        return world, px, stick, means_tiled

    @torch.inference_mode()
    def generate(self, z, x_start, app_img, extrinsics, intrinsics,
                 image_size, length: int = 50, use_flow: bool = True,
                 eps: Optional[Sequence[torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None):
        """Generate behavior-transfer videos.

        Args:
          z: (B, H) base-gaussian codes (or behavior latents when not
             use_flow).
          x_start: (B, K_norm) start posture (normalized coords).
          app_img: (B, S, S, 3) appearance image in [-1, 1].
          extrinsics: (B, 3, 4); intrinsics: (B, 4); image_size: (B, 2).
          eps / generator: the appearance encoder's posterior noise, one
             tensor per latent scale, or the generator to draw it from.

        Returns:
          dict with "frames" (B, T, S, S, 3), "stickman" (bf16 in [-1, 1]),
          "poses_3d" (B, T, K, 3) and "keypoints_2d" (B, T, K, 2).
        """
        z, x_start, app_img, extrinsics, intrinsics, image_size = (
            self._tensor(v) for v in (z, x_start, app_img, extrinsics,
                                      intrinsics, image_size))
        world, px, stick, means_tiled = self._front_stages(
            z, x_start, app_img, extrinsics, intrinsics, image_size,
            length, use_flow, eps, generator)
        B = z.shape[0]
        n = B * length
        flat_stick = stick.reshape((n,) + stick.shape[2:])
        cs, n_pad = self._chunk_size(n)
        if n_pad > n:
            # zero-pad the tail so chunks tile evenly; sliced off below
            def pad(t):
                return torch.cat([t, t.new_zeros((n_pad - n,) + t.shape[1:])])
            means_tiled = [pad(m) for m in means_tiled]
            flat_stick = pad(flat_stick)
        frames = torch.cat([
            self.vunet.transfer_cached([m[s:s + cs] for m in means_tiled],
                                       flat_stick[s:s + cs])
            for s in range(0, n_pad, cs)])[:n]
        frames = frames.reshape((B, length) + frames.shape[1:])
        return {"frames": frames, "stickman": stick, "poses_3d": world,
                "keypoints_2d": px}

    @torch.inference_mode()
    def reenact(self, x_source, x_start, app_img, extrinsics, intrinsics,
                image_size, length: int = 50,
                eps: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
        """Transfer the behavior of x_source (B, T, K) onto x_start's
        posture (posterior mean path, no flow)."""
        _, mu, _, _ = self.behavior_model.infer_b(
            self._tensor(x_source), sample=False, generator=generator)
        return self.generate(mu, x_start, app_img, extrinsics, intrinsics,
                             image_size, length=length, use_flow=False,
                             eps=eps, generator=generator)
