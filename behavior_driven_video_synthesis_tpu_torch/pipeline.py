"""The end-to-end behavior-transfer video program.

Counterpart of ``behavior_driven_video_synthesis_tpu/pipeline.py``: flow
inverse -> decoder rollout (the CUDA rollout kernel for LSTM decoders
without nin) -> unnormalize -> camera projection -> stickman raster ->
VUNet (either variant), which encodes the appearance once per video (its
posterior means; the org variant has no logstds) and then runs the shape
encoder and generator per frame in chunks of at most ``vunet_chunk``
frames.  PyTorch runs it eagerly; ``lax.map`` over chunks becomes a loop.

An ``int8_static`` VUNet serves calibrated activation scales:
:meth:`BehaviorTransferPipeline.calibrate` runs the request's own front
stages and one calibration pass of ``transfer_cached`` over all its frames
(in chunks only where one call would not fit the device's memory,
:func:`calibration_fits`), and returns the scales, which ``generate`` and
``reenact`` take.

Each request is one ``request`` span of ``core/trace.py``, tiled by the
stage spans ``flow``, ``rollout``, ``pose``, ``stickman``, ``appearance``
and ``vunet`` (one ``vunet.chunk`` a ``transfer_cached`` call), with
``behavior.encode`` first in ``reenact`` and ``calibrate`` (one
``calibrate.chunk`` a ``calibrate_quant`` call) in place of ``vunet`` in
``calibrate``: every device operation of a request is launched inside a
stage span.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .core import trace
from .geometry.camera import apply_affine_transform, camera_projection
from .geometry.stickman import JointModel, render_stickman
from .models.behavior import decoder_rollout_kernel
from .models.vunet import calibrate_quant
from .ops.nn import load_quant_scales

# At its peak a calibration pass over n frames holds up to this many times
# the bytes of the shape encoder's block outputs for those n frames (the
# skips that du hands dd).  chip_smoke.py phase [24] measures the ratio on
# an H100 at 256 px, VUNet nf 32->128 in bf16, for each int8_static
# request it serves (PERF.md section 6), and fails if a one-call pass
# exceeds this bound.
CALIBRATION_PEAK_PER_SKIP = 4.5


def calibration_skip_bytes(vunet, stick: torch.Tensor) -> int:
    """Bytes of the shape encoder's block outputs for the frames of
    ``stick`` (n, S, S, C): two blocks per scale, each scale half the
    size of the one before."""
    n, S = stick.shape[0], stick.shape[1]
    elem = torch.empty((), dtype=vunet.dtype).element_size()
    return n * elem * sum(c * (-(-S // 2 ** (j // 2))) ** 2
                          for j, c in enumerate(vunet.du.out_channels))


def calibration_fits(vunet, stick: torch.Tensor) -> bool:
    """Whether one calibration call over all of ``stick``'s frames fits
    the memory the device has free (its allocator's cached blocks
    included), by :data:`CALIBRATION_PEAK_PER_SKIP`.  Off CUDA always, as
    the JAX package calibrates in one call."""
    if stick.device.type != "cuda":
        return True
    free, _ = torch.cuda.mem_get_info(stick.device)
    free += (torch.cuda.memory_reserved(stick.device)
             - torch.cuda.memory_allocated(stick.device))
    return (CALIBRATION_PEAK_PER_SKIP * calibration_skip_bytes(vunet, stick)
            <= free)


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
                      image_size, length, use_flow, eps, generator,
                      quant_scales=None):
        """flow inverse -> rollout -> unnormalize -> camera -> raster ->
        appearance encode (once per video), each in its stage span, which
        also takes the stage's inputs to the device."""
        if use_flow and self.flow_model is not None:
            with trace.span("flow"):
                b = self.flow_model.reverse(self._tensor(z))
        else:
            b = z
        with trace.span("rollout"):
            b, x_start = self._tensor(b), self._tensor(x_start)
            if self.use_rollout_kernel:
                xs = decoder_rollout_kernel(self.behavior_model.decoder, b,
                                            x_start, length)  # (B, T, Kn)
            else:
                xs, _ = self.behavior_model.generate_seq(
                    b, x_start[:, None], length)
        with trace.span("pose"):
            world = self._unnormalize(xs.float()).reshape(
                b.shape[0], length, -1, 3)
            px = self._project(world, self._tensor(extrinsics),
                               self._tensor(intrinsics),
                               self._tensor(image_size))
        with trace.span("stickman"):
            # bf16 in [-1, 1] from here on, as in the JAX pipeline: the
            # VUNet serves in bf16, and at B*T frames this is the largest
            # intermediate.  On the card one kernel launch writes it.
            stick = render_stickman(px, self.joint_model, self.spatial_size,
                                    thickness=self.thickness,
                                    frames_per_chunk=self.vunet_chunk,
                                    normalized=True)
        with trace.span("appearance"):
            if quant_scales is not None:
                load_quant_scales(self.vunet, quant_scales)
            means, _ = self.vunet.encode_means(self._tensor(app_img), eps,
                                               generator)
            means_tiled = [torch.repeat_interleave(m, length, dim=0)
                           for m in means]
        return world, px, stick, means_tiled

    @torch.inference_mode()
    def calibrate(self, z, x_start, app_img, extrinsics, intrinsics,
                  image_size, length: int = 50, use_flow: bool = True,
                  eps: Optional[Sequence[torch.Tensor]] = None,
                  generator: Optional[torch.Generator] = None,
                  scales: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Dict[str, torch.Tensor]:
        """One calibration pass for an ``int8_static`` VUNet (JAX
        ``pipeline.py:124-138``): the request's real front stages, then
        ``models.vunet.calibrate_quant`` on its frames' stickmen and
        latents, starting from ``scales`` (none: afresh).  Returns the
        scales, which the VUNet also keeps; pass them to :meth:`generate`.

        The JAX pass is one call over all B*T frames; so is this one
        wherever that fits the device's memory (:func:`calibration_fits`).
        Otherwise it runs chunks of at most ``vunet_chunk`` frames and no
        padding; a conv then quantizes each chunk with that chunk's own
        max, so downstream maxima may differ from the one-call pass
        (ROADMAP, "Recorded")."""
        B = len(z)
        with trace.span("request", self.device, B=B, T=length,
                        frames=B * length):
            _, _, stick, means_tiled = self._front_stages(
                z, x_start, app_img, extrinsics, intrinsics, image_size,
                length, use_flow, eps, generator)
            n = B * length
            with trace.span("calibrate", frames=n):
                flat_stick = stick.reshape((n,) + stick.shape[2:])
                load_quant_scales(self.vunet, scales or {})
                cs = (n if calibration_fits(self.vunet, flat_stick)
                      else self._chunk_size(n)[0])
                for s in range(0, n, cs):
                    with trace.span("calibrate.chunk",
                                    frames=min(cs, n - s)):
                        out = calibrate_quant(
                            self.vunet, [m[s:s + cs] for m in means_tiled],
                            flat_stick[s:s + cs])
        return out

    @torch.inference_mode()
    def generate(self, z, x_start, app_img, extrinsics, intrinsics,
                 image_size, length: int = 50, use_flow: bool = True,
                 eps: Optional[Sequence[torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None,
                 quant_scales: Optional[Dict[str, torch.Tensor]] = None):
        """Generate behavior-transfer videos.

        Args:
          z: (B, H) base-gaussian codes (or behavior latents when not
             use_flow).
          x_start: (B, K_norm) start posture (normalized coords).
          app_img: (B, S', S', C) appearance in [-1, 1]: RGB (C=3), or
             the 30-channel part stack of an inplane VUNet.
          extrinsics: (B, 3, 4); intrinsics: (B, 4); image_size: (B, 2).
          eps / generator: the appearance encoder's posterior noise, one
             tensor per latent scale, or the generator to draw it from.
          quant_scales: an ``int8_static`` VUNet's scales from
             :meth:`calibrate` (default: those the VUNet holds).

        Returns:
          dict with "frames" (B, T, S, S, 3), "stickman" (bf16 in [-1, 1]),
          "poses_3d" (B, T, K, 3) and "keypoints_2d" (B, T, K, 2).
        """
        B = len(z)
        with trace.span("request", self.device, B=B, T=length,
                        frames=B * length):
            return self._generate(z, x_start, app_img, extrinsics,
                                  intrinsics, image_size, length, use_flow,
                                  eps, generator, quant_scales)

    def _generate(self, z, x_start, app_img, extrinsics, intrinsics,
                  image_size, length, use_flow, eps, generator,
                  quant_scales):
        world, px, stick, means_tiled = self._front_stages(
            z, x_start, app_img, extrinsics, intrinsics, image_size,
            length, use_flow, eps, generator, quant_scales)
        B = world.shape[0]
        n = B * length
        cs, n_pad = self._chunk_size(n)
        with trace.span("vunet", frames=n, padding=n_pad - n):
            flat_stick = stick.reshape((n,) + stick.shape[2:])
            if n_pad > n:
                # zero-pad the tail so chunks tile evenly; sliced off below
                def pad(t):
                    return torch.cat(
                        [t, t.new_zeros((n_pad - n,) + t.shape[1:])])
                means_tiled = [pad(m) for m in means_tiled]
                flat_stick = pad(flat_stick)
            chunks = []
            for s in range(0, n_pad, cs):
                with trace.span("vunet.chunk", frames=cs,
                                padding=max(0, s + cs - n)):
                    chunks.append(self.vunet.transfer_cached(
                        [m[s:s + cs] for m in means_tiled],
                        flat_stick[s:s + cs]))
            frames = torch.cat(chunks)[:n]
            frames = frames.reshape((B, length) + frames.shape[1:])
        return {"frames": frames, "stickman": stick, "poses_3d": world,
                "keypoints_2d": px}

    @torch.inference_mode()
    def reenact(self, x_source, x_start, app_img, extrinsics, intrinsics,
                image_size, length: int = 50,
                eps: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                quant_scales: Optional[Dict[str, torch.Tensor]] = None):
        """Transfer the behavior of x_source (B, T, K) onto x_start's
        posture (posterior mean path, no flow)."""
        B = len(x_source)
        with trace.span("request", self.device, B=B, T=length,
                        frames=B * length):
            with trace.span("behavior.encode"):
                _, mu, _, _ = self.behavior_model.infer_b(
                    self._tensor(x_source), sample=False,
                    generator=generator)
            return self._generate(mu, x_start, app_img, extrinsics,
                                  intrinsics, image_size, length, False, eps,
                                  generator, quant_scales)
