"""Synthetic (appearance, pose) image pairs for the VUNet experiments.

Counterpart of ``behavior_driven_video_synthesis_tpu/data/synthetic_images.py``
with the same keys (``pose_img``, ``stickman``, ``app_img``, ``sample_ids``,
``p_ids`` and, with ``with_reg``, ``reg_imgs`` and ``reg_targets``) and the
same numpy random draws from the same seeds: person palettes, smooth
per-person keypoint trajectories, appearance maps within a person, the
batch order and the regressor picks.  Each person's limbs are coloured
lines and a filled body polygon on a plain background; the stickman is the
skeleton raster of the same keypoints.

The JAX dataset draws with OpenCV on the host.  This one draws with the
package's own raster (``geometry/stickman.py``), so its pixels differ from
the JAX dataset's, and it renders every frame once, in bulk, on ``device``:
a batch is then a gather.  Images are NHWC float32 in [-1, 1].

With ``inplane_normalize`` the appearance ``app_img`` is the 30-channel
part stack (``data/parts.py``) of the ``map_ids`` frame's uint8 render, at
``spatial_size // 2**box_factor``: the homographies are solved on the host
once, and every frame's stack is warped in one pass on the device.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from ..geometry.stickman import (lines_coverage, polygon_mask,
                                 render_stickman)
from .deepfashion import deepfashion_joint_model
from .parts import part_transforms, warp_parts


class SyntheticImageDataset:
    def __init__(self, n_persons: int = 8, frames_per_person: int = 16,
                 spatial_size: int = 64, seed: int = 0,
                 with_reg: bool = False, reg_steps: int = 2,
                 inplane_normalize: bool = False, box_factor: int = 2,
                 device=None):
        self.spatial_size = spatial_size
        self.inplane_normalize = inplane_normalize
        self.box_factor = box_factor
        self.with_reg = with_reg
        self.reg_steps = reg_steps
        self.device = torch.device(device or "cpu")
        self.joint_model = deepfashion_joint_model()
        rng = np.random.RandomState(seed)
        self.rng = rng

        n = n_persons * frames_per_person
        self.p_ids = np.repeat(np.arange(n_persons), frames_per_person)
        self.palettes = rng.randint(60, 255, (n_persons, 4, 3))

        # smooth per-person keypoint trajectories in [0.15, 0.85]
        base = rng.uniform(0.25, 0.75, (n_persons, 18, 2))
        amp = rng.uniform(0.02, 0.08, (n_persons, 18, 2))
        phase = rng.uniform(0, 2 * np.pi, (n_persons, 18, 2))
        t = np.arange(frames_per_person)[:, None, None] / frames_per_person
        kps = (base[:, None] + amp[:, None]
               * np.sin(2 * np.pi * t[None] + phase[:, None]))
        self.norm_keypoints = kps.reshape(n, 18, 2).clip(0.05, 0.95)

        self.map_ids = np.empty(n, np.int64)
        for p in range(n_persons):
            idx = np.where(self.p_ids == p)[0]
            self.map_ids[idx] = rng.permutation(idx)

        self.n = n
        self._render_all()

    def __len__(self):
        return self.n

    def _render_all(self):
        """Every frame's photo and stickman, on the device, in [-1, 1]."""
        S, dev, jm = self.spatial_size, self.device, self.joint_model
        kps = torch.as_tensor(self.norm_keypoints * S, dtype=torch.float32,
                              device=dev)
        grid = torch.arange(S, dtype=torch.float32, device=dev) + 0.5
        py, px = torch.meshgrid(grid, grid, indexing="ij")
        pal = torch.as_tensor(self.palettes[self.p_ids], dtype=torch.float32,
                              device=dev)                        # (n, 4, 3)
        bg = torch.as_tensor(60 + 10 * (self.p_ids % 4), dtype=torch.float32,
                             device=dev)
        photos = bg[:, None, None, None].expand(self.n, S, S, 3).clone()
        half = max(2, S // 24) / 2.0
        for gi, lines in enumerate((jm.right_lines, jm.left_lines, jm.face)):
            cov = lines_coverage(kps, lines, px, py, half) > 0
            photos = torch.where(cov[..., None], pal[:, None, None, gi],
                                 photos)
        verts = kps[:, list(jm.body)]
        poly = polygon_mask(px, py, verts, (verts >= 0).all(-1))
        photos = torch.where(poly[..., None], pal[:, None, None, 3], photos)
        sticks = render_stickman(kps, jm, S, thickness=float(S // 24))
        self.apps = self.photos = photos / 127.5 - 1.0
        if self.inplane_normalize:
            stacks = self.part_stacks(photos.round().to(torch.uint8))
            self.apps = stacks / 127.5 - 1.0
        self.stickmen = sticks / 127.5 - 1.0
        self.keypoints = torch.as_tensor(self.norm_keypoints,
                                         dtype=torch.float32, device=dev)

    def part_stacks(self, renders: torch.Tensor) -> torch.Tensor:
        """Every frame's part stack (n, S', S', 30) uint8 from its uint8
        render (n, S, S, 3) and keypoints."""
        S = self.spatial_size
        part = S // 2 ** self.box_factor
        mats, valid = part_transforms(self.norm_keypoints * S,
                                      self.joint_model, part, S)
        return warp_parts(renders, mats, valid, part)

    def get_batch(self, idx: np.ndarray) -> Dict[str, torch.Tensor]:
        """The items ``idx`` stacked on the device; the regressor picks draw
        from the dataset's stream, item by item, as the JAX dataset's
        ``__getitem__`` does."""
        dev = self.device
        ix = torch.as_tensor(idx, dtype=torch.int64, device=dev)
        batch = {
            "pose_img": self.photos[ix],
            "stickman": self.stickmen[ix],
            "app_img": self.apps[torch.as_tensor(self.map_ids[idx],
                                                 device=dev)],
            "sample_ids": ix,
            "p_ids": torch.as_tensor(self.p_ids[idx], device=dev),
        }
        if self.with_reg:
            picks = np.stack([
                np.concatenate([[i], self.rng.choice(
                    self.n, self.reg_steps - 1, replace=False)])
                for i in idx]).astype(np.int64)
            pk = torch.as_tensor(picks, device=dev)
            batch["reg_imgs"] = self.photos[pk]
            batch["reg_targets"] = self.keypoints[pk]
        return batch

    def batches(self, batch_size: int, seed: int = 0
                ) -> Iterator[Dict[str, torch.Tensor]]:
        order = np.random.RandomState(seed).permutation(self.n)
        for s in range(0, self.n - batch_size + 1, batch_size):
            yield self.get_batch(order[s:s + batch_size])
