"""The figures and videos of the behavior and MT-VAE experiments.

Counterpart of ``behavior_driven_video_synthesis_tpu/experiments/
visualize.py``.  Each figure runs its device work first and then draws and
encodes on the host:

* sequence figures (the ``-v`` hooks): the rollouts run batched on the
  device and return world poses (``transfer3d_rollouts``,
  ``interpolation_rollouts``, ``startpose_grid_rollouts``,
  ``mtvae_rollouts``, each (..., T, K, 3) numpy); ``visualize_transfer3d``,
  ``latent_interpolate_videos``, ``make_behavior_startpose_grid`` and
  ``visualize_mtvae`` draw them as 3-D skeleton videos
  (``viz/videos.py:create_video_3d``) and write mp4s;
* RGB figures (``-s``): ``render_rgb_videos``, ``make_enrollment_figures``,
  ``latent_interpolate_eval_figures`` and
  ``sample_examples_single_figures`` run ``BehaviorTransferPipeline``'s
  ``generate`` or ``reenact`` once each, with the batch the JAX function
  gives (cameras x interpolation steps, 2 + n samples from one start
  pose), and write PNG filmstrips and mp4s;
* inputs: ``get_synth_input[_all_cameras]`` (the appearance and camera of
  a dataset frame), and ``load_run_checkpoint`` / ``load_synth_params``,
  which read a synthesis run of this package (``-s``).

The JAX functions take a PRNG key; these take a ``torch.Generator`` for
every draw, or the draws themselves (``eps``, ``z``, ``noise``), which a
test hands over from the JAX run.  Where a JAX function takes ``params``
the pipeline's modules hold the weights here.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.checkpoint import CheckpointManager
from ..core.config import load_config
from ..geometry.normalization import unnormalize
from ..viz.latent import latent_interpolate
from ..viz.videos import (create_video_3d, filmstrip, frames_to_uint8,
                          make_eval_grid, save_png, write_video)

ORG_SYNTH_FAULT = (
    "-s of an org-VUNet synthesis run (experiment 'vunet') is refused "
    "(ROADMAP C17): the JAX figures feed its VUNet RGB appearances where "
    "it takes 30-channel part stacks, and its transfer asks for a 'sample' "
    "rng (C3), so the JAX run skips the render; give -s a cvbae run")


def _device(module) -> torch.device:
    return next(module.parameters()).device


def _as(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def to_world(flat: torch.Tensor, norm_stats=None) -> np.ndarray:
    """(..., K) normalized keypoints -> (..., K_full / 3, 3) numpy world
    poses (unnormalized when ``norm_stats`` is given)."""
    flat = flat.float()
    if norm_stats is not None:
        flat = unnormalize(flat, norm_stats)
    arr = flat.cpu().numpy()
    return arr.reshape(arr.shape[:-1] + (-1, 3))


@torch.no_grad()
def _mu(net, seq) -> torch.Tensor:
    """The posterior mean of seq (its noise is not used)."""
    zeros = torch.zeros(seq.shape[0], net.dim_hidden_b, device=seq.device)
    return net.infer_b(seq, eps=zeros)[1].float()


def _equal_t(vids):
    t = min(v.shape[0] for v in vids)
    return [v[:t] for v in vids]


# -- sequence figures (the -v hooks) ----------------------------------------


@torch.no_grad()
def transfer3d_rollouts(net, batch, seq_len: int, norm_stats=None,
                        flow=None, n_vids: int = 2, n_samples: int = 3,
                        generator: Optional[torch.Generator] = None,
                        eps: Optional[torch.Tensor] = None,
                        z: Optional[torch.Tensor] = None
                        ) -> Dict[str, np.ndarray]:
    """World poses of the first ``n_vids`` sequences: "gt" (B, T, K, 3),
    the self reconstruction "recon" (posterior noise ``eps`` (B, H)), the
    behavior swap "swap" (the sequence's mean from the paired sequence's
    start) and "samples" (B, n_samples, T, K, 3) from codes ``z``
    (B * n_samples, H), through the flow's reverse when given."""
    dev = _device(net)
    kps = _as(batch["keypoints"], dev)[:n_vids]
    cross = _as(batch.get("paired_keypoints", batch["keypoints"]),
                dev)[:n_vids]
    B, H = kps.shape[0], net.dim_hidden_b
    seq_s, seq_t = kps[:, :-1], cross[:, :-1]
    x_recon, _, _, mu, _, _ = net(seq_s, seq_s, seq_len, generator=generator,
                                  eps=eps)
    x_swap, _ = net.generate_seq(mu, seq_t, seq_len)
    if z is None:
        z = torch.randn(B * n_samples, H, generator=generator, device=dev)
    b = z.to(dev) if flow is None else flow.reverse(z.to(dev))
    starts = seq_s.repeat_interleave(n_samples, dim=0)
    x_samp, _ = net.generate_seq(b, starts[:, :1], seq_len)
    return {"gt": to_world(kps[:, 1:], norm_stats),
            "recon": to_world(x_recon, norm_stats),
            "swap": to_world(x_swap, norm_stats),
            "samples": to_world(x_samp.float().reshape(
                B, n_samples, seq_len, -1), norm_stats)}


def visualize_transfer3d(net, batch, out_dir: str, seq_len: int,
                         norm_stats=None, flow=None, n_vids: int = 2,
                         n_samples: int = 3, fps: int = 12, tag: str = "",
                         generator: Optional[torch.Generator] = None,
                         eps=None, z=None) -> Dict[str, str]:
    """Per sequence, ``<tag>seq<i>_transfer.mp4`` (rows: ground truth,
    reconstruction, swap) and ``<tag>seq<i>_samples.mp4`` (one row a
    sample); returns {name: path}."""
    w = transfer3d_rollouts(net, batch, seq_len, norm_stats, flow, n_vids,
                            n_samples, generator, eps, z)
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for i in range(w["gt"].shape[0]):
        name = f"{tag}seq{i}"
        grid = make_eval_grid([create_video_3d(w[k][i], fps=fps)
                               for k in ("gt", "recon", "swap")])
        paths[f"{name}_transfer"] = write_video(
            grid.astype(np.uint8),
            os.path.join(out_dir, f"{name}_transfer.mp4"), fps=fps)
        rows = [create_video_3d(w["samples"][i, s], fps=fps)
                for s in range(n_samples)]
        paths[f"{name}_samples"] = write_video(
            make_eval_grid(rows).astype(np.uint8),
            os.path.join(out_dir, f"{name}_samples.mp4"), fps=fps)
    return paths


@torch.no_grad()
def interpolation_rollouts(net, batch, seq_len: int, norm_stats=None,
                           n_steps: int = 5) -> np.ndarray:
    """(n_steps, T, K, 3) world poses: the slerp path between the first
    two sequences' posterior means, each decoded from the first
    sequence's start pose."""
    dev = _device(net)
    seq = _as(batch["keypoints"], dev)[:2, :-1]
    mu = _mu(net, seq).cpu().numpy()
    path_b = torch.as_tensor(latent_interpolate(mu[0], mu[1], n_steps),
                             dtype=torch.float32, device=dev)
    xs, _ = net.generate_seq(path_b, seq[0:1, 0:1].repeat(n_steps, 1, 1),
                             seq_len)
    return to_world(xs, norm_stats)


def latent_interpolate_videos(net, batch, out_dir: str, seq_len: int,
                              norm_stats=None, n_steps: int = 5,
                              fps: int = 12, tag: str = "") -> str:
    """``<tag>latent_interp.mp4``: one row an interpolant; returns its
    path."""
    world = interpolation_rollouts(net, batch, seq_len, norm_stats, n_steps)
    rows = [create_video_3d(world[i], fps=fps) for i in range(n_steps)]
    os.makedirs(out_dir, exist_ok=True)
    return write_video(make_eval_grid(rows).astype(np.uint8),
                       os.path.join(out_dir, f"{tag}latent_interp.mp4"),
                       fps=fps)


@torch.no_grad()
def startpose_grid_rollouts(net, batch, seq_len: int, norm_stats=None,
                            n_behaviors: int = 3, n_starts: int = 3):
    """(grid (R, C, T, K, 3), ground truth (B, T, K, 3)) world poses:
    behavior r (sequence r's mean) from start pose c (sequence c's first
    frame), all R x C rollouts in one batched call."""
    dev = _device(net)
    seqs = _as(batch["keypoints"], dev)[:, :-1]
    n_behaviors = min(n_behaviors, seqs.shape[0])
    n_starts = min(n_starts, seqs.shape[0])
    mu = _mu(net, seqs[:n_behaviors])
    b = mu.repeat_interleave(n_starts, dim=0)
    starts = seqs[:n_starts, 0].repeat(n_behaviors, 1)
    xs, _ = net.generate_seq(b, starts[:, None], seq_len)
    grid = xs.float().reshape(n_behaviors, n_starts, seq_len, -1)
    return to_world(grid, norm_stats), to_world(seqs, norm_stats)


def make_behavior_startpose_grid(net, batch, out_dir: str, seq_len: int,
                                 norm_stats=None, n_behaviors: int = 3,
                                 n_starts: int = 3, fps: int = 12,
                                 tag: str = "") -> str:
    """``<tag>eval_grid.mp4``: row 0 the start poses' sequences (after a
    blank cell), then per behavior its source and its rollouts from each
    start pose; returns its path."""
    grid_w, gt_w = startpose_grid_rollouts(net, batch, seq_len, norm_stats,
                                           n_behaviors, n_starts)
    n_behaviors, n_starts = grid_w.shape[:2]
    header = [create_video_3d(gt_w[c], fps=fps) for c in range(n_starts)]
    rows = [np.concatenate(_equal_t([np.full_like(header[0], 255)]
                                    + header), axis=2)]
    for r in range(n_behaviors):
        cells = [create_video_3d(gt_w[r], fps=fps)]
        cells += [create_video_3d(grid_w[r, c], fps=fps)
                  for c in range(n_starts)]
        rows.append(np.concatenate(_equal_t(cells), axis=2))
    os.makedirs(out_dir, exist_ok=True)
    return write_video(np.concatenate(_equal_t(rows), axis=1).astype(
        np.uint8), os.path.join(out_dir, f"{tag}eval_grid.mp4"), fps=fps)


@torch.no_grad()
def mtvae_rollouts(model, batch, norm_stats=None, n_vids: int = 2,
                   n_samples: int = 3,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[Sequence[Dict[str, torch.Tensor]]] = None
                   ) -> Dict[str, np.ndarray]:
    """World poses of the first ``n_vids`` sequences: "gt" (the frames
    after the conditioning prefix), the posterior reconstruction "recon"
    and "samples" (B, n_samples, T, K, 3) from the prior.  ``noise`` holds
    one forward's draws each, the reconstruction's first (drawn from
    ``generator`` when not given)."""
    dev = _device(model)
    kps = _as(batch["keypoints"], dev)[:n_vids]
    cross = _as(batch.get("paired_keypoints", batch["keypoints"]),
                dev)[:n_vids]
    B = kps.shape[0]
    if noise is None:
        noise = [model.draw_noise(B, generator, dev)
                 for _ in range(1 + n_samples)]
    recon = model(kps, cross, noise=noise[0])[0].float()
    samples = torch.stack([model(kps, cross, sample_prior=True,
                                 noise=noise[1 + s])[0].float()
                           for s in range(n_samples)], 1)
    return {"gt": to_world(kps[:, model.n_cond:], norm_stats),
            "recon": to_world(recon, norm_stats),
            "samples": to_world(samples, norm_stats)}


def visualize_mtvae(model, batch, out_dir: str, norm_stats=None,
                    n_vids: int = 2, n_samples: int = 3, fps: int = 12,
                    tag: str = "",
                    generator: Optional[torch.Generator] = None,
                    noise=None) -> Dict[str, str]:
    """Per sequence ``<tag>mtvae_seq<i>.mp4``: rows ground truth,
    reconstruction and the prior samples; returns {name: path}."""
    w = mtvae_rollouts(model, batch, norm_stats, n_vids, n_samples,
                       generator, noise)
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for i in range(w["gt"].shape[0]):
        rows = [create_video_3d(w["gt"][i], fps=fps),
                create_video_3d(w["recon"][i], fps=fps)]
        rows += [create_video_3d(w["samples"][i, s], fps=fps)
                 for s in range(n_samples)]
        paths[f"{tag}mtvae_seq{i}"] = write_video(
            make_eval_grid(rows).astype(np.uint8),
            os.path.join(out_dir, f"{tag}mtvae_seq{i}.mp4"), fps=fps)
    return paths


# -- RGB figures through the pipeline (-s) ----------------------------------


def _uint8(t: torch.Tensor) -> np.ndarray:
    return frames_to_uint8(t.float().cpu().numpy())


def render_rgb_videos(pipeline, z, x_start, app_img, extrinsics, intrinsics,
                      image_size, out_dir: str, length: int = 50,
                      fps: int = 12, tag: str = "rgb",
                      generator: Optional[torch.Generator] = None,
                      eps=None) -> Dict[str, str]:
    """One ``pipeline.generate`` call; per video ``<tag><i>.mp4`` (the
    stickman beside the frames); returns {name: path}."""
    os.makedirs(out_dir, exist_ok=True)
    out = pipeline.generate(z, x_start, app_img, extrinsics, intrinsics,
                            image_size, length=length, eps=eps,
                            generator=generator)
    frames, stick = _uint8(out["frames"]), _uint8(out["stickman"])
    return {f"{tag}{i}": write_video(
        np.concatenate([stick[i], frames[i]], axis=2),
        os.path.join(out_dir, f"{tag}{i}.mp4"), fps=fps)
        for i in range(frames.shape[0])}


def make_enrollment_figures(pipeline, x_source, x_start, apps, extrs, intrs,
                            image_sizes, out_dir: str, length: int = 50,
                            disc_step: int = 6, tag: str = "bid0-sid0",
                            generator: Optional[torch.Generator] = None,
                            eps=None) -> Dict[str, str]:
    """``x_source``'s (T, K) behavior re-enacted from ``x_start`` (K,)
    under every camera in one ``pipeline.reenact`` call (apps (C, S, S,
    3), extrs (C, 3, 4), intrs (C, 4), image_sizes (C, 2)); writes
    ``enrollment-<tag>.png`` (stickman filmstrips, one row a camera),
    ``enrollment-rgb-<tag>.png``, ``enrollment-overlay-<tag>.png`` and
    ``enrollment_vid-<tag>.mp4`` (cameras side by side, stickman over RGB).
    """
    C = int(np.asarray(extrs).shape[0])
    dev = pipeline.device
    src = _as(x_source, dev)[None].repeat(C, 1, 1)
    start = _as(x_start, dev)[None].repeat(C, 1)
    out = pipeline.reenact(src, start, apps, extrs, intrs, image_sizes,
                           length=length, eps=eps, generator=generator)
    frames, stick = _uint8(out["frames"]), _uint8(out["stickman"])
    os.makedirs(out_dir, exist_ok=True)
    stick_rows = np.concatenate(
        [filmstrip(stick[c], disc_step) for c in range(C)], axis=0)
    rgb_rows = np.concatenate(
        [filmstrip(frames[c], disc_step) for c in range(C)], axis=0)
    overlay = (0.5 * stick_rows.astype(np.float32)
               + 0.5 * rgb_rows.astype(np.float32)).astype(np.uint8)
    paths = {
        "kps": save_png(stick_rows,
                        os.path.join(out_dir, f"enrollment-{tag}.png")),
        "rgb": save_png(rgb_rows,
                        os.path.join(out_dir, f"enrollment-rgb-{tag}.png")),
        "overlay": save_png(overlay, os.path.join(
            out_dir, f"enrollment-overlay-{tag}.png"))}
    vid = np.concatenate(
        [np.concatenate([stick[c], frames[c]], axis=1) for c in range(C)],
        axis=2)
    paths["video"] = write_video(
        vid, os.path.join(out_dir, f"enrollment_vid-{tag}.mp4"), fps=12)
    return paths


def _two_means(net, kps1, kps2):
    dev = _device(net)
    return (_mu(net, _as(kps1, dev)[None, :-1]),
            _mu(net, _as(kps2, dev)[None, :-1]))


def latent_interpolate_eval_figures(pipeline, behavior_model, kps1, kps2,
                                    apps, extrs, intrs, image_sizes,
                                    out_dir: str, n_steps: int = 6,
                                    length: int = 50, disc_step: int = 6,
                                    tag: str = "",
                                    generator: Optional[
                                        torch.Generator] = None,
                                    eps=None) -> Dict[str, str]:
    """Slerp and linear paths between the means of sequences ``kps1`` and
    ``kps2`` (T, K), decoded from kps1's start pose under every camera:
    per path one ``pipeline.generate`` call of n_steps x C videos; per
    camera ``<tag>interp-<path>-cam<c>.png`` (one row a step) and
    ``.mp4`` (the steps side by side)."""
    mu1, mu2 = _two_means(behavior_model, kps1, kps2)
    m1, m2 = mu1[0].cpu().numpy(), mu2[0].cpu().numpy()
    vals = np.linspace(0.0, 1.0, n_steps)
    paths_b = (("slerp", latent_interpolate(m1, m2, n_steps)),
               ("linear", np.stack([(1 - v) * m1 + v * m2 for v in vals])))
    C = int(np.asarray(extrs).shape[0])
    dev = pipeline.device
    start = _as(kps1, dev)[0][None].repeat(n_steps * C, 1)
    cams = [_as(a, dev) for a in (apps, extrs, intrs, image_sizes)]
    cams = [a.repeat((n_steps,) + (1,) * (a.dim() - 1)) for a in cams]
    os.makedirs(out_dir, exist_ok=True)
    paths: Dict[str, str] = {}
    for name, bs in paths_b:
        out = pipeline.generate(np.repeat(bs, C, axis=0), start, *cams,
                                length=length, use_flow=False, eps=eps,
                                generator=generator)
        frames = _uint8(out["frames"])
        frames = frames.reshape((n_steps, C) + frames.shape[1:])
        for c in range(C):
            strip = np.concatenate([filmstrip(frames[s, c], disc_step)
                                    for s in range(n_steps)], axis=0)
            paths[f"{name}_cam{c}_png"] = save_png(strip, os.path.join(
                out_dir, f"{tag}interp-{name}-cam{c}.png"))
            paths[f"{name}_cam{c}_mp4"] = write_video(
                np.concatenate(list(frames[:, c]), axis=2), os.path.join(
                    out_dir, f"{tag}interp-{name}-cam{c}.mp4"), fps=12)
    return paths


@torch.no_grad()
def sample_examples_single_figures(pipeline, behavior_model, kps1, kps2,
                                   app, extr, intr, image_size,
                                   out_dir: str, n_samples: int = 4,
                                   length: int = 50, disc_step: int = 6,
                                   use_flow: bool = True, tag: str = "sid0",
                                   generator: Optional[
                                       torch.Generator] = None,
                                   eps=None, z=None) -> Dict[str, str]:
    """From kps1's start pose, in one ``pipeline.generate`` call: kps1's
    own mean, kps2's mean and ``n_samples`` codes ``z`` (through the
    pipeline's flow with ``use_flow``); writes
    ``sid_<tag>/samples-<tag>.png`` (one row a video) and ``.mp4``."""
    mu1, mu2 = _two_means(behavior_model, kps1, kps2)
    dev = pipeline.device
    if z is None:
        z = torch.randn(n_samples, mu1.shape[-1], generator=generator,
                        device=dev)
    z = _as(z, dev)
    bz = (pipeline.flow_model.reverse(z)
          if use_flow and pipeline.flow_model is not None else z)
    b_all = torch.cat([mu1, mu2, bz.float()])
    n_rows = int(b_all.shape[0])

    def rows(a):
        a = _as(a, dev)[None]
        return a.repeat((n_rows,) + (1,) * (a.dim() - 1))

    start = _as(kps1, dev)[0][None].repeat(n_rows, 1)
    out = pipeline.generate(b_all, start, rows(app), rows(extr), rows(intr),
                            rows(image_size), length=length, use_flow=False,
                            eps=eps, generator=generator)
    frames = _uint8(out["frames"])
    sid_dir = os.path.join(out_dir, f"sid_{tag}")
    os.makedirs(sid_dir, exist_ok=True)
    strip = np.concatenate([filmstrip(frames[r], disc_step)
                            for r in range(n_rows)], axis=0)
    return {"png": save_png(strip, os.path.join(sid_dir,
                                                f"samples-{tag}.png")),
            "mp4": write_video(np.concatenate(list(frames), axis=2),
                               os.path.join(sid_dir, f"samples-{tag}.mp4"),
                               fps=12)}


# -- inputs: dataset frames and synthesis runs -------------------------------


def _complete(dataset):
    dd = getattr(dataset, "complete_datadict", None)
    return dd if dd is not None else dataset.datadict


def get_synth_input(dataset, idx: int, spatial_size: int = 0):
    """(appearance in [-1, 1] (S, S, 3) float32, extrinsics (3, 4),
    intrinsics (4,), image size (2,)) of frame ``idx`` of the dataset's
    complete datadict (the one its cameras index), the image resized
    bilinearly to ``spatial_size`` (the dataset's own size when 0)."""
    import cv2

    dd = _complete(dataset)
    img = cv2.imread(str(dd["img_paths"][idx]))
    if img is None:
        raise FileNotFoundError(dd["img_paths"][idx])
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    size = int(spatial_size) if spatial_size else dataset.spatial_size
    if img.shape[0] != size or img.shape[1] != size:
        img = cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)
    return (dataset._to_float(img),
            np.asarray(dd["extrinsics_univ"][idx], np.float32),
            np.asarray(dd["intrinsics_univ"][idx], np.float32),
            np.asarray(dd["image_size"][idx], np.float32))


def get_synth_input_all_cameras(dataset, rng=None, spatial_size: int = 0):
    """:func:`get_synth_input` once per distinct camera, stacked: one
    random person (``rng``, RandomState(0) by default) seen from each
    camera, or the camera's first frame where that person is not seen;
    ``get_synth_input(dataset, 0)`` alone where the dataset has no camera
    or person ids."""
    rng = rng or np.random.RandomState(0)
    dd = _complete(dataset)
    persons = np.unique(dd["p_ids"]) if "p_ids" in dd else np.empty(0)
    if ("camera_id" not in dd or "extrinsics_univ" not in dd
            or persons.size == 0):
        return tuple(a[None] for a in get_synth_input(dataset, 0,
                                                      spatial_size))
    tpid = persons[rng.randint(len(persons))]
    out = []
    for cam in np.unique(dd["camera_id"]):
        sel = np.nonzero((dd["p_ids"] == tpid) & (dd["camera_id"] == cam))[0]
        if sel.size == 0:
            sel = np.nonzero(dd["camera_id"] == cam)[0]
        out.append(get_synth_input(dataset, int(sel[0]), spatial_size))
    return tuple(np.stack(a) for a in zip(*out))


def resolve_run_checkpoint(run_dir: str, role: str):
    """(the role's checkpoint directory, the run's config.yaml or None) of
    a run directory, tried in the JAX package's order: ``<run>/ckpt/
    <role>``, ``<run>/<role>`` (a project's ckpt directory, its config
    at ``<exp>/config/<project>/config.yaml``), ``<run>`` itself, then
    each ``<run>/ckpt/<project>/<role>`` of an experiment directory.  The
    first with a save wins; FileNotFoundError when none has one."""
    run_dir = os.path.normpath(run_dir)
    direct_cfg = os.path.join(run_dir, "config", "config.yaml")
    sibling_cfg = os.path.join(os.path.dirname(os.path.dirname(run_dir)),
                               "config", os.path.basename(run_dir),
                               "config.yaml")
    candidates: List = [
        (os.path.join(run_dir, "ckpt", role), [direct_cfg]),
        (os.path.join(run_dir, role), [direct_cfg, sibling_cfg]),
        (run_dir, [direct_cfg, sibling_cfg])]
    exp_ckpt = os.path.join(run_dir, "ckpt")
    if os.path.isdir(exp_ckpt):
        candidates += [(os.path.join(exp_ckpt, prj, role),
                        [os.path.join(run_dir, "config", prj,
                                      "config.yaml")])
                       for prj in sorted(os.listdir(exp_ckpt))]
    for cand, cfg_paths in candidates:
        if (os.path.isdir(cand)
                and CheckpointManager(cand).latest_step() is not None):
            return cand, next((p for p in cfg_paths if os.path.exists(p)),
                              None)
    raise FileNotFoundError(f"no '{role}' checkpoint under {run_dir}")


def load_run_checkpoint(run_dir: str, role: str):
    """(the newest save of ``role`` as saved, the run's config or None) of
    a run directory (:func:`resolve_run_checkpoint`)."""
    cand, cfg_path = resolve_run_checkpoint(run_dir, role)
    payload, _ = CheckpointManager(cand).restore_latest(map_location="cpu")
    return payload, (load_config(cfg_path) if cfg_path else None)


def synth_run_config(run_dir: str) -> Optional[dict]:
    """The config of a synthesis run directory (None without one);
    ValueError for an org run (ROADMAP C17)."""
    _, cfg_path = resolve_run_checkpoint(run_dir, "reg_ckpt")
    config = load_config(cfg_path) if cfg_path else None
    if (config or {}).get("general", {}).get("experiment") == "vunet":
        raise ValueError(ORG_SYNTH_FAULT)
    return config


def load_synth_params(run_dir: str, device=None):
    """(the cvbae VUNet of a synthesis run of this package, in eval mode,
    with its newest ``reg_ckpt`` weights; the run's config), built by
    ``vunet_from_config`` from the run's dumped config."""
    from ..models.vunet import vunet_from_config

    config = synth_run_config(run_dir)
    payload, _ = load_run_checkpoint(run_dir, "reg_ckpt")
    vunet = vunet_from_config(config, "alter", remat=False, device=device)
    vunet.load_state_dict(payload["modules"]["vunet"])
    return vunet.eval().requires_grad_(False), config
