"""The appearance and camera inputs of RGB rendering from a dataset.

Counterpart of ``behavior_driven_video_synthesis_tpu/experiments/
visualize.py:198-256`` (``get_synth_input``, ``get_synth_input_all_cameras``),
which ``bdvs-generate-torch --from_dataset`` reads.  The rest of that
module (the training-time figures and videos) is not ported yet (ROADMAP
A12).
"""
from __future__ import annotations

import numpy as np


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
