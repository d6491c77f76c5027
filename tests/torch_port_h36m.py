"""A tiny Human3.6M ``annot_export.h5``, written from the synthetic columns
of ``data/synthetic.py:synthetic_h36m_columns`` in the processed
dataset's layout: the h5 column names, 32 world joints in millimetres,
1-based frames, byte-string frame paths, and every frame seen by two
cameras.  Shared by ``tests/test_torch_sequence_data.py`` and
``tests/test_torch_behavior_cli.py``; needs h5py.
"""
import numpy as np


def write_annot_export(directory, n_frames_per_video=30, subjects=(1, 9),
                       actions=(2, 4), seed=2) -> dict:
    """Write ``directory/annot_export.h5``; returns the synthetic columns
    it was made from."""
    import h5py

    from behavior_driven_video_synthesis_tpu_torch.data.human36m import (
        detailed_joint_model)
    from behavior_driven_video_synthesis_tpu_torch.data.synthetic import (
        synthetic_h36m_columns)

    cols = synthetic_h36m_columns(n_frames_per_video=n_frames_per_video,
                                  subjects=subjects, actions=actions,
                                  seed=seed)
    n = len(cols["p_ids"])
    h5 = {"frame_path": np.asarray([p.encode() for p in cols["img_paths"]]),
          "subject": cols["p_ids"], "frame": cols["f_ids"],
          "action": cols["action"], "subaction": cols["subaction"],
          "image_size": cols["image_size"],
          "intrinsics_univ": cols["intrinsics_univ"],
          "extrinsics_univ": cols["extrinsics_univ"] * 1000.0}
    world = np.zeros((n, 32, 3))
    world[:, detailed_joint_model(True).kps_to_use] = (
        cols["keypoints_3d_world"] * 1000.0)
    h5["pose_3d_world"] = world
    h5 = {k: np.concatenate([v, v]) for k, v in h5.items()}
    h5["camera"] = np.repeat([54138969, 55011271], n)
    with h5py.File(f"{directory}/annot_export.h5", "w") as f:
        for k, v in h5.items():
            f.create_dataset(k, data=v)
    return cols
