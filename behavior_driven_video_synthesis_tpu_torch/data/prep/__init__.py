"""Offline Human3.6M preparation (host numpy): the archives extracted
(``extract.py``), ``metadata.xml`` parsed (``metadata.py``), and the
views processed into ``annot_export.h5`` (``process.py``), which
``data/human36m.py`` reads.  Counterpart of
``behavior_driven_video_synthesis_tpu/data/prep/``; run as
``python -m behavior_driven_video_synthesis_tpu_torch.data.prep.extract``
and ``...prep.process``."""
from .metadata import H36MMetadata, load_h36m_metadata

__all__ = ["H36MMetadata", "infer_camera_intrinsics", "load_h36m_metadata"]


def __getattr__(name):
    # imported on use, so that ``python -m ...prep.process`` runs the
    # module once
    if name == "infer_camera_intrinsics":
        from .process import infer_camera_intrinsics
        return infer_camera_intrinsics
    raise AttributeError(name)
