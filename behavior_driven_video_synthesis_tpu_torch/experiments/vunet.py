"""The original VUNet experiment (``experiment: vunet``).

Counterpart of ``behavior_driven_video_synthesis_tpu/experiments/vunet.py``:
a re-export of :class:`VunetExperiment`, which lives beside the cvbae
driver it extends.
"""
from .shape_and_pose_net import VunetExperiment

__all__ = ["VunetExperiment"]
