"""The experiment registry.

Counterpart of ``behavior_driven_video_synthesis_tpu/experiments/
__init__.py`` (``select_experiment``, :5-22): ``general.experiment`` names
the experiment class.
"""
from __future__ import annotations

EXPERIMENTS = ("behavior_net", "cvbae", "vunet", "mtvae")


def select_experiment(config: dict, dirs, device, restart: bool = False):
    """The experiment ``config["general"]["experiment"]`` names, built on
    ``device``; ValueError for a name outside ``EXPERIMENTS``."""
    name = config.get("general", {}).get("experiment")
    if name == "behavior_net":
        from .behavior_net import BehaviorNetExperiment as cls
    elif name == "cvbae":
        from .shape_and_pose_net import ShapePoseExperiment as cls
    elif name == "vunet":
        from .vunet import VunetExperiment as cls
    elif name == "mtvae":
        from .mt_vae import MTVAEExperiment as cls
    else:
        raise ValueError(f"unknown experiment: {name!r} (known: "
                         f"{', '.join(EXPERIMENTS)})")
    if restart:
        print(f"+++ Restarting experiment {name} +++")
    return cls(config, dirs, device)
