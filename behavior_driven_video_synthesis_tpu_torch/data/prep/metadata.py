"""Human3.6M ``metadata.xml`` parsing: subjects, sequence mappings,
action names and camera ids.

Counterpart of ``behavior_driven_video_synthesis_tpu/data/prep/
metadata.py``.  Needs the official ``metadata.xml`` that ships with the
dataset (not redistributed here).
"""
from __future__ import annotations

import xml.etree.ElementTree as ET


class H36MMetadata:
    def __init__(self, metadata_file: str):
        self.subjects = []
        self.sequence_mappings = {}
        self.action_names = {}
        self.camera_ids = []

        root = ET.parse(metadata_file).getroot()
        for i, tr in enumerate(root.find("mapping")):
            if i == 0:
                _, _, *self.subjects = [td.text for td in tr]
                self.sequence_mappings = {s: {} for s in self.subjects}
            elif i < 33:
                action_id, subaction_id, *prefixes = [td.text for td in tr]
                for subject, prefix in zip(self.subjects, prefixes):
                    self.sequence_mappings[subject][
                        (action_id, subaction_id)] = prefix
        for i, elem in enumerate(root.find("actionnames")):
            self.action_names[str(i + 1)] = elem.text
        self.camera_ids = [e.text for e in root.find("dbcameras/index2id")]

    def get_base_filename(self, subject, action, subaction, camera) -> str:
        return "{}.{}".format(
            self.sequence_mappings[subject][(action, subaction)], camera)


def load_h36m_metadata(path: str = "metadata.xml") -> H36MMetadata:
    return H36MMetadata(path)
