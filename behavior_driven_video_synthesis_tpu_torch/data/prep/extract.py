"""Extract the raw Human3.6M archives (poses and videos) per subject.

Counterpart of ``behavior_driven_video_synthesis_tpu/data/prep/
extract.py``::

    python -m behavior_driven_video_synthesis_tpu_torch.data.prep.extract \
        -d <datadir>

reads ``<datadir>/archives/{Poses_D3_Positions_mono_universal,Videos}_
<subject>.tgz`` and writes ``<datadir>/extracted/<subject>/...``; an
existing destination is left as it is.  Each archive's common directory
prefix is stripped.
"""
from __future__ import annotations

import argparse
import tarfile
from os import makedirs, path

SUBJECTS = ["S1", "S5", "S6", "S7", "S8", "S9", "S11"]


def _commonprefix(m):
    s1, s2 = min(m), max(m)
    for i, c in enumerate(s1):
        if c != s2[i]:
            return s1[:i]
    return s1


def extract_tgz(tgz_file: str, dest: str):
    """The regular files of ``tgz_file`` under ``dest``, their common
    directory prefix stripped; nothing if ``dest`` exists."""
    if path.exists(dest):
        return
    with tarfile.open(tgz_file, "r:gz") as tar:
        members = [m for m in tar.getmembers() if m.isreg()]
        member_dirs = [path.dirname(m.name).split(path.sep) for m in members]
        base_path = path.sep.join(_commonprefix(member_dirs))
        for m in members:
            m.name = path.relpath(m.name, base_path)
        tar.extractall(dest, filter="data")


def extract_all(archive_dir: str, out_root: str = "extracted"):
    for subject in SUBJECTS:
        out_dir = path.join(out_root, subject)
        makedirs(out_dir, exist_ok=True)
        extract_tgz(
            path.join(archive_dir,
                      f"Poses_D3_Positions_mono_universal_{subject}.tgz"),
            path.join(out_dir, "Poses_D3_Positions_mono_universal"))
        extract_tgz(path.join(archive_dir, f"Videos_{subject}.tgz"),
                    path.join(out_dir, "Videos"))


if __name__ == "__main__":
    p = argparse.ArgumentParser(
        description="extract the Human3.6M archives under <datadir>")
    p.add_argument("-d", "--datadir", required=True)
    args = p.parse_args()
    extract_all(path.join(args.datadir, "archives"),
                path.join(args.datadir, "extracted"))
