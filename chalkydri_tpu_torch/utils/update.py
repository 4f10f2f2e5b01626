"""USB-stick update detection (port of ``chalkydri_tpu/utils/update.py``).

The reference sketches this (``crates/chalkydri/src/update.rs:3-8``: scan
mounted disks for an update payload). Implemented:
scan removable mounts for a ``chalkydri-update/`` directory containing a
manifest, and report (or stage) the newest applicable update.
"""

from __future__ import annotations

import json
import os
import shutil
from dataclasses import dataclass

UPDATE_DIR_NAME = "chalkydri-update"
MANIFEST = "manifest.json"
MOUNT_ROOTS = ("/media", "/mnt", "/run/media")


@dataclass
class UpdatePackage:
    path: str
    version: str
    description: str = ""


def scan_for_updates(roots=MOUNT_ROOTS) -> list[UpdatePackage]:
    found = []
    for root in roots:
        if not os.path.isdir(root):
            continue
        for dirpath, dirnames, _ in os.walk(root):
            if UPDATE_DIR_NAME in dirnames:
                pkg_dir = os.path.join(dirpath, UPDATE_DIR_NAME)
                manifest = os.path.join(pkg_dir, MANIFEST)
                if not os.path.exists(manifest):
                    continue
                try:
                    with open(manifest) as f:
                        meta = json.load(f)
                    found.append(
                        UpdatePackage(
                            path=pkg_dir,
                            version=str(meta.get("version", "0")),
                            description=meta.get("description", ""),
                        )
                    )
                except (OSError, json.JSONDecodeError):
                    continue
            # don't descend deeply into mounts
            if dirpath.count(os.sep) - root.count(os.sep) > 2:
                dirnames.clear()
    found.sort(key=lambda p: p.version, reverse=True)
    return found


def stage_update(pkg: UpdatePackage, target_dir: str) -> str:
    """Copy the update payload to a staging dir; returns the staged path."""
    staged = os.path.join(target_dir, f"update-{pkg.version}")
    if os.path.exists(staged):
        shutil.rmtree(staged)
    shutil.copytree(pkg.path, staged)
    return staged
