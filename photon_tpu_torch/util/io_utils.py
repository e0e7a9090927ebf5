"""Output-directory lifecycle (reference photon-client util/IOUtils.scala:
processOutputDir — fail on existing output unless override is set).

Copy of photon_tpu/util/io_utils.py."""
from __future__ import annotations

import os
import shutil


def prepare_output_dir(path: str | os.PathLike, override: bool = False) -> str:
    """Create the output dir; if it exists, fail unless ``override``
    (then it is deleted and recreated) — matching the reference's
    overrideOutputDirectory semantics."""
    path = str(path)
    if os.path.exists(path):
        if not override:
            raise FileExistsError(
                f"output directory {path} exists (pass override to replace)"
            )
        shutil.rmtree(path)
    os.makedirs(path)
    return path
