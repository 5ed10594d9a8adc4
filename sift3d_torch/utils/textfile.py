"""File-list reader — successor of src_common/TextFile.{h,cpp}, used by the
matcher's -f option for file lists longer than the shell argv limit
(featMatchMultiple.cpp:499-517). The port's copy of
``sift3d.utils.textfile``."""

from __future__ import annotations

from typing import List


def read_lines(path: str) -> List[str]:
    with open(path, "rt") as f:
        return [ln.strip() for ln in f if ln.strip()]
