"""General utilities (port of ``rep_yolo_tpu/utils/general.py``'s
``increment_path``)."""

from __future__ import annotations

import glob
import re
from pathlib import Path


def increment_path(path: str | Path, exist_ok: bool = False) -> Path:
    """runs/exp -> runs/exp{2,3,...} (reference utils/general.py:1227-1237)."""
    path = Path(path)
    if not path.exists() or exist_ok:
        return path
    dirs = glob.glob(f"{path}*")
    matches = [re.search(rf"{re.escape(path.name)}(\d+)", Path(d).name)
               for d in dirs]
    i = [int(m.group(1)) for m in matches if m]
    n = max(i) + 1 if i else 2
    return Path(f"{path}{n}")
