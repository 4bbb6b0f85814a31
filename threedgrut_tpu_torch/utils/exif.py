"""JPEG EXIF exposure priors (threedgrut/utils/exif.py:124 equivalent;
copied from threedgrut_tpu/utils/exif.py, PIL and numpy).

Reads shutter / ISO / aperture from EXIF via PIL and converts each image
to a mean-normalized log2 exposure value used as a post-processing prior.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional

import numpy as np

# PIL EXIF tag ids
_EXPOSURE_TIME = 0x829A
_F_NUMBER = 0x829D
_ISO = 0x8827


def _rational(v) -> Optional[float]:
    try:
        return float(v)
    except (TypeError, ValueError, ZeroDivisionError):
        return None


def read_exposure_value(path: str) -> Optional[float]:
    """log2 exposure = log2(shutter * ISO / (100 * N^2)); None if absent."""
    try:
        from PIL import Image

        with Image.open(path) as img:
            exif = img.getexif()
            if not exif:
                return None
            shutter = _rational(exif.get(_EXPOSURE_TIME))
            fnum = _rational(exif.get(_F_NUMBER))
            iso = _rational(exif.get(_ISO))
    except Exception:
        return None
    if not shutter or not iso:
        return None
    fnum = fnum or 1.0
    ev = shutter * iso / (100.0 * max(fnum, 1e-6) ** 2)
    if ev <= 0:
        return None
    return math.log2(ev)


def load_exif_exposures(paths: List[str]) -> Optional[Dict[str, float]]:
    """Mean-normalized log2 exposures per file; None when nothing usable."""
    values = {}
    for p in paths:
        v = read_exposure_value(p)
        if v is not None:
            values[p] = v
    if not values:
        return None
    mean = float(np.mean(list(values.values())))
    return {os.path.basename(p): v - mean for p, v in values.items()}
