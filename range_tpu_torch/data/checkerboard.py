"""The Fibonacci lattice of the spherical-checkerboard task (numpy only).

Copy of `fibonacci_lattice` in `range_tpu/data/checkerboard.py:20-32`
(reference `checkerboarddataset.py:12-36`); the bank build seeds its
geographic k-means with it.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def fibonacci_lattice(n: int, n_classes: int = 16
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """n is halved; i in [-n/2, n/2); lat = asin(2i / (2(n/2)+1)); lon = (i
    mod golden) * 360/golden wrapped into [-180, 180]; labels cycle mod
    classes.  Returns (lon, lat, labels), lon/lat in degrees."""
    half = n // 2
    phi = (1 + math.sqrt(5)) / 2
    i = np.arange(-half, half).astype(float)
    lat = np.degrees(np.arcsin((2 * i) / (2 * half + 1)))
    lon = np.mod(i, phi) * (360.0 / phi)
    lon = np.where(lon > 180, lon - 360, lon)
    lon = np.where(lon < -180, lon + 360, lon)
    labels = (np.arange(-half, half) % n_classes).astype(np.int64)
    return lon, lat, labels
