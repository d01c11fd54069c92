"""PoseTrack constants (the port's copy of ``otpose_tpu/data/posetrack.py``'s).

The dataset class is not ported yet; eval and inference need only the
ImageNet normalisation and the left/right joint pairs of the flip test.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

FLIP_PAIRS = [[3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14], [15, 16]]
