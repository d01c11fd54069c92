"""Person detection for offline box generation (counterpart of
``otpose_tpu/detector/``): YOLOv3 and yolov3-tiny in ``yolov3.py``."""
