"""Model zoo, ported subset: the YOLOv5 graph builder."""
from .builders import GraphBuilder, build_yolov5

__all__ = ["GraphBuilder", "build_yolov5"]
