"""Model zoo, ported subset: the YOLOv5 and llama graph builders, the
KV-cache decoder and token sampling."""
from .builders import LLAMA_PRESETS, GraphBuilder, build_llama, build_yolov5

__all__ = ["LLAMA_PRESETS", "GraphBuilder", "build_llama", "build_yolov5"]
