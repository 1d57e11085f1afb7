"""Model zoo, ported subset: the YOLOv5, llama and CNN classification /
segmentation graph builders, the classification pipeline
(zoo/classify.py), the KV-cache decoder and token sampling."""
from .builders import (
    LLAMA_PRESETS,
    GraphBuilder,
    build_densenet,
    build_llama,
    build_mobilenet_like,
    build_resnet18,
    build_resnet50,
    build_unet,
    build_yolov5,
)

__all__ = ["LLAMA_PRESETS", "GraphBuilder", "build_densenet", "build_llama",
           "build_mobilenet_like", "build_resnet18", "build_resnet50",
           "build_unet", "build_yolov5"]
