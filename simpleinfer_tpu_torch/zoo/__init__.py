"""Model zoo, ported subset: the YOLOv5, YOLOv8, llama and CNN
classification / segmentation graph builders, the detection
(zoo/detect.py), classification (zoo/classify.py) and segmentation
(zoo/segment.py) pipelines, their metrics (zoo/metrics.py) and image I/O
(zoo/imageio.py), the KV-cache decoder and token sampling."""
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
    build_yolov8,
)
from .classify import classify_images
from .detect import decode_device, decode_predictions, detect_images
from .segment import segment_images

__all__ = ["LLAMA_PRESETS", "GraphBuilder", "build_densenet", "build_llama",
           "build_mobilenet_like", "build_resnet18", "build_resnet50",
           "build_unet", "build_yolov5", "build_yolov8", "classify_images",
           "decode_device", "decode_predictions", "detect_images",
           "segment_images"]
