"""Model zoo, ported subset: the YOLOv5, YOLOv8, CNN classification /
segmentation, ViT, BERT, GPT, NeoX, BLOOM and llama graph builders, the
detection (zoo/detect.py), classification (zoo/classify.py) and
segmentation (zoo/segment.py) pipelines, their metrics (zoo/metrics.py)
and image I/O (zoo/imageio.py), the KV-cache decoder (zoo/generate.py,
with greedy_generate) and token sampling."""
from .builders import (
    BERT_PRESETS,
    BLOOM_PRESETS,
    GPT_PRESETS,
    LLAMA_PRESETS,
    NEOX_PRESETS,
    VIT_PRESETS,
    GraphBuilder,
    build_bert,
    build_bloom,
    build_densenet,
    build_gpt,
    build_llama,
    build_mobilenet_like,
    build_neox,
    build_resnet18,
    build_resnet50,
    build_unet,
    build_vit,
    build_yolov5,
    build_yolov8,
)
from .classify import classify_images
from .detect import decode_device, decode_predictions, detect_images
from .generate import greedy_generate
from .segment import segment_images

__all__ = ["BERT_PRESETS", "BLOOM_PRESETS", "GPT_PRESETS", "LLAMA_PRESETS",
           "NEOX_PRESETS", "VIT_PRESETS", "GraphBuilder",
           "build_bert", "build_bloom", "build_densenet", "build_gpt",
           "build_llama", "build_mobilenet_like", "build_neox",
           "build_resnet18", "build_resnet50", "build_unet", "build_vit",
           "build_yolov5", "build_yolov8", "classify_images",
           "decode_device", "decode_predictions", "detect_images",
           "greedy_generate", "segment_images"]
