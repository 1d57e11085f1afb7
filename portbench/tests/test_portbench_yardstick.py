"""The frozen operation and byte counts against counts made by hand, at
two shapes each."""
from __future__ import annotations

import pytest

from portbench import harness, yardstick

MANIFEST = harness.load_manifest()
YOLO = harness.cell_spec(MANIFEST, "yolov5s-640-int8w.b32-offline")[2]
GPT2 = harness.cell_spec(MANIFEST, "gpt2-small-int4w.score-1k")[2]

# YOLOv5s at 640 by hand from the v6.0 yaml: (cin, cout, k, output side,
# single-input pointwise conv served by the int8w GEMM)
_T = True
YOLOV5S_640 = [
    (3, 32, 6, 320, 0), (32, 64, 3, 160, 0),
    (64, 32, 1, 160, _T), (32, 32, 1, 160, _T), (32, 32, 3, 160, 0),
    (64, 32, 1, 160, _T), (64, 64, 1, 160, 0),
    (64, 128, 3, 80, 0),
    (128, 64, 1, 80, _T), (64, 64, 1, 80, _T), (64, 64, 3, 80, 0),
    (64, 64, 1, 80, _T), (64, 64, 3, 80, 0), (128, 64, 1, 80, _T),
    (128, 128, 1, 80, 0),
    (128, 256, 3, 40, 0),
    (256, 128, 1, 40, _T), (128, 128, 1, 40, _T), (128, 128, 3, 40, 0),
    (128, 128, 1, 40, _T), (128, 128, 3, 40, 0), (128, 128, 1, 40, _T),
    (128, 128, 3, 40, 0), (256, 128, 1, 40, _T), (256, 256, 1, 40, 0),
    (256, 512, 3, 20, 0),
    (512, 256, 1, 20, _T), (256, 256, 1, 20, _T), (256, 256, 3, 20, 0),
    (512, 256, 1, 20, _T), (512, 512, 1, 20, 0),
    (512, 256, 1, 20, _T), (1024, 512, 1, 20, 0),               # SPPF
    (512, 256, 1, 20, _T),                                      # 10
    (512, 128, 1, 40, 0), (128, 128, 1, 40, _T), (128, 128, 3, 40, 0),
    (512, 128, 1, 40, 0), (256, 256, 1, 40, 0),                 # 13
    (256, 128, 1, 40, _T),                                      # 14
    (256, 64, 1, 80, 0), (64, 64, 1, 80, _T), (64, 64, 3, 80, 0),
    (256, 64, 1, 80, 0), (128, 128, 1, 80, 0),                  # 17
    (128, 128, 3, 40, 0),
    (256, 128, 1, 40, 0), (128, 128, 1, 40, _T), (128, 128, 3, 40, 0),
    (256, 128, 1, 40, 0), (256, 256, 1, 40, 0),                 # 20
    (256, 256, 3, 20, 0),
    (512, 256, 1, 20, 0), (256, 256, 1, 20, _T), (256, 256, 3, 20, 0),
    (512, 256, 1, 20, 0), (512, 512, 1, 20, 0),                 # 23
    (128, 255, 1, 80, 0), (256, 255, 1, 40, 0), (512, 255, 1, 20, 0),
]


@pytest.mark.parametrize("size", [640, 320])
def test_yolo_flops_by_hand(size):
    f = size / 640
    hand = sum(2 * ci * co * k * k * (s * f) ** 2
               for ci, co, k, s, _ in YOLOV5S_640)
    assert yardstick.yolo_flops_per_image(YOLO, size) == pytest.approx(
        hand, rel=1e-12)
    if size == 640:
        assert hand == 16_433_561_600
        # the Detect head alone, which the program's own count leaves out
        head = 2 * 255 * (128 * 80 * 80 + 256 * 40 * 40 + 512 * 20 * 20)
        assert hand - head == 15_702_425_600


@pytest.mark.parametrize("batch", [1, 128])
def test_int8w_calls_by_hand(batch):
    calls = yardstick.int8w_calls(YOLO, 640, batch)
    hand = [(ci, co, s) for ci, co, k, s, single in YOLOV5S_640 if single]
    assert len(calls) == len(hand) == 22
    ci, co, s = hand[0]                  # the first C3's cv1 at 160 x 160
    m = batch * s * s
    assert calls[0].flops == 2 * m * ci * co
    assert calls[0].bytes == 2 * m * ci + ci * co + 4 * co + 2 * co \
        + 2 * m * co
    assert sum(c.flops for c in calls) == sum(
        2 * batch * s * s * ci * co for ci, co, s in hand)


@pytest.mark.parametrize("length", [1, 1024])
def test_gpt2_flops_by_hand(length):
    e, v, layers = 768, 50257, 12
    proj = 2 * length * (4 * e * e + 2 * e * 4 * e)
    attn = 4 * e * length * (length + 1) // 2
    assert yardstick.gpt2_flops(GPT2, length) == layers * (proj + attn) \
        + 2 * e * v


@pytest.mark.parametrize("rows", [1, 32])
def test_int4w_calls_by_hand(rows):
    wave = yardstick.int4w_calls_wave(GPT2, rows, 1024, 128)
    step = yardstick.int4w_calls_decode(GPT2, rows, 128)
    assert len(wave) == len(step) == 12 * 6 + 1
    head = wave[-1]
    assert head.flops == 2 * rows * 768 * 50257
    assert head.bytes == 2 * rows * 768 + 768 * 50257 / 2 \
        + 4 * 6 * 50257 + 2 * rows * 50257
    q = wave[0]                          # a q projection over the bucket
    assert q.flops == 2 * rows * 1024 * 768 * 768
    assert q.bytes == 2 * rows * 1024 * 768 + 768 * 768 / 2 \
        + 4 * 6 * 768 + 4 * rows * 1024 * 768


@pytest.mark.parametrize("width", [256, 1024])
def test_flash_calls_by_hand(width):
    calls = yardstick.flash_calls_wave(GPT2, 32, width)
    assert len(calls) == 12
    pairs = width * (width + 1) / 2
    assert calls[0].flops == 4 * 64 * pairs * 32 * 12
    assert calls[0].bytes == 4 * 2 * 32 * 12 * width * 64


def test_roofline_bound_is_the_larger_floor():
    c = yardstick.Call(989e12, 3.35e12 * 2)
    assert c.min_s() == pytest.approx(2.0)
    assert yardstick.kernel_category("si_int4w_mma_kernel") == \
        "si:matmul_int4w"
    assert yardstick.kernel_category("si_matmul_mma_kernel") == "si:matmul"
    assert yardstick.kernel_category("si_flash_mma_kernel") == \
        "si:flash_attention"
    assert yardstick.kernel_category(
        "void at::native::vectorized_elementwise_kernel") == "elementwise"
