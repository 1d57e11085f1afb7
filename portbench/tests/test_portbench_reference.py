"""The references work out the program's quantized weights again on their
own: equal, value for value, to what the program derives."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import models


@pytest.mark.parametrize("shape", [(64, 32, 3, 3), (255, 128, 1, 1)])
def test_int8_per_channel_equals_the_program(shape):
    from simpleinfer_tpu_torch.quant.tensor import quantize_per_channel

    w = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    hwio = np.transpose(w, (2, 3, 1, 0))          # the program's layout
    prog = quantize_per_channel(hwio, axis=3).dequantize()
    ref = models.int8_per_channel(torch.from_numpy(w), 0)
    assert torch.equal(ref.permute(2, 3, 1, 0), prog)


@pytest.mark.parametrize("k, n", [(768, 300), (3072, 64), (100, 8)])
def test_int4_grouped_equals_the_program(k, n):
    from simpleinfer_tpu_torch.quant.tensor import quantize_int4_grouped

    w = np.random.default_rng(2).standard_normal((k, n)).astype(np.float32)
    prog = quantize_int4_grouped(w, group=128).dequantize()
    assert torch.equal(models.int4_grouped(torch.from_numpy(w), 128), prog)


def test_fp8_round_is_coarser_than_bf16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(3))
    e8 = (models.fp8_round(x) - x).abs().max()
    e16 = (x.bfloat16().float() - x).abs().max()
    assert e8 > 4 * e16
