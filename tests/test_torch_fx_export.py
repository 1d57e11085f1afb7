"""The port's torch.fx exporter (simpleinfer_tpu_torch/frontends/
torch_export.py) against the JAX package's, on the CPU.

Every module case of tests/test_torch_frontend.py goes through both
packages' `export_torch`: the graphs' `.param` text and `.bin` bytes
(Graph.save) must be equal, and the port's Engine on the CPU must match
the module's own forward within the tolerance the JAX test uses for
that case (atol 2e-4 x scale, 5e-4 x scale for norms, softmax and
attention, 2e-3 x scale for bilinear upsampling; rtol 1e-3; scale =
max(1, max|ref|)). Then the static-int8 export on port engines, the
refusals (TorchExportError, as the JAX exporter raises them), torch
tensors as examples, and chip_smoke.py's ResNet-50 (torchvision v1.5
layout) and ViT-B/16 modules at a tiny width.
"""
import os
import sys

import jax  # noqa: F401  (both frameworks in one process, JAX on CPU)
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from simpleinfer_tpu.frontends import export_torch as jexport
from simpleinfer_tpu.frontends.torch_export import \
    TorchExportError as JTorchExportError
from simpleinfer_tpu_torch import Engine, EngineConfig
from simpleinfer_tpu_torch.frontends import TorchExportError, export_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = EngineConfig(device="cpu")


# ---- the module cases of tests/test_torch_frontend.py -----------------------
class _Residual(nn.Module):
    def __init__(self):
        super().__init__()
        self.c1 = nn.Conv2d(8, 8, 3, padding=1)
        self.c2 = nn.Conv2d(8, 8, 3, padding=1)

    def forward(self, x):
        y = F.silu(self.c1(x))
        return x + self.c2(y) * 0.5


class _Branchy(nn.Module):
    def __init__(self):
        super().__init__()
        self.a = nn.Conv2d(4, 6, 1)
        self.b = nn.Conv2d(4, 6, 3, padding=1)
        self.head = nn.Conv2d(12, 5, 1)
        self.up = nn.Upsample(scale_factor=2.0, mode="nearest")

    def forward(self, x):
        y = torch.cat([torch.sigmoid(self.a(x)), self.b(x)], dim=1)
        return self.up(self.head(y))


class _Grouped(nn.Module):
    def __init__(self):
        super().__init__()
        self.dw = nn.Conv2d(8, 8, 3, padding=1, groups=8)
        self.pw = nn.Conv2d(8, 12, 1)

    def forward(self, x):
        return self.pw(F.hardsigmoid(self.dw(x)))


class _FlattenMethod(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(4 * 6 * 6, 3)

    def forward(self, x):
        return self.fc(x.flatten(1))


class _TorchRelu(nn.Module):
    def __init__(self):
        super().__init__()
        self.c = nn.Conv2d(3, 4, 1)

    def forward(self, x):
        return torch.relu(self.c(x))


class _ConvTransposeInterp(nn.Module):
    def __init__(self):
        super().__init__()
        self.up = nn.ConvTranspose2d(6, 4, 2, stride=2)
        self.c = nn.Conv2d(4, 4, 3, padding=1)

    def forward(self, x):
        y = torch.relu(self.up(x))
        y = F.interpolate(y, scale_factor=2.0, mode="nearest")
        return self.c(y)


class _Bilinear(nn.Module):
    def __init__(self):
        super().__init__()
        self.c = nn.Conv2d(3, 4, 1)

    def forward(self, x):
        return F.interpolate(self.c(x), scale_factor=2.0, mode="bilinear",
                             align_corners=False)


class _C2f(nn.Module):
    def __init__(self):
        super().__init__()
        self.cv1 = nn.Conv2d(8, 8, 1)
        self.m = nn.Conv2d(4, 4, 3, padding=1)
        self.cv2 = nn.Conv2d(12, 6, 1)

    def forward(self, x):
        a, b = self.cv1(x).chunk(2, 1)
        c = self.m(b)
        return self.cv2(torch.cat([a, b, c], 1))


class _Slice(nn.Module):
    def forward(self, x):
        return x[:, 1:3, ::2]


class _Focus(nn.Module):
    def __init__(self):
        super().__init__()
        self.c = nn.Conv2d(12, 8, 1)

    def forward(self, x):
        return self.c(torch.cat(
            [x[..., ::2, ::2], x[..., 1::2, ::2],
             x[..., ::2, 1::2], x[..., 1::2, 1::2]], 1))


class _FullSlice(nn.Module):
    def __init__(self):
        super().__init__()
        self.c = nn.Conv2d(3, 4, 1)

    def forward(self, x):
        return self.c(x[:])


class _Pools(nn.Module):
    def __init__(self):
        super().__init__()
        self.c = nn.Conv2d(3, 8, 3, padding=1)

    def forward(self, x):
        x = F.max_pool2d(self.c(x), 2)
        x = F.avg_pool2d(x, 2, 1, 1)
        x = F.adaptive_avg_pool2d(x, 1)
        return torch.flatten(x, 1)


class _LeakyEluDropout(nn.Module):
    def forward(self, x):
        x = F.leaky_relu(x, 0.2)
        x = F.dropout(x, p=0.5, training=False)
        return F.elu(x, alpha=0.6)


class _ExpandClone(nn.Module):
    def forward(self, x):
        return x.clone().expand(-1, 4, -1, -1)


class _InterpSize(nn.Module):
    def forward(self, x):
        return F.interpolate(x, (8, 8))


class _LnVector(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(12, 16)
        self.ln = nn.LayerNorm(16)

    def forward(self, x):
        return self.ln(self.fc(x))


class _Relu6SoftmaxPad(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 3, padding=1)
        self.pad = nn.ZeroPad2d((1, 1, 2, 2))
        self.act = nn.ReLU6()

    def forward(self, x):
        y = self.act(self.conv(self.pad(x)))
        y = F.pad(y, (0, 1, 1, 0), mode="replicate")
        y = torch.clamp(y, max=3.0)
        y = F.mish(y)
        y = y.flatten(1)
        return F.softmax(y, dim=-1)


class _SplitSections(nn.Module):
    def forward(self, x):
        a, b, c = torch.split(x, [1, 2, 3], dim=1)
        return a * 2 + torch.cat([b, c], 1)[:, :1]


class _SplitInt(nn.Module):
    def forward(self, x):
        parts = x.split(2, dim=1)
        return parts[0] + parts[1] * parts[2]


class _SumStackAmax(nn.Module):
    def forward(self, x):
        s = torch.sum(x, dim=2, keepdim=True)
        m = torch.amax(x, dim=[2], keepdim=True)
        return torch.stack([s, m], 0).sum(dim=0, keepdim=False)


class _ChunkUneven(nn.Module):
    def forward(self, x):
        a, b, c = torch.chunk(x, 4, dim=1)
        return torch.cat([a, b, c, a[:, :1]], 1)


class _InterpMode(nn.Module):
    def forward(self, x):
        return F.interpolate(x, None, 2.0, "bilinear", False)


class _MiniViT(nn.Module):
    def __init__(self, e=32, heads=4, depth=2, patches=16, classes=9):
        super().__init__()
        self.patch = nn.Conv2d(3, e, 8, 8)
        self.cls_token = nn.Parameter(torch.randn(1, 1, e) * 0.02)
        self.pos = nn.Parameter(torch.randn(1, patches + 1, e) * 0.02)
        self.ln1 = nn.ModuleList([nn.LayerNorm(e) for _ in range(depth)])
        self.attn = nn.ModuleList(
            [nn.MultiheadAttention(e, heads, batch_first=True)
             for _ in range(depth)])
        self.ln2 = nn.ModuleList([nn.LayerNorm(e) for _ in range(depth)])
        self.fc1 = nn.ModuleList([nn.Linear(e, 4 * e) for _ in range(depth)])
        self.fc2 = nn.ModuleList([nn.Linear(4 * e, e) for _ in range(depth)])
        self.ln_f = nn.LayerNorm(e)
        self.head = nn.Linear(e, classes)
        self.depth = depth

    def forward(self, x):
        n = x.shape[0]
        x = self.patch(x)
        x = torch.flatten(x, 2).transpose(1, 2)
        cls = self.cls_token.expand(n, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos
        for i in range(self.depth):
            y, _ = self.attn[i](self.ln1[i](x), self.ln1[i](x),
                                self.ln1[i](x), need_weights=False)
            x = x + y
            y = self.fc2[i](F.gelu(self.fc1[i](self.ln2[i](x))))
            x = x + y
        return self.head(self.ln_f(x).select(1, 0))


class _SDPA(nn.Module):
    def __init__(self):
        super().__init__()
        self.q = nn.Linear(16, 16)
        self.k = nn.Linear(16, 16)
        self.v = nn.Linear(16, 16)

    def forward(self, x):
        n, l, e = 2, 5, 16
        q = self.q(x).reshape(n, l, 4, 4).permute(0, 2, 1, 3)
        k = self.k(x).reshape(n, l, 4, 4).permute(0, 2, 1, 3)
        v = self.v(x).reshape(n, l, 4, 4).permute(0, 2, 1, 3)
        o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return o.permute(0, 2, 1, 3).reshape(n, l, e)


class _MatmulNet(nn.Module):
    def forward(self, x):
        g = torch.matmul(x, x.transpose(1, 2))
        return torch.bmm(g, x)


class _EmbeddingNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.emb = nn.Embedding(12, 6)
        self.fc = nn.Linear(6, 3)

    def forward(self, idx):
        return self.fc(self.emb(idx))


class _CrossAttn(nn.Module):
    def __init__(self):
        super().__init__()
        self.attn = nn.MultiheadAttention(8, 2, batch_first=True)

    def forward(self, q, kv):
        out, _ = self.attn(q, kv, kv, need_weights=False)
        return out


class _MultiInput(nn.Module):
    def __init__(self):
        super().__init__()
        self.c = nn.Conv2d(3, 4, 1)

    def forward(self, a, b):
        return self.c(a) + self.c(b) * 0.5


def _conv_bn_stack():
    m = nn.Sequential(
        nn.Conv2d(3, 16, 3, stride=2, padding=1), nn.BatchNorm2d(16),
        nn.ReLU(), nn.MaxPool2d(2), nn.Conv2d(16, 32, 3, padding=1,
                                              bias=False),
        nn.Hardswish(), nn.AdaptiveAvgPool2d(1), nn.Flatten(),
        nn.Linear(32, 10))
    with torch.no_grad():
        m[1].running_mean.normal_(0, 0.3)
        m[1].running_var.uniform_(0.5, 1.5)
    return m


def _norm_family():
    m = nn.Sequential(
        nn.Conv2d(3, 8, 3, padding=1), nn.GroupNorm(2, 8), nn.ReLU(),
        nn.Conv2d(8, 8, 3, padding=1), nn.InstanceNorm2d(8, affine=True),
        nn.Hardswish(), nn.LayerNorm([8, 8]))
    with torch.no_grad():
        for i in (4, 6):
            m[i].weight.normal_(1.0, 0.2)
            m[i].bias.normal_(0, 0.2)
    return m


def _instance_norm_running():
    m = nn.Sequential(
        nn.Conv2d(3, 6, 3, padding=1),
        nn.InstanceNorm2d(6, affine=True, track_running_stats=True))
    with torch.no_grad():
        m[1].running_mean.normal_(0, 0.3)
        m[1].running_var.uniform_(0.5, 1.5)
    return m


def _encoder(norm_first):
    return nn.Sequential(
        nn.Linear(8, 16),
        nn.TransformerEncoder(
            nn.TransformerEncoderLayer(
                16, 4, dim_feedforward=32, batch_first=True,
                norm_first=norm_first, dropout=0.0),
            num_layers=2, norm=nn.LayerNorm(16)),
        nn.Linear(16, 3))


def _f32(*shape):
    return ("f32", shape)


# name -> (module factory, inputs, tolerance): the inputs are seeded f32
# arrays of those shapes, or int64 ids ("ids", shape, vocab)
CASES = {
    "conv_bn_act_pool_linear": (_conv_bn_stack, [_f32(2, 3, 32, 32)], 2e-4),
    "residual_scalar_mul": (_Residual, [_f32(1, 8, 16, 16)], 2e-4),
    "cat_upsample_sigmoid": (_Branchy, [_f32(2, 4, 12, 12)], 2e-4),
    "depthwise_separable": (_Grouped, [_f32(1, 8, 10, 10)], 2e-4),
    "flatten_method": (_FlattenMethod, [_f32(2, 4, 6, 6)], 2e-4),
    "torch_relu": (_TorchRelu, [_f32(1, 3, 8, 8)], 2e-4),
    "conv_transpose_interpolate": (_ConvTransposeInterp,
                                   [_f32(1, 6, 7, 7)], 2e-4),
    "interpolate_bilinear": (_Bilinear, [_f32(1, 3, 6, 6)], 2e-3),
    "c2f_chunk_getitem": (_C2f, [_f32(2, 8, 12, 12)], 2e-4),
    "slice_getitem": (_Slice, [_f32(2, 4, 6, 6)], 2e-4),
    "focus_stem": (_Focus, [_f32(1, 3, 8, 8)], 2e-4),
    "full_slice": (_FullSlice, [_f32(1, 3, 4, 4)], 2e-4),
    "functional_pools": (_Pools, [_f32(2, 3, 16, 16)], 2e-4),
    "leaky_elu_dropout": (_LeakyEluDropout, [_f32(1, 3, 4, 4)], 2e-4),
    "expand_clone": (_ExpandClone, [_f32(2, 1, 3, 3)], 2e-4),
    "gelu_tanh": (lambda: nn.Sequential(nn.Conv2d(3, 4, 1),
                                        nn.GELU(approximate="tanh")),
                  [_f32(1, 3, 8, 8)], 2e-4),
    "interpolate_size": (_InterpSize, [_f32(1, 3, 4, 4)], 2e-4),
    "norm_family": (_norm_family, [_f32(2, 3, 8, 8)], 5e-4),
    "layer_norm_vector": (_LnVector, [_f32(4, 12)], 5e-4),
    "instance_norm_running": (_instance_norm_running, [_f32(2, 3, 8, 8)],
                              5e-4),
    "relu6_softmax_pad_clamp": (_Relu6SoftmaxPad, [_f32(2, 3, 8, 8)],
                                5e-4),
    "split_sections": (_SplitSections, [_f32(2, 6, 4, 4)], 2e-4),
    "split_int": (_SplitInt, [_f32(2, 6, 4, 4)], 2e-4),
    "sum_stack_amax": (_SumStackAmax, [_f32(2, 3, 5, 5)], 2e-4),
    "chunk_uneven": (_ChunkUneven, [_f32(1, 5, 4, 4)], 2e-4),
    "interpolate_mode": (_InterpMode, [_f32(1, 3, 5, 5)], 2e-3),
    "dropout2d_aliases": (lambda: nn.Sequential(
        nn.Conv2d(3, 4, 1), nn.Dropout2d(0.5), nn.AlphaDropout(0.3),
        nn.ReLU()), [_f32(1, 3, 6, 6)], 2e-4),
    "mini_vit": (_MiniViT, [_f32(2, 3, 32, 32)], 5e-4),
    "sdpa_causal": (_SDPA, [_f32(2, 5, 16)], 5e-4),
    "matmul_bmm": (_MatmulNet, [_f32(2, 6, 8)], 5e-4),
    "embedding": (_EmbeddingNet, [("ids", (2, 7), 12)], 2e-4),
    "cross_attention": (_CrossAttn, [_f32(1, 4, 8), _f32(1, 6, 8)], 2e-4),
    "multi_input": (_MultiInput, [_f32(1, 3, 6, 6), _f32(1, 3, 6, 6)],
                    2e-4),
    "encoder_norm_first": (lambda: _encoder(True), [_f32(2, 5, 8)], 5e-4),
    "encoder_post_ln": (lambda: _encoder(False), [_f32(2, 5, 8)], 5e-4),
    "rms_norm": (lambda: nn.Sequential(nn.Linear(6, 12), nn.RMSNorm(12),
                                       nn.Linear(12, 4)),
                 [_f32(2, 7, 6)], 5e-4),
}


def make_case(name, seed=3):
    """The case's module (eval mode, weights from torch seed `seed`) and
    its inputs (numpy, from a numpy seed)."""
    make, specs, tol = CASES[name]
    torch.manual_seed(seed)
    module = make().eval()
    rng = np.random.default_rng(77)
    inputs = []
    for spec in specs:
        if spec[0] == "ids":
            inputs.append(rng.integers(0, spec[2], size=spec[1]).astype(
                np.int64))
        else:
            inputs.append(rng.standard_normal(spec[1]).astype(np.float32))
    return module, inputs, tol


def saved(graph, tmp_path, tag):
    p = (str(tmp_path / f"{tag}.pnnx.param"), str(tmp_path / f"{tag}.pnnx.bin"))
    graph.save(*p)
    return tuple(open(f, "rb").read() for f in p)


def example(inputs):
    return inputs[0] if len(inputs) == 1 else tuple(inputs)


def nhwc(x):
    return np.transpose(x, (0, 2, 3, 1)) if x.ndim == 4 else x


@pytest.mark.parametrize("name", sorted(CASES))
def test_export_bytes_equal_jax(name, tmp_path):
    """The same module through both exporters: the same input / output
    names and the same .param / .bin bytes."""
    module, inputs, _ = make_case(name)
    tg, ti, to = export_torch(module, example(inputs))
    jg, ji, jo = jexport(module, example(inputs))
    assert (ti, to) == (ji, jo)
    assert saved(tg, tmp_path, "port") == saved(jg, tmp_path, "jax")


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_engine_matches_module(name):
    """The exported graph on the port's CPU Engine against the module's
    own forward (NCHW arrays fed and read NHWC, ids as float32)."""
    module, inputs, tol = make_case(name)
    with torch.no_grad():
        want = module(*[torch.from_numpy(x) for x in inputs]).numpy()
    graph, in_names, out_name = export_torch(module, example(inputs))
    names = in_names if isinstance(in_names, list) else [in_names]
    feeds = {n: nhwc(x).astype(np.float32) for n, x in zip(names, inputs)}
    got = Engine(CPU).load_model(None, graph=graph).run(feeds)[out_name]
    if got.ndim == 4:
        got = np.transpose(got, (0, 3, 1, 2))
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=1e-3)


def test_torch_tensor_example_equals_numpy(tmp_path):
    """A torch tensor as the example gives the numpy example's graph (the
    module's own device and dtype; here the CPU and float32)."""
    module, inputs, _ = make_case("mini_vit")
    a = export_torch(module, torch.from_numpy(inputs[0]))[0]
    b = export_torch(module, inputs[0])[0]
    assert saved(a, tmp_path, "t") == saved(b, tmp_path, "n")


def test_export_leaves_module_weights_unaliased():
    """The graph holds copies: changing the module after export does not
    change the exported weights (as the JAX exporter's astype copy)."""
    module = nn.Sequential(nn.Conv2d(3, 4, 1)).eval()
    graph = export_torch(module, np.zeros((1, 3, 4, 4), np.float32))[0]
    op = next(o for o in graph.ops if o.type == "nn.Conv2d")
    before = op.attrs["weight"].array().copy()
    with torch.no_grad():
        module[0].weight.add_(1.0)
    np.testing.assert_array_equal(op.attrs["weight"].array(), before)


def test_export_int8_static_path_on_port():
    """The exported graph on a static-int8 port engine (a 3x3 conv with
    128 input channels inside the s8 gate, the others weight-only),
    calibrated on the example: top-1 equal to the module's, and within
    0.1 x scale of it."""
    torch.manual_seed(1)
    m = nn.Sequential(
        nn.Conv2d(3, 128, 3, padding=1), nn.SiLU(),
        nn.Conv2d(128, 32, 3, padding=1), nn.SiLU(),
        nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.Linear(32, 4)).eval()
    x = np.random.default_rng(77).standard_normal(
        (2, 3, 16, 16)).astype(np.float32)
    graph, in_name, out_name = export_torch(m, x)
    eng = Engine(EngineConfig(device="cpu", quant="int8")).load_model(
        None, graph=graph)
    scales = eng.calibrate([{in_name: nhwc(x)}])
    assert scales
    got = eng.run({in_name: nhwc(x)})[out_name]
    with torch.no_grad():
        want = m(torch.from_numpy(x)).numpy()
    assert (got.argmax(-1) == want.argmax(-1)).all()
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= 0.1 * scale


class _Gru(nn.Module):
    def __init__(self):
        super().__init__()
        self.gru = nn.GRU(4, 4)

    def forward(self, x):
        return self.gru(x)[0]


class _IntIndex(nn.Module):
    def __init__(self):
        super().__init__()
        self.c = nn.Conv2d(3, 4, 1)

    def forward(self, x):
        return self.c(x)[0]


class _IntInTuple(nn.Module):
    def forward(self, x):
        return x[:, 0]


class _AddAlpha(nn.Module):
    def forward(self, x):
        return torch.add(x, x, alpha=2.0)


class _MeanNoDim(nn.Module):
    def forward(self, x):
        return torch.mean(x)


class _KeyPadding(nn.Module):
    def __init__(self):
        super().__init__()
        self.attn = nn.MultiheadAttention(8, 2, batch_first=True)

    def forward(self, x):
        mask = x[:, :, 0] > 10.0
        return self.attn(x, x, x, key_padding_mask=mask,
                         need_weights=False)[0]


class _BnNoStats(nn.Module):
    def __init__(self):
        super().__init__()
        self.bn = nn.BatchNorm2d(3, track_running_stats=False)

    def forward(self, x):
        return self.bn(x)


REFUSALS = {
    "gru_module": (_Gru, (2, 1, 4)),
    "int_index": (_IntIndex, (2, 3, 4, 4)),
    "int_in_tuple_index": (_IntInTuple, (2, 3, 4, 4)),
    "add_alpha": (_AddAlpha, (1, 3, 4, 4)),
    "mean_without_dim": (_MeanNoDim, (1, 3, 4, 4)),
    "mha_key_padding_mask": (_KeyPadding, (1, 4, 8)),
    "batchnorm_without_running_stats": (_BnNoStats, (1, 3, 4, 4)),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_match_jax(name):
    """What the JAX exporter refuses with TorchExportError the port
    refuses the same way (a ValueError subclass in both)."""
    make, shape = REFUSALS[name]
    torch.manual_seed(5)
    module = make().eval()
    x = np.random.default_rng(77).standard_normal(shape).astype(np.float32)
    with pytest.raises(JTorchExportError):
        jexport(module, x)
    with pytest.raises(TorchExportError):
        export_torch(module, x)


def test_missing_example_inputs_raise():
    class M(nn.Module):
        def forward(self, a, b):
            return a + b

    x = np.zeros((1, 3, 4, 4), np.float32)
    with pytest.raises((TorchExportError, TypeError)):
        export_torch(M(), x)


def test_example_that_does_not_propagate_raises():
    """An example of the wrong shape fails the shape propagation: a
    TorchExportError that names the device, never a silent graph."""
    module = nn.Sequential(nn.Linear(6, 4)).eval()
    with pytest.raises(TorchExportError, match="cpu"):
        export_torch(module, np.zeros((2, 5), np.float32))


# ---- chip_smoke.py's exported modules at a tiny width ------------------------
def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


TINY_EXPORTS = {
    "resnet50": lambda m: (lambda **fk: m.ResNet50(
        dict(width=8, blocks=(2, 1, 1, 1), classes=10), **fk)),
    "vit_b16": lambda m: (lambda **fk: m.ViT(
        dict(embed=32, heads=4, depth=2, mlp=64, patch=8, classes=6), 32,
        **fk)),
}


@pytest.mark.parametrize("name", sorted(TINY_EXPORTS))
def test_chip_smoke_export_modules_tiny(name, tmp_path):
    """chip_smoke.py's ResNet-50 (v1.5 layout) and ViT-B/16 modules at a
    tiny width, seeded as on the card: both exporters give the same
    bytes, and the port's fp32 Engine matches the module within the
    golden tolerance (5e-4 x scale + 5e-4 x |ref|)."""
    cs = _chip_smoke()
    module = cs.seeded_module(TINY_EXPORTS[name](cs.torch_modules()),
                              torch.device("cpu"), torch.float32)
    x = np.random.default_rng(0).standard_normal(
        (2, 3, 32, 32)).astype(np.float32)
    tg, ti, to = export_torch(module, x)
    assert saved(tg, tmp_path, "port") == saved(jexport(module, x)[0],
                                                tmp_path, "jax")
    got = Engine(CPU).load_model(None, graph=tg).run({ti: nhwc(x)})[to]
    with torch.no_grad():
        want = module(torch.from_numpy(x)).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=5e-4 * scale, rtol=5e-4)
