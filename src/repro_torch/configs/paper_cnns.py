"""Layer-DAG reconstructions of the paper's evaluation models (§5-§7).

The paper partitions pretrained Keras/TFHub image and text models.  We
rebuild their computation DAGs programmatically with shape propagation so
that every vertex carries realistic output-tensor sizes (eta), parameter
bytes, and FLOPs.  fp32 activations/weights, batch size 1 — matching the
paper's conservative memory accounting ("we do not consider quantization
when calculating the memory footprint").

Models: ResNet50, InceptionResNetV2, MobileNetV2, VGG16, DenseNet121,
BERT-Base/Large (text), and a NASNet-style counterexample whose dense
cross-cell links admit no candidate partition points (paper Fig. 4).
"""

from __future__ import annotations

import math

from repro_torch.core.graph import Layer, LayerGraph

F32 = 4


class ConvNetBuilder:
    """Shape-propagating DAG builder: each op adds a vertex with out_bytes,
    param_bytes and forward FLOPs computed from the propagated (H, W, C)."""

    def __init__(self, h: int, w: int, c: int, name: str = "input"):
        self.g = LayerGraph()
        self.shape: dict[str, tuple[int, int, int]] = {}
        self.g.add(Layer(name, out_bytes=h * w * c * F32))
        self.shape[name] = (h, w, c)
        self.counter = 0

    def _nm(self, kind: str) -> str:
        self.counter += 1
        return f"{kind}_{self.counter}"

    def _add(self, kind, inputs, shape, params=0, flops=0.0):
        h, w, c = shape
        nm = self._nm(kind)
        self.g.add(Layer(nm, out_bytes=h * w * c * F32,
                         param_bytes=params * F32, flops=flops,
                         work_bytes=h * w * c * F32), list(inputs))
        self.shape[nm] = shape
        return nm

    def conv(self, x, filters, k=3, stride=1, depthwise=False):
        h, w, c = self.shape[x]
        ho, wo = math.ceil(h / stride), math.ceil(w / stride)
        if depthwise:
            params = k * k * c + c
            flops = 2.0 * ho * wo * c * k * k
            filters = c
        else:
            params = k * k * c * filters + filters
            flops = 2.0 * ho * wo * filters * c * k * k
        return self._add("conv", [x], (ho, wo, filters), params, flops)

    def conv_rect(self, x, filters, kh, kw):
        h, w, c = self.shape[x]
        params = kh * kw * c * filters + filters
        flops = 2.0 * h * w * filters * c * kh * kw
        return self._add("conv", [x], (h, w, filters), params, flops)

    def pool(self, x, stride=2):
        h, w, c = self.shape[x]
        return self._add("pool", [x], (math.ceil(h / stride),
                                       math.ceil(w / stride), c))

    def global_pool(self, x):
        _, _, c = self.shape[x]
        return self._add("gap", [x], (1, 1, c))

    def dense(self, x, units):
        _, _, c = self.shape[x]
        return self._add("dense", [x], (1, 1, units),
                         params=c * units + units, flops=2.0 * c * units)

    def add_op(self, xs):
        shp = self.shape[xs[0]]
        return self._add("add", xs, shp)

    def concat(self, xs):
        h, w, _ = self.shape[xs[0]]
        c = sum(self.shape[x][2] for x in xs)
        return self._add("concat", xs, (h, w, c))


def resnet50() -> LayerGraph:
    b = ConvNetBuilder(224, 224, 3)
    x = b.conv("input", 64, k=7, stride=2)
    x = b.pool(x)
    for stage, (blocks, width) in enumerate([(3, 64), (4, 128), (6, 256), (3, 512)]):
        for blk in range(blocks):
            stride = 2 if (blk == 0 and stage > 0) else 1
            sc = b.conv(x, width * 4, k=1, stride=stride) if blk == 0 else x
            y = b.conv(x, width, k=1, stride=stride)
            y = b.conv(y, width, k=3)
            y = b.conv(y, width * 4, k=1)
            x = b.add_op([y, sc])
    x = b.global_pool(x)
    b.dense(x, 1000)
    return b.g


def vgg16() -> LayerGraph:
    b = ConvNetBuilder(224, 224, 3)
    x = "input"
    for blocks, width in [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]:
        for _ in range(blocks):
            x = b.conv(x, width, k=3)
        x = b.pool(x)
    x = b.global_pool(x)          # stand-in for flatten (keeps bytes modest)
    x = b.dense(x, 4096)
    # reconstruct the real flatten->fc1 parameter count (25088 x 4096)
    b.g.layers[x].param_bytes = (25088 * 4096 + 4096) * F32
    x = b.dense(x, 4096)
    b.dense(x, 1000)
    return b.g


def mobilenetv2() -> LayerGraph:
    b = ConvNetBuilder(224, 224, 3)
    x = b.conv("input", 32, k=3, stride=2)
    x = b.conv(x, 32, k=3, depthwise=True)
    x = b.conv(x, 16, k=1)
    spec = [(6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1),
            (6, 160, 3, 2), (6, 320, 1, 1)]
    for t, cout, n, s in spec:
        for i in range(n):
            stride = s if i == 0 else 1
            cin = b.shape[x][2]
            y = b.conv(x, cin * t, k=1)
            y = b.conv(y, cin * t, k=3, stride=stride, depthwise=True)
            y = b.conv(y, cout, k=1)
            x = b.add_op([x, y]) if (stride == 1 and cin == cout) else y
    x = b.conv(x, 1280, k=1)
    x = b.global_pool(x)
    b.dense(x, 1000)
    return b.g


def inception_resnet_v2() -> LayerGraph:
    b = ConvNetBuilder(299, 299, 3)
    # stem (abridged but shape-faithful: 299 -> 35x35x320)
    x = b.conv("input", 32, k=3, stride=2)
    x = b.conv(x, 32, k=3)
    x = b.conv(x, 64, k=3)
    x = b.pool(x)
    x = b.conv(x, 80, k=1)
    x = b.conv(x, 192, k=3)
    x = b.pool(x)
    br1 = b.conv(x, 96, k=1)
    br2 = b.conv(b.conv(x, 48, k=1), 64, k=5)
    br3 = b.conv(b.conv(b.conv(x, 64, k=1), 96, k=3), 96, k=3)
    x = b.concat([br1, br2, br3])       # 35x35x(96+64+96)=256 ~ official 320

    def block35(x):
        b1 = b.conv(x, 32, k=1)
        b2 = b.conv(b.conv(x, 32, k=1), 32, k=3)
        b3 = b.conv(b.conv(b.conv(x, 32, k=1), 48, k=3), 64, k=3)
        up = b.conv(b.concat([b1, b2, b3]), b.shape[x][2], k=1)
        return b.add_op([x, up])

    for _ in range(10):
        x = block35(x)
    # reduction-A: 35 -> 17
    r1 = b.conv(x, 384, k=3, stride=2)
    r2 = b.conv(b.conv(b.conv(x, 256, k=1), 256, k=3), 384, k=3, stride=2)
    r3 = b.pool(x)
    x = b.concat([r1, r2, r3])

    def block17(x):
        b1 = b.conv(x, 192, k=1)
        b2 = b.conv_rect(b.conv_rect(b.conv(x, 128, k=1), 160, 1, 7), 192, 7, 1)
        up = b.conv(b.concat([b1, b2]), b.shape[x][2], k=1)
        return b.add_op([x, up])

    for _ in range(20):
        x = block17(x)
    # reduction-B: 17 -> 8
    r1 = b.conv(b.conv(x, 256, k=1), 384, k=3, stride=2)
    r2 = b.conv(b.conv(x, 256, k=1), 288, k=3, stride=2)
    r3 = b.conv(b.conv(b.conv(x, 256, k=1), 288, k=3), 320, k=3, stride=2)
    r4 = b.pool(x)
    x = b.concat([r1, r2, r3, r4])

    def block8(x):
        b1 = b.conv(x, 192, k=1)
        b2 = b.conv_rect(b.conv_rect(b.conv(x, 192, k=1), 224, 1, 3), 256, 3, 1)
        up = b.conv(b.concat([b1, b2]), b.shape[x][2], k=1)
        return b.add_op([x, up])

    for _ in range(10):
        x = block8(x)
    x = b.conv(x, 1536, k=1)
    x = b.global_pool(x)
    b.dense(x, 1000)
    return b.g


def densenet121() -> LayerGraph:
    b = ConvNetBuilder(224, 224, 3)
    x = b.conv("input", 64, k=7, stride=2)
    x = b.pool(x)
    growth = 32
    for bi, layers in enumerate([6, 12, 24, 16]):
        feats = [x]
        for _ in range(layers):
            inp = feats[-1] if len(feats) == 1 else b.concat(feats)
            y = b.conv(inp, 4 * growth, k=1)
            y = b.conv(y, growth, k=3)
            feats.append(y)
        x = b.concat(feats)
        if bi < 3:                      # transition
            x = b.conv(x, b.shape[x][2] // 2, k=1)
            x = b.pool(x)
    x = b.global_pool(x)
    b.dense(x, 1000)
    return b.g


def nasnet_like(cells: int = 8) -> LayerGraph:
    """Paper Fig. 4: every cell consumes the outputs of the previous *two*
    cells, so no single vertex dominates all paths => no candidate points."""
    b = ConvNetBuilder(224, 224, 3)
    p2 = b.conv("input", 44, k=3, stride=2)
    p1 = b.conv(p2, 44, k=3)
    for _ in range(cells):
        a = b.conv(p1, 44, k=3)
        c = b.concat([a, p2])
        p2, p1 = p1, c
    x = b.concat([p1, p2])
    x = b.global_pool(x)
    b.dense(x, 1000)
    return b.g


def bert(layers: int = 12, hidden: int = 768, seq: int = 128,
         vocab: int = 30522) -> LayerGraph:
    """Text-model DAG at block granularity (TFHub BERT family)."""
    g = LayerGraph()
    inter = hidden * 4
    act = seq * hidden * F32
    g.add(Layer("input", out_bytes=seq * 4))
    g.add(Layer("embed", out_bytes=act, param_bytes=(vocab + 512 + 2) * hidden * F32,
                flops=0.0), ["input"])
    prev = "embed"
    for i in range(layers):
        p_attn = 4 * hidden * hidden + 4 * hidden
        p_ffn = 2 * hidden * inter + hidden + inter
        fl = 2.0 * seq * (4 * hidden * hidden + 2 * hidden * inter) \
            + 4.0 * seq * seq * hidden
        g.add(Layer(f"block{i}", out_bytes=act,
                    param_bytes=(p_attn + p_ffn + 4 * hidden) * F32,
                    work_bytes=3 * act, flops=fl), [prev])
        prev = f"block{i}"
    g.add(Layer("pooler", out_bytes=hidden * F32,
                param_bytes=(hidden * hidden + hidden) * F32), [prev])
    return g


def bert_base() -> LayerGraph:
    return bert(12, 768)


def bert_large() -> LayerGraph:
    return bert(24, 1024)


PAPER_MODELS = {
    "ResNet50": resnet50,
    "InceptionResNetV2": inception_resnet_v2,
    "MobileNetV2": mobilenetv2,
    "VGG16": vgg16,
    "DenseNet121": densenet121,
    "BERT-Base": bert_base,
    "BERT-Large": bert_large,
}
