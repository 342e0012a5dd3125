"""The port's ONNX package against the JAX package's (styletts2_tpu.onnx):
the wire format byte for byte, the exporter byte for byte on the JAX ONNX
suite's trees for the three decoders, the export from the port's modules,
and every op of the port's torch runtime (CPU) against the numpy runtime
on single-node graphs with the exporter's attributes.

Tolerances: max |got - want| / max |want| <= 1e-5 per op, 1e-4 for
Conv, ConvTranspose and LSTM (the JAX suite's layer tests'); integer and
boolean outputs exactly."""

import numpy as np
import pytest
import torch

from styletts2_tpu.onnx import export_onnx as jax_export_onnx
from styletts2_tpu.onnx import proto as JP
from styletts2_tpu.onnx import runtime as JR
from styletts2_tpu.onnx.builder import GraphBuilder as JaxGraphBuilder
from styletts2_tpu_torch.onnx import export_modules, export_onnx
from styletts2_tpu_torch.onnx import proto as P
from styletts2_tpu_torch.onnx import runtime as R
from styletts2_tpu_torch.onnx.builder import GraphBuilder
from torch_onnx_common import DECODERS, jax_tree, port_cfg, port_modules

torch.set_num_threads(1)

_EXPORTS = {}


def jax_export(decoder):
    if decoder not in _EXPORTS:
        tree, cfg = jax_tree(decoder)
        _EXPORTS[decoder] = jax_export_onnx(tree, cfg)
    return _EXPORTS[decoder]


# --------------------------------------------------------------------------
# wire format
# --------------------------------------------------------------------------

def _messages(p, builder):
    """The JAX suite's proto messages (tests/test_onnx.py:53-88) and the
    other encoders, written with the proto module `p`."""
    b = builder("t")
    b.add_input("x", p.FLOAT, [1, "T"])
    w = b.init("w", np.arange(6, dtype=np.float32).reshape(2, 3))
    y = b.add("MatMul", ["x", w])
    b.i64([-3, 2 ** 40], "neg")
    b.add("Identity", [y], outputs=["y"])
    b.add_output("y", p.FLOAT, [1, "T2"])
    out = [b.build(opset=19)]
    for value in (3, -7, True, 2.5, "linear", [1, 2, 3], [0.5, 1.5],
                  ["a", "b"], np.arange(4, dtype=np.int64)):
        out.append(p.attribute("k", value))
    out += [p.varint(n) for n in (0, 1, 127, 128, 2 ** 35, -1, -(2 ** 40))]
    out.append(p.node("Conv", ["a", "b"], ["c"], name="n",
                      attrs={"strides": [2], "pads": [1, 1], "alpha": 0.2}))
    for arr in (np.ones((2, 3), np.float32), np.arange(5, dtype=np.int64),
                np.array([True, False]), np.float32(1.5)):
        out.append(p.tensor("t", np.asarray(arr)))
    out.append(p.value_info("v", p.INT64, ["n", 4]))
    return out


def test_proto_wire_format_matches_jax():
    ours, theirs = _messages(P, GraphBuilder), _messages(JP, JaxGraphBuilder)
    assert ours == theirs
    # JAX-written bytes decode to equal dicts, and so do the attributes
    for schema, data in [("Model", theirs[0])] + [
            ("Attribute", a) for a in theirs[1:10]]:
        assert P.decode(data, schema) == JP.decode(data, schema)
    for a in theirs[1:10]:
        got = P.attr_value(P.decode(a, "Attribute"))
        want = JP.attr_value(JP.decode(a, "Attribute"))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    t = P.decode(theirs[-2], "Tensor")
    np.testing.assert_array_equal(P.tensor_to_numpy(t), np.float32(1.5))
    m = P.decode(theirs[0], "Model")
    g = m["graph"][0]
    assert m["ir_version"] == [9] and m["opset_import"][0]["version"] == [19]
    assert [n["op_type"][0] for n in g["node"]] == ["MatMul", "Identity"]
    assert P.tensor_to_numpy(g["initializer"][1]).tolist() == [-3, 2 ** 40]


# --------------------------------------------------------------------------
# the exporter
# --------------------------------------------------------------------------

@pytest.mark.parametrize("decoder", DECODERS)
def test_export_byte_identical_to_jax(decoder):
    tree, _ = jax_tree(decoder)
    ours = export_onnx(tree, port_cfg(decoder))
    assert ours == jax_export(decoder), decoder


def _graph(data):
    g = P.decode(data, "Model")["graph"][0]
    nodes = [(n["op_type"][0], n.get("input", []), n["output"],
              [(a["name"][0], str(P.attr_value(a)))
               for a in n.get("attribute", [])]) for n in g["node"]]
    inits = {t["name"][0]: P.tensor_to_numpy(t) for t in g["initializer"]}
    return nodes, inits, g["input"], g["output"]


def test_export_modules_matches_jax_export():
    """The JAX trees carried into the port's modules (weights.
    load_param_tree: weight norm fused at load), then export_modules: the
    same nodes (op types, inputs, outputs, attributes) and graph I/O, every
    initializer within 1e-6 of its largest value (fusion may round by
    ulps), for the three decoders."""
    worst = {}
    for decoder in DECODERS:
        got = _graph(export_modules(port_modules(decoder), port_cfg(decoder)))
        want = _graph(jax_export(decoder))
        assert got[0] == want[0], decoder
        assert got[2:] == want[2:], decoder
        assert sorted(got[1]) == sorted(want[1]), decoder
        errs = []
        for name, w in want[1].items():
            g = got[1][name]
            assert g.shape == w.shape and g.dtype == w.dtype, name
            errs.append(float(np.abs(g.astype(np.float64) - w).max()
                               / max(np.abs(w).max(), 1e-30)) if w.size else 0)
        worst[decoder] = max(errs)
    print(f"export_modules vs the JAX export, initializers' worst scaled "
          f"max: {worst}")
    assert max(worst.values()) <= 1e-6, worst


# --------------------------------------------------------------------------
# the runtime, op by op
# --------------------------------------------------------------------------

def _f(rng, *shape, lo=None):
    x = rng.standard_normal(shape).astype(np.float32)
    return np.abs(x) + lo if lo is not None else x


def _cases():
    """(label, op, [(value, is_initializer)], attrs, n_outputs): every op
    of the exporter, with the attribute sets and input kinds it emits;
    shape-valued inputs both as initializers and as computed values."""
    rng = np.random.default_rng(0)
    x, y = _f(rng, 2, 3, 5), _f(rng, 2, 3, 5)
    i64 = lambda v: np.asarray(v, np.int64)  # noqa: E731
    f32 = lambda v: np.asarray(v, np.float32)  # noqa: E731
    mask = rng.standard_normal((2, 3, 5)) > 0
    c = []

    def add(label, op, ins, n_out=1, **attrs):
        c.append((label, op, ins, attrs, n_out))

    add("identity", "Identity", [(x, 0)])
    for op in ("Add", "Sub", "Mul", "Min"):
        add(op.lower(), op, [(x, 0), (y, 0)])
    add("add const", "Add", [(x, 0), (f32(0.7), 1)])
    add("mul const", "Mul", [(x, 0), (f32([[[2.0]]]), 1)])
    add("max const", "Max", [(x, 0), (f32(1e-11), 1)])
    z = x.copy()
    z[0, 0, :3] = 0.0
    add("div ieee", "Div", [(z, 0), (np.where(mask, z, 0.0).astype(np.float32), 0)])
    add("div int floor", "Div", [(i64([-7, 7, 9, -9]), 0), (i64([2, -2, 4, 4]), 0)])
    for op in ("Abs", "Sign", "Sin", "Cos", "Exp", "Atan", "Tanh", "Erf",
               "Sigmoid", "Floor", "Neg"):
        add(op.lower(), op, [(x * 3, 0)])
    add("sqrt", "Sqrt", [(_f(rng, 3, 7, lo=1e-3), 0)])
    add("round half even", "Round",
        [(f32([0.5, 1.5, 2.5, -0.5, -1.5, 3.49, 7.51, 1e7 + 1]), 0)])
    for alpha in (0.2, 0.1, 0.01):
        add(f"leakyrelu {alpha}", "LeakyRelu", [(x, 0)], alpha=alpha)
    add("clip lo", "Clip", [(x, 0), (f32(0.25), 1)])
    add("clip hi", "Clip", [(x, 0), ("", 0), (f32(0.5), 1)])
    for op in ("Greater", "GreaterOrEqual", "Less", "LessOrEqual"):
        add(op.lower(), op, [(x, 0), (y, 0)])
        add(op.lower() + " const", op, [(x, 0), (f32(0.1), 1)])
    add("and", "And", [(mask, 0), (x > 0, 0)])
    add("where", "Where", [(mask, 0), (x, 0), (y, 0)])
    add("where const", "Where", [(mask, 0), (f32(np.pi), 1), (y, 0)])
    add("cast", "Cast", [(mask, 0)], to=P.FLOAT)
    add("shape", "Shape", [(x, 0)])
    add("reshape", "Reshape", [(x, 0), (i64([1, -1, 6]), 1)])
    add("reshape computed", "Reshape", [(x, 0), (i64([5, 6]), 0)])
    for perm in ([0, 2, 1], [2, 0, 1]):
        add(f"transpose {perm}", "Transpose", [(x, 0)], perm=perm)
    add("transpose 4d", "Transpose", [(_f(rng, 2, 3, 4, 5), 0)],
        perm=[2, 0, 1, 3])
    add("unsqueeze", "Unsqueeze", [(x, 0), (i64([0, 3]), 1)])
    add("squeeze", "Squeeze", [(_f(rng, 1, 1, 7), 0), (i64([0, 1]), 1)])
    add("concat 1", "Concat", [(x, 0), (y, 0)], axis=1)
    add("concat i64", "Concat", [(i64([1]), 1), (i64([9]), 1), (i64([7]), 0)],
        axis=0)
    add("slice", "Slice", [(x, 0), (i64([1, -2]), 1), (i64([2 ** 62, -1]), 1),
                           (i64([0, 2]), 1)])
    add("slice computed", "Slice", [(i64([1, 9, 40]), 0), (i64([2]), 0),
                                    (i64([3]), 0), (i64([0]), 0)])
    add("gather", "Gather", [(_f(rng, 40, 8), 1), (i64([[3, 0, 39, 7]]), 0)],
        axis=0)
    add("expand", "Expand", [(f32(np.ones((1, 1, 1))), 1), (i64([1, 1, 9]), 0)])
    add("expand col", "Expand", [(_f(rng, 1, 4, 1), 0), (i64([1, 1, 6]), 0)])
    add("range", "Range", [(f32(0.0), 1), (f32(37.0), 0), (f32(1.0), 1)])
    durs = np.round(_f(rng, 40, lo=1.0) * 3).astype(np.float32)
    add("cumsum durations", "CumSum", [(durs, 0), (i64(0), 1)])
    add("cumsum phase", "CumSum", [(_f(rng, 1, 9, 700, lo=0.0) * 0.1, 0),
                                   (i64(2), 1)])
    add("reducesum all", "ReduceSum", [(i64([3, 7]), 0)], keepdims=0)
    add("reducesum", "ReduceSum", [(x, 0), (i64([-1]), 1)], keepdims=0)
    add("reducemean", "ReduceMean", [(_f(rng, 37), 0)], keepdims=0)
    add("matmul const", "MatMul", [(_f(rng, 1, 7, 16), 0), (_f(rng, 16, 9), 1)])
    add("matmul", "MatMul", [(_f(rng, 1, 16, 12), 0), (_f(rng, 12, 30), 0)])
    add("gemm", "Gemm", [(_f(rng, 1, 32), 0), (_f(rng, 20, 32), 1),
                         (_f(rng, 20), 1)], transB=1)
    add("layernorm", "LayerNormalization",
        [(_f(rng, 1, 11, 64) * 3 + 1, 0), (_f(rng, 64), 1), (_f(rng, 64), 1)],
        epsilon=1e-5)
    add("layernorm no bias", "LayerNormalization",
        [(_f(rng, 1, 11, 64), 0), (f32(np.ones(64)), 1)], epsilon=1e-5)
    add("layernorm 1e-6", "LayerNormalization",
        [(_f(rng, 1, 11, 64), 0), (_f(rng, 64), 1), (_f(rng, 64), 1)],
        epsilon=1e-6)
    add("instancenorm", "InstanceNormalization",
        [(_f(rng, 1, 16, 50) * 2 + 3, 0), (f32(np.ones(16)), 1),
         (f32(np.zeros(16)), 1)], epsilon=1e-5)
    xc = _f(rng, 1, 8, 50)
    for label, w, b, attrs in (
            ("conv dilated", _f(rng, 16, 8, 5), _f(rng, 16),
             dict(strides=[1], pads=[4, 4], dilations=[2], group=1)),
            ("conv strided", _f(rng, 4, 8, 3), _f(rng, 4),
             dict(strides=[2], pads=[1, 1], dilations=[1], group=1)),
            ("conv depthwise", _f(rng, 8, 1, 7), _f(rng, 8),
             dict(strides=[1], pads=[3, 3], dilations=[1], group=8)),
            ("conv no bias", _f(rng, 6, 8, 20), None,
             dict(strides=[5], pads=[0, 0], dilations=[1], group=1)),
            ("conv 1x1 bare", _f(rng, 1, 8, 1), _f(rng, 1), {})):
        ins = [(xc, 0), (w, 1)] + ([(b, 1)] if b is not None else [])
        add(label, "Conv", ins, **attrs)
    for label, xt, w, attrs in (
            ("convtranspose up10", _f(rng, 1, 8, 12), _f(rng, 8, 4, 20),
             dict(strides=[10], pads=[5, 5], output_padding=[0], group=1)),
            ("convtranspose odd", _f(rng, 1, 8, 12), _f(rng, 8, 4, 7),
             dict(strides=[3], pads=[2, 2], output_padding=[1], group=1)),
            ("convtranspose depthwise", _f(rng, 1, 6, 30), _f(rng, 6, 1, 3),
             dict(strides=[2], pads=[1, 1], output_padding=[1], group=6))):
        add(label, "ConvTranspose", [(xt, 0), (w, 1), (_f(rng, w.shape[1] * attrs["group"]), 1)],
            **attrs)
    add("convtranspose istft", "ConvTranspose",
        [(_f(rng, 1, 11, 40), 0), (_f(rng, 11, 1, 20), 1)], strides=[5])
    for mode in ("edge", "reflect", "constant"):
        add(f"pad {mode}", "Pad", [(_f(rng, 1, 2, 30), 0),
                                   (i64([0, 0, 10, 0, 1, 7]), 1)], mode=mode)
    add("resize nearest", "Resize", [(_f(rng, 1, 2, 40), 0), ("", 0),
                                     (f32([1.0, 1.0, 300.0]), 1)],
        mode="nearest", coordinate_transformation_mode="asymmetric",
        nearest_mode="floor")
    # t_out 4.5e5: float32 source coordinates would be ~1e-4 of a sample off
    add("resize linear", "Resize", [(_f(rng, 1, 3, 1500), 0), ("", 0), ("", 0),
                                    (i64([1, 3, 450000]), 0)],
        mode="linear", coordinate_transformation_mode="pytorch_half_pixel")
    add("resize linear down", "Resize", [(_f(rng, 1, 9, 3000), 0), ("", 0),
                                         ("", 0), (i64([1, 9, 10]), 0)],
        mode="linear", coordinate_transformation_mode="pytorch_half_pixel")
    hid = 32
    add("lstm", "LSTM", [(_f(rng, 9, 1, 24), 0), (_f(rng, 2, 4 * hid, 24) * .3, 1),
                         (_f(rng, 2, 4 * hid, hid) * .3, 1),
                         (_f(rng, 2, 8 * hid) * .3, 1)],
        n_out=3, hidden_size=hid, direction="bidirectional")
    return c


def _run(runtime, builder, p, op, ins, attrs, n_out, **kw):
    b = builder("op")
    names, feeds = [], {}
    for i, (v, is_init) in enumerate(ins):
        if isinstance(v, str):
            names.append(v)
            continue
        v = np.asarray(v)
        if is_init:
            names.append(b.init(f"in{i}", v))
        else:
            b.add_input(f"in{i}", p.NP_TO_ONNX[v.dtype], list(v.shape))
            names.append(f"in{i}")
            feeds[f"in{i}"] = v
    out = b.add(op, names, n_outputs=n_out, **attrs)
    b.add_output(out if isinstance(out, str) else out[0], p.FLOAT, [])
    return np.asarray(runtime.OnnxModel(b.build(), **kw).run(feeds)[0])


LOOSE = {"Conv": 1e-4, "ConvTranspose": 1e-4, "LSTM": 1e-4}


def test_runtime_every_op_matches_numpy_runtime():
    """Each op of the exporter's three graphs (the op types of the hifigan,
    istftnet and vocos exports: every op the numpy runtime implements)
    through the port's runtime on the CPU and the numpy runtime; every
    failing case is reported."""
    cases = _cases()
    emitted = set()
    for decoder in DECODERS:
        emitted |= {n["op_type"][0] for n in
                    P.decode(jax_export(decoder), "Model")["graph"][0]["node"]}
    covered = {op for _, op, _, _, _ in cases}
    assert emitted <= covered, sorted(emitted - covered)
    assert set(R._OPS) == set(JR._OPS) == covered, sorted(
        set(JR._OPS) ^ covered)
    failures, worst = [], {}
    for label, op, ins, attrs, n_out in cases:
        want = _run(JR, JaxGraphBuilder, JP, op, ins, attrs, n_out)
        got = _run(R, GraphBuilder, P, op, ins, attrs, n_out, device="cpu")
        if got.shape != want.shape or got.dtype != want.dtype:
            failures.append(f"{label}: {got.dtype}{got.shape} vs "
                            f"{want.dtype}{want.shape}")
            continue
        if not np.issubdtype(want.dtype, np.floating):
            if not np.array_equal(got, want):
                failures.append(f"{label}: values differ")
            continue
        if not np.array_equal(np.isfinite(got), np.isfinite(want)) or \
                not np.array_equal(got[~np.isfinite(got)].astype(str),
                                   want[~np.isfinite(want)].astype(str)):
            failures.append(f"{label}: non-finite values differ")
            continue
        fin = np.isfinite(want)
        err = float(np.abs(got[fin].astype(np.float64) - want[fin]).max()
                    / max(np.abs(want[fin]).max(), 1e-30)) if fin.any() else 0
        worst[label] = err
        if err > LOOSE.get(op, 1e-5):
            failures.append(f"{label}: scaled max error {err:.3g}")
    print("runtime vs numpy runtime, largest scaled max errors: "
          + ", ".join(f"{k} {v:.2g}" for k, v in
                      sorted(worst.items(), key=lambda kv: -kv[1])[:8]))
    assert not failures, failures


def test_runtime_refuses_what_it_does_not_implement():
    b = GraphBuilder("op")
    b.add_input("x", P.FLOAT, [2])
    b.add_output(b.add("HardSwish", ["x"]), P.FLOAT, [2])
    with pytest.raises(NotImplementedError, match="op HardSwish"):
        R.OnnxModel(b.build(), device="cpu").run({"x": np.ones(2, np.float32)})
    x = np.ones((1, 2, 4), np.float32)
    for op, ins, attrs in (
            ("LayerNormalization", [(x, 0), (np.ones(4, np.float32), 1)],
             dict(axis=1)),
            ("CumSum", [(x, 0), (np.asarray(2, np.int64), 1)],
             dict(exclusive=1)),
            ("Resize", [(x, 0), ("", 0), (np.float32([1, 1, 2]), 1)],
             dict(mode="cubic")),
            ("LSTM", [(np.ones((3, 1, 2), np.float32), 0),
                      (np.ones((1, 8, 2), np.float32), 1),
                      (np.ones((1, 8, 2), np.float32), 1)],
             dict(hidden_size=2, clip=1.0))):
        with pytest.raises(ValueError, match="unsupported"):
            _run(R, GraphBuilder, P, op, ins, attrs, 1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            R.OnnxModel(b.build())
