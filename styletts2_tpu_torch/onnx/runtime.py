"""A torch evaluator for the ONNX op subset the exporter emits.

The port's counterpart of styletts2_tpu/onnx/runtime.py (a numpy
evaluator): every op runs as torch ops on an explicit device, so the
full-width graph evaluates in seconds on a GPU. It exists for checks (the
exported graph against the port's own modules, on the card and on the
CPU) and for hosts without onnxruntime; the serving path stays the engine
(infer.StyleTTS2).

    model = OnnxModel(data, device="cuda")   # "cpu" must be asked for
    wav, = model.run({"tokens": tokens, "style": style, "speed": speed})

Op semantics follow the ONNX operator spec (opset 19) for exactly the
attributes the exporter uses, as the numpy evaluator reads them; an
unsupported attribute combination raises ValueError, an op outside the
subset NotImplementedError. Where a plain torch translation would depart
from the numpy evaluator:
* f32 convolutions and matmuls run with TF32 off (cuDNN and cuBLAS take
  TF32 by default on the GPU); `run` restores both flags after;
* Resize computes its source coordinates in float64 and casts only the
  interpolation weights to f32 (the NSF source upsamples by 300 to ~5e5
  samples, where f32 coordinates are ~1e-2 of a sample off);
* integer Div floors; float Div is IEEE (0/0 is NaN, x/0 inf: the iSTFT
  envelope division relies on it, and crops the result);
* Sigmoid, CumSum and the reductions (ReduceSum / ReduceMean and the
  normalizations' statistics) accumulate in float64 and round to f32, as
  the numpy evaluator's float64 Sigmoid and torch's CPU CumSum do, so
  the CPU and CUDA evaluations round the durations alike;
* LSTM is an explicit scan in ONNX gate order (i, o, f, c): cuDNN's LSTM
  rounds differently from the CPU's;
* shape-valued inputs (Reshape, Slice, Expand, Range, Resize sizes, ...)
  are read to the host once per node; int64 initializers and Shape
  outputs are known there already.
Feeds are numpy arrays or tensors; outputs are numpy arrays.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from styletts2_tpu_torch.onnx import proto as P

_TORCH_DTYPES = {
    P.FLOAT: torch.float32, P.DOUBLE: torch.float64, P.INT64: torch.int64,
    P.INT32: torch.int32, P.BOOL: torch.bool, P.FLOAT16: torch.float16,
    P.UINT8: torch.uint8, P.INT8: torch.int8,
}


@contextlib.contextmanager
def _no_tf32():
    """f32 convolutions and matmuls in true f32 (cuDNN and cuBLAS default
    to TF32 on the GPU); both flags restored on exit."""
    mm, conv = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = conv


class OnnxModel:
    """Parse ModelProto bytes and evaluate with torch on `device`.

    device: "cuda" (the default) raises when no GPU is present; "cpu"
    must be asked for."""

    def __init__(self, data: bytes, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("OnnxModel(device='cuda'): no CUDA device is "
                               "available; pass device='cpu' to run on CPU")
        m = P.decode(data, "Model")
        self.ir_version = m["ir_version"][0]
        g = m["graph"][0]
        self.graph_name = g.get("name", [""])[0]
        self.nodes = g.get("node", [])
        self.input_names = [vi["name"][0] for vi in g.get("input", [])]
        self.output_names = [vi["name"][0] for vi in g.get("output", [])]
        self.initializers: Dict[str, torch.Tensor] = {}
        # host copies of the small integer initializers (shapes, axes,
        # slice bounds): read by the nodes without a device sync
        self._host_inits: Dict[str, List[Any]] = {}
        for t in g.get("initializer", []):
            arr = P.tensor_to_numpy(t)
            name = t["name"][0]
            self.initializers[name] = torch.from_numpy(arr.copy()).to(
                self.device)
            if arr.dtype == np.int64 and arr.size <= 64:
                self._host_inits[name] = arr.tolist()
        # each value is dropped after the last node that reads it
        last: Dict[str, int] = {}
        for i, nd in enumerate(self.nodes):
            for name in nd.get("input", []):
                last[name] = i
        keep = set(self.output_names) | set(self.initializers)
        self._drop = [[] for _ in self.nodes]
        for name, i in last.items():
            if name not in keep and name:
                self._drop[i].append(name)

    def _tensor(self, v) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v.to(self.device)
        return torch.from_numpy(np.array(v)).to(self.device)

    @torch.inference_mode()
    def run(self, feeds: Dict[str, Any]) -> List[np.ndarray]:
        env: Dict[str, Any] = dict(self.initializers)
        env[""] = None  # optional (empty) input slots
        host: Dict[str, List[Any]] = dict(self._host_inits)
        for name, v in feeds.items():
            env[name] = self._tensor(v)
        with _no_tf32():
            for nd, drop in zip(self.nodes, self._drop):
                op = nd["op_type"][0]
                fn = _OPS.get(op)
                if fn is None:
                    raise NotImplementedError(f"op {op}")
                names = nd.get("input", [])
                ins = _Inputs([env[i] for i in names], names, host)
                attrs = {a["name"][0]: P.attr_value(a)
                         for a in nd.get("attribute", [])}
                outs = fn(ins, attrs)
                if not isinstance(outs, (list, tuple)):
                    outs = [outs]
                for name, val in zip(nd["output"], outs):
                    env[name] = val
                if op == "Shape":
                    host[nd["output"][0]] = list(env[names[0]].shape)
                for name in drop:
                    env.pop(name, None)
        return [env[n].cpu().numpy() for n in self.output_names]


class _Inputs(list):
    """A node's input tensors (None for an empty slot), with `.host(i)`:
    input i as a flat host list, read from the device once."""

    def __init__(self, values, names, host):
        super().__init__(values)
        self._names, self._host = names, host

    def given(self, i: int) -> bool:
        return i < len(self) and self[i] is not None

    def host(self, i: int) -> List[Any]:
        name = self._names[i]
        if name not in self._host:
            self._host[name] = self[i].reshape(-1).tolist()
        v = self._host[name]
        return v if isinstance(v, list) else [v]


# --------------------------------------------------------------------------
# op implementations
# --------------------------------------------------------------------------

_OPS: Dict[str, Any] = {}


def op(name):
    def deco(fn):
        _OPS[name] = fn
        return fn
    return deco


def _unsupported(what: str, attrs) -> ValueError:
    return ValueError(f"unsupported {what}: {attrs}")


@op("Identity")
def _identity(ins, a):
    return ins[0]


_BINARY = {"Add": torch.add, "Sub": torch.sub, "Mul": torch.mul,
           "Greater": torch.gt, "GreaterOrEqual": torch.ge,
           "Less": torch.lt, "LessOrEqual": torch.le,
           "And": torch.logical_and}
for _name, _fn in _BINARY.items():
    _OPS[_name] = (lambda f: lambda ins, a: f(ins[0], ins[1]))(_fn)

_UNARY = {"Abs": torch.abs, "Sign": torch.sign, "Sqrt": torch.sqrt,
          "Sin": torch.sin, "Cos": torch.cos, "Exp": torch.exp,
          "Atan": torch.atan, "Tanh": torch.tanh, "Erf": torch.erf,
          "Round": torch.round,  # half to even, as the ONNX spec and numpy
          "Floor": torch.floor, "Neg": torch.neg}
for _name, _fn in _UNARY.items():
    _OPS[_name] = (lambda f: lambda ins, a: f(ins[0]))(_fn)


@op("Div")
def _div(ins, a):
    x, y = ins
    if not x.is_floating_point() and not y.is_floating_point():
        return torch.div(x, y, rounding_mode="floor")
    return x / y  # IEEE: 0/0 -> nan, x/0 -> inf


def _variadic(fn):
    def apply(ins, a):
        out = ins[0]
        for x in ins[1:]:
            out = fn(out, x)
        return out
    return apply


_OPS["Min"] = _variadic(torch.minimum)
_OPS["Max"] = _variadic(torch.maximum)


@op("Sigmoid")
def _sigmoid(ins, a):
    x = ins[0]
    return torch.sigmoid(x.double()).to(x.dtype)


@op("LeakyRelu")
def _leaky(ins, a):
    x = ins[0]
    return torch.where(x >= 0, x, a.get("alpha", 0.01) * x)


@op("Clip")
def _clip(ins, a):
    lo = ins[1] if ins.given(1) else None
    hi = ins[2] if ins.given(2) else None
    return torch.clamp(ins[0], lo, hi)


@op("Where")
def _where(ins, a):
    return torch.where(ins[0], ins[1], ins[2])


@op("Cast")
def _cast(ins, a):
    return ins[0].to(_TORCH_DTYPES[a["to"]])


@op("Shape")
def _shape(ins, a):
    return torch.tensor(list(ins[0].shape), dtype=torch.int64,
                        device=ins[0].device)


@op("Reshape")
def _reshape(ins, a):
    return ins[0].reshape([int(s) for s in ins.host(1)])


@op("Transpose")
def _transpose(ins, a):
    return ins[0].permute(*a["perm"])


@op("Unsqueeze")
def _unsqueeze(ins, a):
    x = ins[0]
    for ax in sorted(int(v) for v in ins.host(1)):
        x = x.unsqueeze(ax)
    return x


@op("Squeeze")
def _squeeze(ins, a):
    x = ins[0]
    dims = [int(v) % x.dim() for v in ins.host(1)]
    for d in dims:
        if x.shape[d] != 1:
            raise ValueError(f"Squeeze of axis {d} of size {x.shape[d]}")
    return x.squeeze(tuple(dims)) if dims else x


@op("Concat")
def _concat(ins, a):
    return torch.cat(list(ins), dim=a["axis"])


@op("Slice")
def _slice(ins, a):
    x = ins[0]
    starts, ends, axes = ins.host(1), ins.host(2), ins.host(3)
    steps = ins.host(4) if ins.given(4) else [1] * len(starts)
    sl = [slice(None)] * x.dim()
    for s, e, ax, st in zip(starts, ends, axes, steps):
        if int(st) <= 0:
            raise _unsupported("Slice step", st)
        sl[int(ax)] = slice(int(s), None if int(e) >= 2**62 else int(e),
                            int(st))
    return x[tuple(sl)]


@op("Gather")
def _gather(ins, a):
    x, idx = ins
    axis = a.get("axis", 0) % x.dim()
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    out = torch.index_select(x, axis, idx.reshape(-1))
    return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


@op("Expand")
def _expand(ins, a):
    x = ins[0]
    shape = torch.broadcast_shapes(x.shape,
                                   tuple(int(v) for v in ins.host(1)))
    return x.expand(shape).contiguous()


@op("Range")
def _range(ins, a):
    start, limit, delta = (ins.host(i)[0] for i in range(3))
    return torch.arange(start, limit, delta, dtype=ins[0].dtype,
                        device=ins[0].device)


@op("CumSum")
def _cumsum(ins, a):
    if a.get("exclusive", 0) or a.get("reverse", 0):
        raise _unsupported("CumSum attributes", a)
    x = ins[0]
    acc = torch.float64 if x.is_floating_point() else x.dtype
    return torch.cumsum(x, dim=int(ins.host(1)[0]), dtype=acc).to(x.dtype)


def _reduce(fn):
    def apply(ins, a):
        x = ins[0]
        keep = bool(a.get("keepdims", 1))
        dims = ([int(v) for v in ins.host(1)] if ins.given(1)
                else list(range(x.dim())))
        acc = torch.float64 if x.is_floating_point() else x.dtype
        return fn(x.to(acc), dim=dims, keepdim=keep).to(x.dtype)
    return apply


_OPS["ReduceSum"] = _reduce(torch.sum)
_OPS["ReduceMean"] = _reduce(torch.mean)


@op("MatMul")
def _matmul(ins, a):
    return torch.matmul(ins[0].float(), ins[1].float())


@op("Gemm")
def _gemm(ins, a):
    x, w = ins[0].float(), ins[1].float()
    if a.get("transA", 0):
        x = x.T
    if a.get("transB", 0):
        w = w.T
    y = a.get("alpha", 1.0) * (x @ w)
    if ins.given(2):
        y = y + a.get("beta", 1.0) * ins[2]
    return y.float()


def _normalize(x: torch.Tensor, dims, eps: float) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) over `dims`, the statistics accumulated
    in float64 and rounded to f32."""
    xd = x.double()
    mean = xd.mean(dim=dims, keepdim=True)
    var = ((xd - mean) ** 2).mean(dim=dims, keepdim=True)
    return (x - mean.float()) / torch.sqrt(var.float() + eps)


@op("LayerNormalization")
def _layernorm(ins, a):
    x = ins[0].float()
    if a.get("axis", -1) not in (-1, x.dim() - 1):
        raise _unsupported("LayerNormalization axis", a)
    y = _normalize(x, [-1], a.get("epsilon", 1e-5)) * ins[1]
    if ins.given(2):
        y = y + ins[2]
    return y.to(ins[0].dtype)


@op("InstanceNormalization")
def _instancenorm(ins, a):
    x = ins[0].float()  # (B, C, *spatial)
    y = _normalize(x, list(range(2, x.dim())), a.get("epsilon", 1e-5))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return (y * ins[1].reshape(shape) + ins[2].reshape(shape)).to(
        ins[0].dtype)


def _conv_attrs(a, x, what: str):
    if x.dim() != 3:
        raise _unsupported(f"{what} input rank {x.dim()} (1-D only)", a)
    if a.get("auto_pad", "NOTSET") != "NOTSET":
        raise _unsupported(f"{what} auto_pad", a)
    (stride,) = a.get("strides", [1])
    (dil,) = a.get("dilations", [1])
    pads = a.get("pads", [0, 0])
    return a.get("group", 1), stride, dil, pads


@op("Conv")
def _conv(ins, a):
    x, w = ins[0].float(), ins[1].float()
    b = ins[2].float() if ins.given(2) else None
    group, stride, dil, pads = _conv_attrs(a, x, "Conv")
    if pads[0] != pads[1]:
        x = F.pad(x, (pads[0], pads[1]))
        pads = [0, 0]
    return F.conv1d(x, w, b, stride=stride, padding=pads[0], dilation=dil,
                    groups=group)


@op("ConvTranspose")
def _conv_transpose(ins, a):
    x, w = ins[0].float(), ins[1].float()
    b = ins[2].float() if ins.given(2) else None
    group, stride, dil, pads = _conv_attrs(a, x, "ConvTranspose")
    if dil != 1:
        raise _unsupported("ConvTranspose dilation", a)
    (outpad,) = a.get("output_padding", [0])
    # the full overlap-add, then the numpy evaluator's crop: pads[0] off
    # the front, pads[1] off the back less output_padding, which extends
    # the output into the tail pads[1] would have cropped (zeros past the
    # last sample)
    full = F.conv_transpose1d(x, w, None, stride=stride, groups=group)
    full_len = full.shape[-1]
    end = full_len - pads[1] + outpad
    out = full[:, :, pads[0]: min(end, full_len)]
    if end > full_len:
        out = F.pad(out, (0, end - full_len))
    if b is not None:
        out = out + b[None, :, None]
    return out


@op("Pad")
def _pad(ins, a):
    x = ins[0]
    pads = [int(v) for v in ins.host(1)]
    mode = a.get("mode", "constant")
    n = x.dim()
    if ins.given(3):
        raise _unsupported("Pad axes input", ins.host(3))
    if mode == "constant":
        if ins.given(2) and float(ins.host(2)[0]) != 0.0:
            raise _unsupported("Pad constant value", ins.host(2))
        flat = []
        for i in reversed(range(n)):
            flat += [pads[i], pads[i + n]]
        return F.pad(x, flat)
    if mode not in ("edge", "reflect"):
        raise _unsupported("Pad mode", a)
    # index gathers per axis: edge repeats the end sample, reflect mirrors
    # about it (numpy's modes)
    for i in range(n):
        lo, hi = pads[i], pads[i + n]
        if lo == hi == 0:
            continue
        size = x.shape[i]
        idx = torch.arange(-lo, size + hi, device=x.device)
        if mode == "edge":
            idx = idx.clamp(0, size - 1)
        else:
            if lo >= size or hi >= size:
                raise _unsupported("reflect Pad wider than the axis", pads)
            idx = torch.where(idx < 0, -idx, idx)
            idx = torch.where(idx >= size, 2 * (size - 1) - idx, idx)
        x = torch.index_select(x, i, idx)
    return x


@op("Resize")
def _resize(ins, a):
    x = ins[0]  # (B, C, T)
    if x.dim() != 3:
        raise _unsupported(f"Resize input rank {x.dim()}", a)
    t_in = x.shape[2]
    if ins.given(2) and ins[2].numel():
        t_out = int(np.floor(t_in * float(ins.host(2)[2])))
    else:
        t_out = int(ins.host(3)[2])
    mode = a.get("mode", "nearest")
    ct = a.get("coordinate_transformation_mode", "half_pixel")
    dev = x.device
    if mode == "nearest":
        if ct != "asymmetric" or a.get("nearest_mode",
                                       "round_prefer_floor") != "floor":
            raise _unsupported("Resize nearest mode", a)
        src = torch.floor(torch.arange(t_out, dtype=torch.float64,
                                       device=dev) * (t_in / t_out)).long()
        return x[:, :, src.clamp(0, t_in - 1)]
    if mode != "linear" or ct != "pytorch_half_pixel":
        raise _unsupported("Resize mode", a)
    # source coordinates in float64: at ~5e5 output samples f32 loses
    # ~1e-2 of a sample
    if t_out > 1:
        coords = ((torch.arange(t_out, dtype=torch.float64, device=dev)
                   + 0.5) * (t_in / t_out) - 0.5)
    else:
        coords = torch.zeros(1, dtype=torch.float64, device=dev)
    lo = torch.floor(coords).long()
    frac = (coords - lo).float()
    lo_c = lo.clamp(0, t_in - 1)
    hi_c = (lo + 1).clamp(0, t_in - 1)
    return (x[:, :, lo_c] * (1 - frac) + x[:, :, hi_c] * frac).to(x.dtype)


@op("LSTM")
def _lstm(ins, a):
    # X (T, B, In), W (D, 4H, In), R (D, 4H, H), B (D, 8H); gate order iofc
    for k in a:
        if k not in ("hidden_size", "direction"):
            raise _unsupported("LSTM attribute", {k: a[k]})
    if any(ins.given(i) for i in (4, 5, 6)):
        raise _unsupported("LSTM sequence_lens / initial state inputs",
                           len(ins))
    x, w, r = ins[0].float(), ins[1].float(), ins[2].float()
    hidden = a["hidden_size"]
    if a.get("direction", "forward") not in ("forward", "bidirectional"):
        raise _unsupported("LSTM direction", a)
    dirs = w.shape[0]
    bias = (ins[3].float() if ins.given(3) else
            torch.zeros(dirs, 8 * hidden, device=x.device))
    t, bsz, _ = x.shape
    # one sequence per direction, the reverse one read back to front; the
    # input projections of every step in one product, then the scan
    flip = [False, True][:dirs]
    seqs = torch.stack([x.flip(0) if f else x for f in flip])  # (D,T,B,In)
    xw = torch.matmul(seqs, w.transpose(1, 2)[:, None])  # (D, T, B, 4H)
    wb = (bias[:, :4 * hidden] + bias[:, 4 * hidden:])[:, None]  # (D,1,4H)
    rt = r.transpose(1, 2)
    h = torch.zeros(dirs, bsz, hidden, device=x.device)
    c = torch.zeros_like(h)
    ys = []
    for step in range(t):
        g = xw[:, step] + torch.bmm(h, rt) + wb
        i = torch.sigmoid(g[..., :hidden])
        o = torch.sigmoid(g[..., hidden:2 * hidden])
        f = torch.sigmoid(g[..., 2 * hidden:3 * hidden])
        c = f * c + i * torch.tanh(g[..., 3 * hidden:])
        h = o * torch.tanh(c)
        ys.append(h)
    y = torch.stack(ys)  # (T, D, B, H), each direction in its own order
    y = torch.stack([y[:, d].flip(0) if f else y[:, d]
                     for d, f in enumerate(flip)], dim=1)
    return [y, h, c]
