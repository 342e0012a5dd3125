"""Tiny ONNX graph builder over onnx/proto.py (the port's copy of
styletts2_tpu/onnx/builder.py).

Collects nodes + initializers + graph I/O and serializes a ModelProto.
Names are auto-generated (`op_type_N`) unless given; constants are
deduplicated by (dtype, shape, bytes) so shared index vectors are stored
once.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from styletts2_tpu_torch.onnx import proto as P

DimT = Union[int, str]


class GraphBuilder:
    def __init__(self, name: str = "styletts2"):
        self.name = name
        self._nodes: List[bytes] = []
        self._inits: List[bytes] = []
        self._inputs: List[bytes] = []
        self._outputs: List[bytes] = []
        self._counter: Dict[str, int] = {}
        self._const_cache: Dict[Any, str] = {}
        self._init_names: set = set()

    # -- naming ------------------------------------------------------------

    def fresh(self, hint: str) -> str:
        i = self._counter.get(hint, 0)
        self._counter[hint] = i + 1
        return f"{hint}_{i}"

    # -- graph I/O ---------------------------------------------------------

    def add_input(self, name: str, elem_type: int, dims: Sequence[DimT]):
        self._inputs.append(P.value_info(name, elem_type, dims))

    def add_output(self, name: str, elem_type: int, dims: Sequence[DimT]):
        self._outputs.append(P.value_info(name, elem_type, dims))

    # -- initializers / constants -----------------------------------------

    def init(self, name: str, arr: np.ndarray) -> str:
        arr = np.asarray(arr)
        if name in self._init_names:
            raise ValueError(f"duplicate initializer {name}")
        self._init_names.add(name)
        self._inits.append(P.tensor(name, arr))
        return name

    def const(self, arr, name_hint: str = "const") -> str:
        """Deduplicated constant initializer."""
        arr = np.asarray(arr)
        key = (arr.dtype.str, arr.shape, arr.tobytes())
        if key in self._const_cache:
            return self._const_cache[key]
        name = self.fresh(name_hint)
        self.init(name, arr)
        self._const_cache[key] = name
        return name

    def i64(self, values, name_hint: str = "i64") -> str:
        return self.const(np.asarray(values, np.int64), name_hint)

    def f32(self, values, name_hint: str = "f32") -> str:
        return self.const(np.asarray(values, np.float32), name_hint)

    # -- nodes -------------------------------------------------------------

    def add(self, op_type: str, inputs: Sequence[str],
            n_outputs: int = 1, outputs: Optional[Sequence[str]] = None,
            **attrs) -> Union[str, List[str]]:
        """Append a node; returns its output name(s)."""
        if outputs is None:
            base = self.fresh(op_type.lower())
            outputs = ([base] if n_outputs == 1
                       else [f"{base}__{k}" for k in range(n_outputs)])
        self._nodes.append(P.node(op_type, list(inputs), list(outputs),
                                  name=self.fresh(op_type),
                                  attrs=attrs or None))
        return outputs[0] if len(outputs) == 1 else list(outputs)

    # -- convenience wrappers used all over the exporter -------------------

    def reshape(self, x: str, shape) -> str:
        if isinstance(shape, str):
            return self.add("Reshape", [x, shape])
        return self.add("Reshape", [x, self.i64(shape, "shape")])

    def transpose(self, x: str, perm) -> str:
        return self.add("Transpose", [x], perm=list(perm))

    def unsqueeze(self, x: str, axes) -> str:
        return self.add("Unsqueeze", [x, self.i64(axes, "axes")])

    def squeeze(self, x: str, axes) -> str:
        return self.add("Squeeze", [x, self.i64(axes, "axes")])

    def concat(self, xs: Sequence[str], axis: int) -> str:
        return self.add("Concat", list(xs), axis=axis)

    def slice(self, x: str, starts, ends, axes, steps=None) -> str:
        ins = [x, self.i64(starts, "starts"), self.i64(ends, "ends"),
               self.i64(axes, "axes")]
        if steps is not None:
            ins.append(self.i64(steps, "steps"))
        return self.add("Slice", ins)

    def binop(self, op: str, a: str, b: str) -> str:
        return self.add(op, [a, b])

    def mul_const(self, x: str, c: float) -> str:
        return self.add("Mul", [x, self.f32(np.float32(c), "scalar")])

    def add_const(self, x: str, c: float) -> str:
        return self.add("Add", [x, self.f32(np.float32(c), "scalar")])

    def cast(self, x: str, to: int) -> str:
        return self.add("Cast", [x], to=to)

    # -- serialize ---------------------------------------------------------

    def build(self, opset: int = 19) -> bytes:
        g = P.graph(self.name, self._nodes, self._inits, self._inputs,
                    self._outputs)
        return P.model(g, opset=opset)
