"""ONNX interchange for the port, written from scratch (no `onnx` or
`onnxruntime` dependency): the port's copy of styletts2_tpu/onnx.

The reference ships an ONNX export path (ONNX/export_onnx.py:52-63, via
torch.onnx.export) so trained voices run anywhere onnxruntime does; this
package gives the port the same file from its own modules:

* `proto`   — hand-encoded ONNX protobuf wire format (ModelProto et al.)
* `builder` — a tiny graph builder (nodes, initializers, dynamic dims)
* `export`  — the full synthesis graph (tokens, style, speed) -> wav:
  `export_onnx(tree, cfg)` from a numpy inference tree (the same bytes as
  the JAX package's exporter), `export_modules(modules, cfg)` from the
  port's nn.Modules (reference ONNX/inference_onnx.py:225-261)
* `runtime` — `OnnxModel(data, device)`, a torch evaluator for the op
  subset `export` emits on an explicit device: for checks (the graph
  against the port's modules, on the GPU and the CPU) and for hosts
  without onnxruntime. The serving path stays the engine
  (infer.StyleTTS2).
"""

from styletts2_tpu_torch.onnx.export import export_modules, export_onnx  # noqa: F401
