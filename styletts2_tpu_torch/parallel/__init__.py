"""Multi-GPU: the process-group mesh (mesh.py) and the frame-sharded
vocoder decode (seqpar.py)."""

from styletts2_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, broadcast_module, init_distributed, make_mesh, mean_metrics,
    pad_to_widest, shard_batch)
