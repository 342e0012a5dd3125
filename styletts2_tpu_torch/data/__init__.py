"""Training data: the port's own copy of styletts2_tpu/data (JAX-free:
`path|transcript` lists, the duration-binned sampler and the loader with
static per-bin shapes)."""

from styletts2_tpu_torch.data.dataset import FilePathDataset  # noqa: F401
from styletts2_tpu_torch.data.sampler import DurationBinSampler  # noqa: F401
from styletts2_tpu_torch.data.loader import build_dataloader  # noqa: F401
