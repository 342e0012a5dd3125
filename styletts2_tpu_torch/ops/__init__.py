"""DSP ops, the CUDA kernels B1/B2 and their plain versions, the nvcc build."""
