"""The port's CUDA C++ kernels for sm_90a (the fused row cycle, the
multi-step RC ladder and the strap-gated decode attention), their plain
PyTorch versions, the shared nvcc build and the backend dispatch."""
