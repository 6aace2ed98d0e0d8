"""The port's CUDA C++ kernels for sm_90a (the fused row cycle and the
multi-step RC ladder), their plain PyTorch versions, the shared nvcc build
and the backend dispatch."""
