"""The port's CUDA C++ kernels for sm_90a (the fused row cycle, the
multi-step RC ladder, the strap-gated decode attention and the Pareto
dominance test), their plain PyTorch versions, the shared nvcc build and
the backend dispatch."""
