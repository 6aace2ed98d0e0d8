"""The row-cycle kernel (CUDA C++ for sm_90a), its plain PyTorch version
and the backend dispatch."""
