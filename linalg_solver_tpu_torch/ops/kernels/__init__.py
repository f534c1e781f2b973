"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (counterpart of ``linalg_solver_tpu.ops.pallas``)."""
