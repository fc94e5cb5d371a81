"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version; built from the sources here at first use (:mod:`.build`)."""
