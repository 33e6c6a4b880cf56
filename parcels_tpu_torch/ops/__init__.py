"""Hand-written CUDA kernels of the port and the torch code around them."""
