"""Hand-written Hopper kernels, their plain PyTorch versions and the
dispatch wrappers (``ops``) that pick one by the device of the tensors."""
