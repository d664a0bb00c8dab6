"""OCF core on PyTorch: hashing, state, data plane and control plane."""
