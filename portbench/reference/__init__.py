"""Plain PyTorch reference of the served decoders (no kernels, no cache,
no batching), independent of the program under test."""
