"""Device operations on torch tensors."""
