"""Dense decoder models on torch tensors (parameter trees are dicts)."""
