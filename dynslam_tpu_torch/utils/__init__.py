"""SE(3) helpers on tensors."""
