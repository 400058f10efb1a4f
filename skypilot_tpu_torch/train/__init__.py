"""Single-device training over the PyTorch model (flash-attention kernels
on the card)."""
