"""The plain reference: LightGBM's algorithm in NumPy and PyTorch,
written from its description.  It imports nothing of the program under
test."""
