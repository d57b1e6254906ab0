"""PyTorch/CUDA port of the PetFMM reproduction (``repro`` is the reference)."""
