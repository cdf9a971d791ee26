"""Hand-written Hopper kernels (``csrc/``) with their wrappers and plain
torch versions. Kernels build on first launch, never at import."""
