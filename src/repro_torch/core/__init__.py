"""The coded memory system (paper §III–IV) in PyTorch: code tables, state,
pattern builders, the ReCoding and dynamic coding units, one cycle."""
