"""XOR parity encoder: the ReCoding unit's datapath."""
