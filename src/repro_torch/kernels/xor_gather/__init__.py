"""Coded row gather: one memory cycle's read datapath."""
